"""Voxel-driven FDK backprojection — pure-XLA implementation.

This is the portable implementation of the backprojection contract (the
Pallas/Triton kernel in ``backprojection_gpu.py`` is the GPU fast path;
this one runs anywhere JAX runs and serves as the in-graph reference and
the CPU path).

Math (reference: src/openmp/backprojection.cpp:96-152 and
src/cuda/backprojection.cu:65-130 — the CUDA +0.5 texel shift is texture
plumbing, not math; the OpenMP loop and the doc/ derivations are the
golden convention):

  centered voxel coords    x_k = -dim*l/2 + l/2 + k*l        (similarly y,z)
  rotate by angle phi      s =  x*cos + y*sin
                           t = -x*sin + y*cos
  perspective              factor = d_sd / (s + d_so)
  detector coords [px]     h = (t*factor - h_min)/l_px_row - 1/2
                           v = (z*factor - v_min)/l_px_col - 1/2
       with h_min = -(n_row*l_px_row/2) - delta_s_mm   (proj_real_coordinate)
  sample                   det = bilinear(P, v, h), zero outside detector
  accumulate               vol += 1/2 * det * u^2,  u = d_so/(s + d_so)

A chunk of C filtered projections is backprojected inside one
``lax.fori_loop`` whose carry is the whole z-slab, so the slab goes
through device memory once per PROJECTION (8 B of accumulator traffic
per voxel update), and s, t, h and u^2 are recomputed for every voxel.
The GPU kernel keeps a voxel tile in registers across the chunk instead.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry import DetectorGeometry, VolumeGeometry

__all__ = ["backproject_chunk_xla", "BpGrid", "make_bp_grid"]


class BpGrid:
    """Static per-run constants for backprojection, all Python floats."""

    def __init__(self, det: DetectorGeometry, vol: VolumeGeometry):
        self.det = det
        self.vol = vol
        self.d_so = float(det.d_so)
        self.d_sd = float(det.d_sd)
        # proj_real_coordinate offsets (reference backprojection.cpp:49-50:
        # delta_s converted px -> mm before entering the kernel)
        self.delta_s_mm = float(det.delta_s * det.l_px_row)
        self.delta_t_mm = float(det.delta_t * det.l_px_col)
        self.h_min = -(det.n_row * det.l_px_row) / 2.0 - self.delta_s_mm
        self.v_min = -(det.n_col * det.l_px_col) / 2.0 - self.delta_t_mm


def make_bp_grid(det: DetectorGeometry, vol: VolumeGeometry) -> BpGrid:
    return BpGrid(det, vol)


def _centered(idx: jnp.ndarray, dim_full: int, size: float) -> jnp.ndarray:
    """vol_centered_coordinate (reference cuda/backprojection.cu:48-54)."""
    return -(dim_full * size) / 2.0 + size / 2.0 + idx * size


def _bilinear_border0(p: jnp.ndarray, v: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of p[(v, h)] returning 0 if ANY corner is outside.

    Matches the reference interpolate() (openmp/backprojection.cpp:52-84):
    the sample is zero unless x1>=0, x2<dim_x, y1>=0, y2<dim_y — i.e. a
    border-zero policy evaluated on the corner coordinates.
    """
    n_col, n_row = p.shape
    h1 = jnp.floor(h)
    v1 = jnp.floor(v)
    fh = h - h1
    fv = v - v1
    valid = (h1 >= 0.0) & (h1 + 1.0 < n_row) & (v1 >= 0.0) & (v1 + 1.0 < n_col)
    h1i = jnp.clip(h1.astype(jnp.int32), 0, n_row - 2)
    v1i = jnp.clip(v1.astype(jnp.int32), 0, n_col - 2)
    q11 = p[v1i, h1i]
    q21 = p[v1i, h1i + 1]
    q12 = p[v1i + 1, h1i]
    q22 = p[v1i + 1, h1i + 1]
    top = q11 * (1.0 - fh) + q21 * fh
    bot = q12 * (1.0 - fh) + q22 * fh
    return jnp.where(valid, top * (1.0 - fv) + bot * fv, 0.0)


def backproject_chunk_xla(
    volume: jnp.ndarray,           # (dz, ny, nx) f32 — z-block accumulator
    projections: jnp.ndarray,      # (C, n_col, n_row) f32, filtered
    sin_phi: jnp.ndarray,          # (C,) f32
    cos_phi: jnp.ndarray,          # (C,) f32
    grid: BpGrid,
    z_offset: int = 0,             # global z of this block's first slice
    roi_offset: Tuple[int, int, int] = (0, 0, 0),  # (x1, y1, z1) ROI origin
    max_temp_bytes: int = 256 << 20,
) -> jnp.ndarray:
    """Accumulate a chunk of projections into a volume z-block.

    ``z_offset`` is threaded explicitly per call (the reference cached it
    in thread_local statics, causing its stale-offset bug — SURVEY.md §5
    bug 2).

    The bilinear sample materializes a (slab, ny, nx) temp per angle;
    ``max_temp_bytes`` bounds it by processing the block in z-slabs
    (this is the CPU/GPU *product* path, not just an oracle — a 1024^3
    block would otherwise need a 4 GB temp alongside the accumulator).
    """
    det, vol = grid.det, grid.vol
    dz, ny, nx = volume.shape
    rx1, ry1, rz1 = roi_offset

    xs = _centered(jnp.arange(nx, dtype=jnp.float32) + rx1, vol.dim_x, vol.l_vx_x)
    ys = _centered(jnp.arange(ny, dtype=jnp.float32) + ry1, vol.dim_y, vol.l_vx_y)
    zs = _centered(
        jnp.arange(dz, dtype=jnp.float32) + (rz1 + z_offset), vol.dim_z, vol.l_vx_z
    )

    def run_slab(slab, zs_sub):
        def body(c, acc):
            sin_c, cos_c = sin_phi[c], cos_phi[c]
            p = projections[c]
            s = xs[None, :] * cos_c + ys[:, None] * sin_c      # (ny, nx)
            t = -xs[None, :] * sin_c + ys[:, None] * cos_c
            inv = 1.0 / (s + grid.d_so)
            factor = grid.d_sd * inv
            h = (t * factor - grid.h_min) / det.l_px_row - 0.5  # (ny, nx)
            u2 = (grid.d_so * inv) ** 2
            w = 0.5 * u2                                        # (ny, nx)
            v = (zs_sub[:, None, None] * factor[None]
                 - grid.v_min) / det.l_px_col - 0.5
            det_val = _bilinear_border0(p, v, jnp.broadcast_to(h, v.shape))
            return acc + w[None] * det_val

        return jax.lax.fori_loop(0, projections.shape[0], body, slab)

    zc = max(1, int(max_temp_bytes) // (4 * ny * nx))
    if dz <= zc:
        return run_slab(volume, zs)
    # slab results are written back in place (a concatenate would hold
    # a second full accumulator next to the donated one)
    for z0 in range(0, dz, zc):
        d = min(zc, dz - z0)
        volume = jax.lax.dynamic_update_slice_in_dim(
            volume,
            run_slab(jax.lax.slice_in_dim(volume, z0, z0 + d, axis=0),
                     zs[z0:z0 + d]),
            z0, axis=0)
    return volume
