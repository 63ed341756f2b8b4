"""Voxel-driven FDK backprojection — Pallas kernel for NVIDIA GPUs (Triton).

Same math and the same ``(dz, ny, nx)`` accumulator layout as
``backprojection_xla`` (reference: src/openmp/backprojection.cpp:96-152,
src/cuda/backprojection.cu:65-130); see that module for the formulas.

Design (one program per voxel tile, no atomics, deterministic):

  * the volume block is viewed as ``(dz, ny*nx)``; a program owns a
    ``(TZ, TXY)`` tile — TZ slices by TXY consecutive voxels of the
    flattened xy plane (one x run, so accumulator loads/stores and the
    detector gathers of neighbouring threads are contiguous);
  * the tile is loaded once, kept in registers while the program loops
    over the chunk's C projections, and stored once: 8/C bytes of
    accumulator traffic per voxel update instead of the XLA op's 8;
  * per projection, everything that depends on (x, y) only —
    ``s, t, factor, h, w = u^2/2`` — is computed once per xy column of
    the tile and reused by its TZ slices; along z the detector row is
    the column walk ``v = z*factor/l_px_col - (v_min/l_px_col + 1/2)``;
  * the four bilinear corners are masked gathers from the flat filtered
    chunk; the border-zero rule of the reference is the load mask
    (out-of-detector corners read 0), so invalid samples add exactly 0;
  * ragged edges (any dz, ny*nx) are load/store masks: the tile is a
    power of two in each dimension, the volume is never padded.

All arithmetic is f32; there is no matrix product.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .backprojection_xla import BpGrid

__all__ = ["backproject_chunk_gpu"]

# (TZ, TXY) voxel tile of one program and its warps: 8 x 128 = 1024
# voxels over 4 warps keeps 8 accumulators per thread (the fastest of
# the tile shapes timed on an H100 at a (256, 1024, 1024) block).
TZ, TXY = 8, 128
NUM_WARPS = 4


def _bp_kernel(offs_ref, sin_ref, cos_ref, proj_ref, vol_in_ref, vol_ref, *,
               grid: BpGrid, dz: int, ny: int, nx: int, n_proj: int):
    del vol_in_ref          # aliased with vol_ref
    det, vol = grid.det, grid.vol
    n_col, n_row = det.n_col, det.n_row
    nxy = ny * nx
    xy0 = pl.program_id(0) * TXY
    z0 = pl.program_id(1) * TZ

    rx1 = offs_ref[0]
    ry1 = offs_ref[1]
    zg = offs_ref[2]        # global z of the block's first slice

    xy = xy0 + jnp.arange(TXY, dtype=jnp.int32)            # (TXY,)
    xi = xy % nx
    yi = xy // nx
    zi = z0 + jnp.arange(TZ, dtype=jnp.int32)              # (TZ,)
    mask = (zi[:, None] < dz) & (xy[None, :] < nxy)        # (TZ, TXY)

    def centered(idx, dim_full, size):
        return -(dim_full * size) / 2.0 + size / 2.0 + idx * size

    xs = centered((xi + rx1).astype(jnp.float32), vol.dim_x, vol.l_vx_x)
    ys = centered((yi + ry1).astype(jnp.float32), vol.dim_y, vol.l_vx_y)
    zs = centered((zi + zg).astype(jnp.float32), vol.dim_z, vol.l_vx_z)

    tile = vol_ref.at[pl.ds(z0, TZ), pl.ds(xy0, TXY)]
    acc = plgpu.load(tile, mask=mask, other=0.0)

    v_off = grid.v_min / det.l_px_col + 0.5
    plane = n_col * n_row

    def body(c, acc):
        sn = sin_ref[c]
        cs = cos_ref[c]
        s = xs * cs + ys * sn
        t = -xs * sn + ys * cs
        inv = 1.0 / (s + grid.d_so)
        factor = grid.d_sd * inv
        h = (t * factor - grid.h_min) / det.l_px_row - 0.5
        u = grid.d_so * inv
        w = 0.5 * (u * u)
        a = factor / det.l_px_col
        h1 = jnp.floor(h)
        fh = h - h1
        ok_h = (h1 >= 0.0) & (h1 + 1.0 < n_row)
        h1i = jnp.clip(h1.astype(jnp.int32), 0, n_row - 2)
        base = c * plane + h1i                             # (TXY,)

        v = zs[:, None] * a[None, :] - v_off               # (TZ, TXY)
        v1 = jnp.floor(v)
        fv = v - v1
        ok = ok_h[None, :] & (v1 >= 0.0) & (v1 + 1.0 < n_col)
        v1i = jnp.clip(v1.astype(jnp.int32), 0, n_col - 2)
        idx = base[None, :] + v1i * n_row
        q11 = plgpu.load(proj_ref.at[idx], mask=ok, other=0.0)
        q21 = plgpu.load(proj_ref.at[idx + 1], mask=ok, other=0.0)
        q12 = plgpu.load(proj_ref.at[idx + n_row], mask=ok, other=0.0)
        q22 = plgpu.load(proj_ref.at[idx + (n_row + 1)], mask=ok, other=0.0)
        fh2 = fh[None, :]
        top = q11 * (1.0 - fh2) + q21 * fh2
        bot = q12 * (1.0 - fh2) + q22 * fh2
        return acc + w[None, :] * (top * (1.0 - fv) + bot * fv)

    acc = jax.lax.fori_loop(0, n_proj, body, acc)
    plgpu.store(tile, acc, mask=mask)


def backproject_chunk_gpu(
    volume: jnp.ndarray,           # (dz, ny, nx) f32 — z-block accumulator
    projections: jnp.ndarray,      # (C, n_col, n_row) f32, filtered
    sin_phi: jnp.ndarray,          # (C,) f32
    cos_phi: jnp.ndarray,          # (C,) f32
    grid: BpGrid,
    offs: jnp.ndarray,             # (>=3,) int32: roi x1, roi y1, global z0
    *,
    interpret: bool = False,
) -> jnp.ndarray:
    """Accumulate a chunk of projections into a volume z-block.

    Contract of ``backproject_chunk_xla`` with the offsets as one
    runtime int32 vector ``offs = [x1, y1, z_offset + z1, ...]`` (extra
    entries are ignored).  ``interpret=True`` runs the kernel on any backend
    (CPU tests); otherwise a GPU is required.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "backproject_chunk_gpu needs a GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to emulate")
    dz, ny, nx = volume.shape
    C = projections.shape[0]
    det = grid.det
    if projections.shape[1:] != (det.n_col, det.n_row):
        raise ValueError(f"projections {projections.shape[1:]} do not match "
                         f"the detector ({det.n_col}, {det.n_row})")
    kernel = functools.partial(_bp_kernel, grid=grid, dz=dz, ny=ny, nx=nx,
                               n_proj=C)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((dz, ny * nx), jnp.float32),
        grid=(pl.cdiv(ny * nx, TXY), pl.cdiv(dz, TZ)),
        input_output_aliases={4: 0},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="paris_backproject",
    )(offs.astype(jnp.int32), sin_phi.astype(jnp.float32),
      cos_phi.astype(jnp.float32),
      projections.astype(jnp.float32).reshape(-1),
      volume.reshape(dz, ny * nx))
    return out.reshape(dz, ny, nx)
