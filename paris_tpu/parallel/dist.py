"""Distributed FDK: z-sharded volume, all-gathered projections.

Scheme (SURVEY.md §2/§5 distributed design):

  * the volume block is sharded over the 1-D mesh along z — each device
    owns a contiguous ``(dz/n, ny, nx)`` slab (the reference's per-GPU
    subvolume, src/cuda/subvolume_information.cpp, but static and
    deterministic), in the same layout as the single-device path;
  * each projection CHUNK is sharded over the mesh for the
    weight+filter stage (the FFTs parallelize over projections), then
    ``all_gather``-ed (NVLink on a multi-GPU host) so every device
    backprojects every projection into its own slab — compute is
    embarrassingly parallel, zero steady-state reductions;
  * per-shard z offsets are derived from ``axis_index`` inside
    ``shard_map`` (the reference lost its subvolume offset in a
    thread_local — SURVEY.md §5 bugs 1/2 — here it is pure dataflow).

Works identically on a virtual CPU mesh (tests), one device (mesh of
1), the GPUs of one host, or several hosts (``jax.distributed`` +
a mesh over all global devices).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import DetectorGeometry, VolumeGeometry
from ..ops.backprojection_xla import make_bp_grid
from ..ops.weighting import weight_map
from ..ops.filtering import ramp_filter_spectrum, filter_projections
from ..pipeline import (
    backprojector, host_chunk, resolve_backend, step_offsets,
)
from .mesh import Z_AXIS, make_z_mesh

__all__ = ["DistributedReconstructor"]


class DistributedReconstructor:
    """FDK over a device mesh: volume z-sharded, projections gathered.

    ``block_dz`` is the (padded) z extent processed at once;
    ``chunk_size`` is the number of projections per step.  Both must be
    divisible by the mesh size.
    """

    def __init__(
        self,
        det: DetectorGeometry,
        vol: VolumeGeometry,
        *,
        mesh: Optional[Mesh] = None,
        chunk_size: int = 16,
        block_dz: Optional[int] = None,
        backend: str = "auto",
        interpret: bool = False,
    ):
        self.det = det
        self.vol = vol
        self.mesh = mesh if mesh is not None else make_z_mesh()
        self.n_dev = self.mesh.devices.size
        self.chunk_size = int(chunk_size)
        if self.chunk_size % self.n_dev:
            raise ValueError(
                f"chunk_size {chunk_size} not divisible by mesh size {self.n_dev}"
            )
        dz = block_dz if block_dz is not None else vol.dim_z
        if dz % self.n_dev:
            raise ValueError(
                f"block_dz {dz} not divisible by mesh size {self.n_dev}")
        self.block_dz = dz
        self.local_dz = dz // self.n_dev
        self._state_shape = (dz, vol.dim_y, vol.dim_x)

        self.grid = make_bp_grid(det, vol)
        self.backend = resolve_backend(backend, interpret)
        bp = backprojector(self.backend, self.grid, interpret)
        weights = weight_map(det)
        spectrum = ramp_filter_spectrum(det.n_row, det.l_px_row)
        local_dz = self.local_dz

        def shard_step(volume, chunk, sin_phi, cos_phi, offs):
            # volume: (local_dz, ny, nx); chunk: (C/n, n_col, n_row)
            filtered = filter_projections(chunk * weights, spectrum,
                                          det.n_row)
            filtered = jax.lax.all_gather(filtered, Z_AXIS, tiled=True)
            sins = jax.lax.all_gather(sin_phi, Z_AXIS, tiled=True)
            coss = jax.lax.all_gather(cos_phi, Z_AXIS, tiled=True)
            my_z0 = jax.lax.axis_index(Z_AXIS) * local_dz
            shard_offs = jnp.stack([offs[0], offs[1], offs[2] + my_z0])
            return bp(volume, filtered, sins, coss, shard_offs)

        vol_spec = P(Z_AXIS, None, None)
        proj_spec = P(Z_AXIS, None, None)
        ang_spec = P(Z_AXIS)
        mapped = jax.shard_map(
            shard_step, mesh=self.mesh,
            in_specs=(vol_spec, proj_spec, ang_spec, ang_spec, P()),
            out_specs=vol_spec,
            # pallas_call out_shapes carry no varying-mesh-axes info
            check_vma=False,
        )
        self._step = jax.jit(mapped, donate_argnums=(0,))
        self._vol_sharding = NamedSharding(self.mesh, vol_spec)
        self._proj_sharding = NamedSharding(self.mesh, proj_spec)
        self._ang_sharding = NamedSharding(self.mesh, ang_spec)

    def init_block(self) -> jax.Array:
        # jit with out_shardings works on single- AND multi-process
        # meshes (device_put of a host array onto a global sharding
        # would fail multi-host: non-addressable devices)
        return jax.jit(
            functools.partial(jnp.zeros, self._state_shape, jnp.float32),
            out_shardings=self._vol_sharding)()

    def _put(self, data: np.ndarray, sharding) -> jax.Array:
        """Host array -> globally sharded device array (multi-host safe).

        Only this process's ADDRESSABLE shards of ``data`` are ever
        read — rows belonging to other hosts' devices may be
        zero-filled placeholders (the disjoint-decode input path,
        parallel/app.py) and never cross any wire.
        """
        if jax.process_count() > 1:
            return jax.make_array_from_callback(
                data.shape, sharding, lambda idx: data[idx])
        return jax.device_put(data, sharding)

    def stage_chunk(self, chunk, ang):
        """Start the async h2d of one (chunk, angles) pair onto the mesh;
        mirrors ``Reconstructor.stage_chunk`` (issued one chunk AHEAD of
        its step, so each host's h2d overlaps the devices' execution of
        the previous step — the reference overlapped upload and compute
        via its pipelined loader stage, src/loader.cpp:28-33)."""
        chunk, sin, cos = host_chunk(chunk, ang, self.chunk_size)
        return (self._put(chunk, self._proj_sharding),
                self._put(sin, self._ang_sharding),
                self._put(cos, self._ang_sharding))

    def step_staged(self, volume, staged, *, z_offset: int = 0,
                    roi_offset: Tuple[int, int, int] = (0, 0, 0)):
        """Accumulate one pre-staged chunk (see ``stage_chunk``)."""
        return self._step(volume, *staged,
                          step_offsets(z_offset, roi_offset))

    def accumulate(
        self,
        volume: jax.Array,
        projections,
        angles_deg,
        *,
        z_offset: int = 0,
        roi_offset: Tuple[int, int, int] = (0, 0, 0),
    ) -> jax.Array:
        """Stream projections through the sharded step, staged ahead on
        worker threads (``pipeline.stage_stream``)."""
        from ..pipeline import stage_stream
        C = self.chunk_size
        n = len(angles_deg)
        offs = step_offsets(z_offset, roi_offset)
        pairs = ((projections[i:i + C], angles_deg[i:i + C])
                 for i in range(0, n, C))
        for staged, _ in stage_stream(self.stage_chunk, pairs):
            volume = self._step(volume, *staged, offs)
        return volume

    def write_shards(self, volume: jax.Array, path: str, z_base: int,
                     dim_z_valid: int) -> int:
        """Write this process's addressable z-shards of a block into the
        ddbvf at their global offsets (multi-host output path)."""
        from . import multihost
        return multihost.write_local_shards(
            path, volume, z_base, max_z=z_base + dim_z_valid)

    def finalize(self, volume: jax.Array) -> np.ndarray:
        """Sharded block -> (block_dz, ny, nx) ndarray (single-process).

        On multi-host runs the global block is not addressable from one
        process — use ``write_shards`` instead.
        """
        if jax.process_count() > 1:
            raise RuntimeError(
                "finalize() materializes the global block and cannot run "
                "multi-host; use write_shards()")
        return np.asarray(volume)

    def reconstruct(self, projections, angles_deg, **kw) -> np.ndarray:
        out = self.accumulate(self.init_block(), projections, angles_deg, **kw)
        return self.finalize(out)[: self.vol.dim_z]
