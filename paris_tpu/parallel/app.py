"""Distributed reconstruction driver: z-blocks over a device mesh.

Multi-device/multi-host analog of ``app.run_job`` (reference:
src/main.cpp:137-169 device fan-out).  Each z-block is reconstructed
with the volume sharded over the mesh; on multi-host runs every host
feeds the same projection stream (each host reads its local copy or a
shared filesystem) and writes ONLY the shards it owns, at their global
offsets (``DistributedReconstructor.write_shards``) — no process ever
materializes a full block.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import jax

from ..app import (
    ReconstructionJob, _auto_hbm_budget, _fits_two_blocks,
    _overlap_block_dz, _overlap_free_est, _roi_offset,
)
from ..geometry import apply_roi, derive_volume_geometry, plan_z_blocks
from ..io.sink import VolumeSink
from ..io.source import ProjectionSource
from ..pipeline import resolve_backend
from ..utils.logging import StageTimers, StreamTimer, fmt_duration
from ..utils.profiling import ThroughputMeter, trace
from .dist import DistributedReconstructor
from .mesh import make_z_mesh
from . import multihost

logger = logging.getLogger("paris_tpu.parallel.app")

__all__ = ["run_job_distributed"]


def _owned_slots(mesh, chunk_size: int) -> set:
    """Chunk-slot indices whose projection-shard lands on THIS process.

    The chunk is sharded blockwise over the mesh axis: mesh position k
    owns slots [k*C/n, (k+1)*C/n).  A process only ever uploads the
    slots of its own devices (``dist._put`` pulls addressable shards
    only), so those are the only frames it needs to decode.
    """
    n = mesh.devices.size
    local = chunk_size // n
    pidx = jax.process_index()
    owned = set()
    for k, dev in enumerate(mesh.devices.flat):
        if dev.process_index == pidx:
            owned.update(range(k * local, (k + 1) * local))
    return owned


def _assemble_chunk(plist, det) -> np.ndarray:
    """Projection list -> (C, n_col, n_row) array; undecoded (None)
    frames of other hosts' shards become zero rows (never uploaded)."""
    if all(p.data is not None for p in plist):
        return np.stack([p.data for p in plist])
    out = np.zeros((len(plist), det.n_col, det.n_row), np.float32)
    for i, p in enumerate(plist):
        if p.data is not None:
            out[i] = p.data
    return out


def run_job_distributed(job: ReconstructionJob, mesh=None) -> str:
    t_start = time.perf_counter()
    timers = StageTimers()
    mesh = mesh if mesh is not None else make_z_mesh()
    n_dev = mesh.devices.size

    full_geo = derive_volume_geometry(job.det)
    vol_geo = apply_roi(full_geo, job.roi) if job.roi else full_geo
    logger.info("volume [vx]: %d x %d x %d over %d device(s)",
                vol_geo.dim_x, vol_geo.dim_y, vol_geo.dim_z, n_dev)

    chunk = max(job.chunk_size, n_dev)
    chunk -= chunk % n_dev
    backend = resolve_backend(job.backend)

    proj_bytes = 4 * job.det.n_row * job.det.n_col
    proj_buffer = 4 * proj_bytes * chunk
    hbm_budget = job.hbm_budget_bytes
    if hbm_budget is None:
        hbm_budget = _auto_hbm_budget()
        # per-process live probes can disagree across hosts; the block
        # plan must be IDENTICAL everywhere (shard offsets, barrier
        # schedule), so agree on the most conservative probe first
        (hbm_budget,) = multihost.agree_min(hbm_budget)
        if hbm_budget is not None:
            # the block is sharded: each device holds only 1/n of it,
            # so the per-device budget scales to the whole mesh
            hbm_budget *= n_dev
            logger.info("auto HBM budget: %.1f GB across %d device(s)",
                        hbm_budget / 2**30, n_dev)
    align = 8 * n_dev
    info = plan_z_blocks(
        vol_geo,
        hbm_budget_bytes=hbm_budget,
        proj_buffer_bytes=proj_buffer,
        num_shards=n_dev,
        z_align=8,
        block_dz=job.block_dz,
    )
    logger.info("z-split: %d block(s) of %d slices (padded)",
                info.num, info.dim_z_padded)

    # overlap-capable split, shared with the single-chip driver: cap
    # the extent so TWO padded per-device accumulator shards fit, so a
    # writer thread can drain block k while k+1 reconstructs
    import os as _os
    overlap_enabled = _os.environ.get("PARIS_WRITE_OVERLAP", "1") != "0"
    per_dev_budget = None if hbm_budget is None else hbm_budget // n_dev
    free_est = _overlap_free_est(per_dev_budget,
                                 budget_is_auto=job.hbm_budget_bytes is None)
    # live-stats probe: agree across processes (identical plan + overlap
    # flag everywhere — a divergent overlap bool reorders the barrier
    # relative to the next block's steps)
    (free_est,) = multihost.agree_min(free_est)
    # per-DEVICE projection residency for the overlap fit: staged wire
    # buffers are chunk-sharded (1/n each) but each step materializes
    # the gathered full chunk + its filtered temp on every device
    per_dev_proj = proj_buffer // n_dev + 2 * proj_bytes * chunk
    if overlap_enabled and free_est is not None and info.num > 1 \
            and job.block_dz is None:
        dz2 = _overlap_block_dz(vol_geo, free_est, per_dev_proj,
                                info.dim_z_padded, n_shards=n_dev,
                                align=align, backend=backend)
        if dz2 is not None:
            info = plan_z_blocks(
                vol_geo, hbm_budget_bytes=hbm_budget,
                proj_buffer_bytes=proj_buffer, num_shards=n_dev,
                z_align=8, block_dz=dz2)
            logger.info(
                "z-split adjusted for write overlap: %d block(s) "
                "of %d slices (padded)", info.num, info.dim_z_padded)

    # multi-host: process 0 creates the shared ddbvf, the rest attach
    # after a barrier (a concurrent create would truncate mid-write)
    if jax.process_index() == 0:
        sink = VolumeSink(job.output_path, job.prefix, vol_geo.dim_x,
                          vol_geo.dim_y, vol_geo.dim_z, resume=job.resume)
        multihost.barrier("paris-sink-created")
    else:
        multihost.barrier("paris-sink-created")
        sink = VolumeSink.attach(job.output_path, job.prefix, vol_geo.dim_x,
                                 vol_geo.dim_y, vol_geo.dim_z)

    rec = DistributedReconstructor(
        job.det, full_geo, mesh=mesh, chunk_size=chunk,
        block_dz=info.dim_z_padded, backend=backend,
    )
    logger.info("backend: %s, chunk size %d", rec.backend, chunk)

    rx1, ry1, rz1 = _roi_offset(job)
    # host-side projection cache: read the HIS directory ONCE for N
    # blocks (the single-chip driver's fix for the reference's
    # re-scan-dir-per-task flaw, SURVEY.md §3.2; app.py does the same)
    cache = job.cache_projections
    cached: Optional[Tuple[np.ndarray, np.ndarray]] = None
    n_done = 0
    # multi-host: decode ONLY this host's chunk-shard frames — input
    # decode bandwidth then scales with host count (SURVEY §7
    # multi-host streaming; ref decoded everything per worker,
    # src/source.cpp:88-130)
    slot_filter = None
    if multihost.is_multihost():
        owned = _owned_slots(mesh, chunk)
        logger.info("disjoint input: this process decodes %d/%d chunk "
                    "slots", len(owned), chunk)
        slot_filter = lambda pos: (pos % chunk) in owned  # noqa: E731

    # Finalize/write overlap, shared semantics with app.run_job: a
    # writer thread drains block k's d2h + ddbvf writes WHILE block k+1
    # reconstructs.  The writer does ONLY local work (shard d2h +
    # pwrite); the cross-process barrier and the manifest mark stay on
    # the MAIN thread at a fixed program point, because
    # multihost.barrier is a device collective — collectives issued
    # from two threads could be enqueued in different orders on
    # different processes (deadlock).  Main-thread order is
    # deterministic: steps(k), steps(k+1), barrier(k), steps(k+2), ...
    import concurrent.futures as _cf
    overlap = overlap_enabled and _fits_two_blocks(
        vol_geo, info.dim_z_padded, per_dev_proj, free_est, n_dev,
        backend=backend)
    if overlap and info.num > 1:
        logger.info("write overlap: block k+1 reconstructs while "
                    "block k drains to disk")
    writer = _cf.ThreadPoolExecutor(1, thread_name_prefix="paris-write")
    pending = None          # (future, block) of the draining block

    def _drain_pending():
        """Wait for the draining block's write, then its main-thread
        completion (barrier + manifest mark) — the single wait path."""
        nonlocal pending
        if pending is None:
            return
        fut, pblk = pending
        pending = None
        fut.result()
        _complete(pblk)

    def _drain(vol_state, blk):
        with timers.time("finalize+write"):
            if multihost.is_multihost():
                # local shards only — no collectives on this thread
                rec.write_shards(vol_state, sink.path, blk.z0, blk.dim_z)
            else:
                out = rec.finalize(vol_state)[: blk.dim_z]
                sink.write_block(blk.index, out, blk.z0)

    def _complete(blk):
        """Main-thread completion: all processes synced, block marked."""
        if multihost.is_multihost():
            multihost.barrier(f"paris-block-{blk.index}")
            if jax.process_index() == 0:
                sink.mark_done(blk.index)

    with multihost.crash_diagnostics("reconstruct", job.output_path):
      try:
        for block in info.blocks:
            if sink.is_done(block.index):
                logger.info("block %d already complete, skipping",
                            block.index)
                continue
            logger.info("reconstructing block %d/%d (z %d..%d)",
                        block.index + 1, info.num, block.z0,
                        block.z0 + block.dim_z - 1)
            volume = rec.init_block()
            n_proj = 0
            meter = ThroughputMeter(
                block.dim_z * vol_geo.dim_y * vol_geo.dim_x)
            with timers.time("reconstruct"), trace(job.trace_dir):
                if cached is not None:
                    data, angs = cached
                    volume = rec.accumulate(
                        volume, data, angs,
                        z_offset=block.z0, roi_offset=(rx1, ry1, rz1))
                    n_proj = len(angs)
                    jax.block_until_ready(volume)
                    meter.add(n_proj)
                else:
                    # explicit True always collects (dataclass contract)
                    state = {"collect": cache is True
                             or (cache is None and info.num > 1)}
                    datas, angles = [], []
                    src = ProjectionSource(
                        job.input_path, angle_file=job.angle_path,
                        delta_phi=job.det.delta_phi, quality=job.quality,
                        slot_filter=slot_filter,
                    )

                    def pairs():
                        for plist in src.iter_chunks(chunk):
                            data = _assemble_chunk(plist, job.det)
                            angs = np.asarray(
                                [p.phi for p in plist], np.float32)
                            if state["collect"]:
                                datas.append(data)
                                angles.append(angs)
                                if sum(d.nbytes for d in datas) > \
                                        job.max_cache_bytes:
                                    state["collect"] = False
                                    datas.clear()
                                    angles.clear()
                            yield data, angs

                    # staging (padding + each host's h2d) runs on
                    # worker threads, overlapping the devices'
                    # execution of earlier steps (pipeline.stage_stream)
                    from ..pipeline import stage_stream
                    stream = StreamTimer(first=n_done == 0)
                    for staged, k in stage_stream(rec.stage_chunk,
                                                  pairs()):
                        stream.staged()
                        volume = rec.step_staged(
                            volume, staged, z_offset=block.z0,
                            roi_offset=(rx1, ry1, rz1))
                        stream.stepped(volume, logger)
                        n_proj += k
                        meter.add(k)
                    jax.block_until_ready(volume)
                    stream.report(logger, block.index)
                    if state["collect"] and datas:
                        cached = (np.concatenate(datas),
                                  np.concatenate(angles))
                # close the stage only when the devices actually
                # finished (async dispatch returns early) — keeps the
                # reconstruct / finalize+write split honest
                jax.block_until_ready(volume)
            pps, gups = meter.rates()
            # bound in-flight accumulators at 2 (this block's + the
            # draining one); surfaces writer errors; then the
            # main-thread barrier/mark for the drained block
            _drain_pending()
            pending = (writer.submit(_drain, volume, block), block)
            # drop the loop's reference NOW: without overlap the wait
            # below frees the accumulator before the next init_block
            volume = None
            if not overlap:
                _drain_pending()
            n_done += 1
            logger.info("block %d done (%d projections, %.1f proj/s, "
                        "%.1f Gupd/s)", block.index, n_proj, pps, gups)
            if job.max_blocks is not None and n_done >= job.max_blocks:
                logger.info("stopping after %d block(s) (max_blocks); "
                            "resume=True completes the remaining blocks",
                            n_done)
                break
        _drain_pending()
      finally:
        # deliberate error path shared with app.run_job (_finish_writer)
        from ..app import _finish_writer
        _finish_writer(writer, None if pending is None else pending[0],
                       logger)

    timers.report(logger)
    logger.info("distributed reconstruction finished in %s -> %s",
                fmt_duration(time.perf_counter() - t_start), sink.path)
    return sink.path
