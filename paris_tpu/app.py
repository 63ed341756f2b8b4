"""End-to-end reconstruction driver: blocks x projection stream -> ddbvf.

The orchestration layer the reference spread across main.cpp's task
queue, per-device worker threads and the sink (src/main.cpp:79-169) —
redesigned as a deterministic host loop:

  * z-blocks come from the deterministic HBM-budget planner
    (``plan_z_blocks``), padded to one uniform shape so every block
    reuses one compiled program (the reference recompiled nothing but
    paid a fresh memory probe per device, and its remainder block would
    have forced a recompile here);
  * per block: stream (or reuse cached) projections through the
    reconstructor, then write the block at its GLOBAL z offset (fixing
    reference bug 1) and record completion in the sink manifest —
    interrupted runs resume with ``resume=True``, recomputing only
    missing blocks;
  * projections are cached host-side when they fit in RAM (the
    reference re-read every HIS file once per subvolume per device,
    SURVEY.md §3.2 "re-scans dir per task").
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import jax

from .exceptions import (
    ParisError, StageConstructionError, StageRuntimeError,
)
from .geometry import (
    DetectorGeometry, RegionOfInterest, VolumeGeometry,
    SubvolumeInfo, apply_roi, derive_volume_geometry, plan_z_blocks,
)
from .io.sink import VolumeSink
from .io.source import ProjectionSource
from .pipeline import Reconstructor, resolve_backend
from .utils.logging import StageTimers, StreamTimer, fmt_duration
from .utils.profiling import ThroughputMeter, trace

logger = logging.getLogger("paris_tpu.app")

__all__ = ["ReconstructionJob", "run_job"]


@dataclasses.dataclass
class ReconstructionJob:
    det: DetectorGeometry
    input_path: str
    output_path: str
    prefix: str = "vol"
    angle_path: Optional[str] = None
    quality: int = 1
    roi: Optional[RegionOfInterest] = None
    chunk_size: int = 16
    backend: str = "auto"             # "auto" | "gpu" | "xla"
    block_dz: Optional[int] = None    # force z-block extent (else HBM planner)
    hbm_budget_bytes: Optional[int] = None
    cache_projections: Optional[bool] = None   # None = auto by RAM
    resume: bool = False
    max_cache_bytes: int = 64 << 30
    trace_dir: Optional[str] = None   # jax.profiler trace output
    # Stop after computing this many NEW blocks (None = all); completed
    # blocks are durable in the sink manifest, so a wrapper re-invokes
    # with resume=True until the volume is complete (bounds the work and
    # resources of one process on very long jobs).
    max_blocks: Optional[int] = None


# Device bytes the XLA backprojection op holds beside its accumulator:
# its temporaries for one z-slab (``max_temp_bytes`` = 256 MiB of
# accumulator).  compiled.memory_analysis() of the step on an H100 at a
# (256, 1024, 1024) block, C=16: 363 MB temp with the XLA op vs 269 MB
# with the kernel (the chunk's filter buffers), so the op holds ~94 MB
# — under one slab, which is what is budgeted.
_XLA_SLAB_BYTES = 256 << 20
_XLA_SLAB_TEMPS = 1


def _block_hbm_bytes(vol_geo: VolumeGeometry, dz: int,
                     backend: str = "gpu") -> int:
    """Peak device bytes of one z-block: the unpadded ``(dz, ny, nx)``
    f32 accumulator (updated in place: the step donates it, the GPU
    kernel aliases it, the XLA op writes its slabs back in place) plus
    what the backprojection op holds beside it — nothing for the GPU
    kernel (it keeps its tile in registers), the slab temporaries for
    the XLA op.  Finalize is a plain d2h copy of the block."""
    acc = 4 * dz * vol_geo.dim_y * vol_geo.dim_x
    if backend == "xla":
        acc += _XLA_SLAB_TEMPS * min(acc, _XLA_SLAB_BYTES)
    return acc


def _free_hbm_bytes() -> Optional[int]:
    """Live free-HBM probe (bytes); None when stats are unavailable."""
    try:
        dev = jax.local_devices()[0]
        stats = dev.memory_stats() or {}
    except Exception:                     # backends without stats support
        return None
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if not limit:
        return None
    return int(limit) - int(stats.get("bytes_in_use", 0))


def _overlap_free_est(hbm_budget: Optional[int],
                      budget_is_auto: bool) -> Optional[int]:
    """Free-device-memory estimate for the finalize/write overlap gate.

    Prefer a live stats probe.  Without stats, ``hbm_budget/0.45`` only
    recovers free memory when the budget came from ``_auto_hbm_budget``
    (which returned 45% of free); a USER-supplied --hbm-budget-gb is an
    absolute cap — on BOTH paths (live stats included): sizing two
    accumulators against actual free HBM would let runtime residency
    exceed the user's stated limit ~2x, defeating the cap's purpose
    (co-tenant setups; ADVICE r4).  None = no information (overlap
    allowed)."""
    free = _free_hbm_bytes()
    if free is not None:
        est = int(free * 0.95)
        return est if budget_is_auto or hbm_budget is None \
            else min(est, hbm_budget)
    if hbm_budget is None:
        return None
    if budget_is_auto:
        return int(hbm_budget / 0.45 * 0.95)
    return hbm_budget


def _fits_two_blocks(vol_geo: VolumeGeometry, dz: int, proj_buffer: int,
                     free_est: Optional[int], n_shards: int = 1,
                     backend: str = "gpu") -> bool:
    """Do TWO block accumulators (+ staging) fit the free estimate?
    The single overlap-fit criterion — the planner's extent cap and the
    runtime overlap gate must agree (same expression, one place), and
    BOTH drivers use it: ``n_shards`` scales the block to the per-device
    share on a sharded mesh (free_est is per-device)."""
    if free_est is None:
        return True
    return (2 * _block_hbm_bytes(vol_geo, dz, backend) // max(1, n_shards)
            + proj_buffer <= free_est)


def _overlap_block_dz(vol_geo: VolumeGeometry, free_est: Optional[int],
                      proj_buffer: int, dz_padded: int,
                      n_shards: int = 1, align: int = 8,
                      backend: str = "gpu") -> Optional[int]:
    """Largest ``align``-aligned extent below ``dz_padded`` for which
    TWO block accumulators (+ staging buffers) fit the device's free
    memory — enables the finalize/write overlap.  None when the
    current extent already fits (no change needed) or when nothing
    above 128 slices does (thinner blocks would multiply the per-block
    passes over the projections for little gain)."""
    def fits_two(dz: int) -> bool:
        return _fits_two_blocks(vol_geo, dz, proj_buffer, free_est,
                                n_shards, backend)

    if fits_two(dz_padded):
        return None
    dz2 = dz_padded - align
    while dz2 > 128 and not fits_two(dz2):
        dz2 -= align
    return dz2 if dz2 > 128 else None


def _finish_writer(writer, pending_future, logger_) -> None:
    """Writer-thread epilogue shared by BOTH drivers' try/finally:
    drain an in-flight write (never torn mid-block) and ALWAYS join the
    writer thread.  On the normal path the pending future is already
    None (the loop tail waited); on the exception path the write's own
    failure is LOGGED rather than raised so it cannot mask the original
    error — raised only when no other exception is active."""
    import sys as _sys
    in_flight_exc = _sys.exc_info()[1] is not None
    try:
        if pending_future is not None:
            pending_future.result()
    except Exception:
        if not in_flight_exc:
            raise
        logger_.exception("in-flight block write also failed "
                          "during error shutdown")
    finally:
        writer.shutdown(wait=True)


def _auto_hbm_budget() -> Optional[int]:
    """Default per-device volume-block budget from live device memory.

    Analog of the reference's memory probe
    (src/cuda/subvolume_information.cpp:72-109: free-memory query +
    ``vol + 10*proj`` model + confirming test allocation): XLA exposes
    ``bytes_limit``/``bytes_in_use`` per device (the GPU client reports
    the pool it reserved), so the budget is deterministic — no trial
    allocation loop.  Returns ~45% of free device memory, leaving room
    for a second block during the finalize/write overlap, the op's
    temporaries and XLA's own buffers; projection residency is
    subtracted separately by ``plan_z_blocks``.  Returns None (single
    whole-volume block) when the device reports no memory stats (e.g.
    CPU): no size is assumed for an unknown device.
    """
    free = _free_hbm_bytes()
    if free is None:
        return None
    budget = int(free * 0.45)
    return budget if budget > 0 else None


def _roi_offset(job: ReconstructionJob) -> Tuple[int, int, int]:
    if job.roi is None:
        return (0, 0, 0)
    return (job.roi.x1, job.roi.y1, job.roi.z1)


def run_job(job: ReconstructionJob) -> str:
    """Run a full reconstruction; returns the output ddbvf path.

    Raises ``StageConstructionError`` if the pipeline cannot be built
    (bad geometry/paths/backend) and ``StageRuntimeError`` if it fails
    mid-stream — the reference's two exception tiers (exception.h:31-41).
    """
    try:
        return _run_job(job)
    except (ParisError, KeyboardInterrupt):
        raise
    except (OSError, ValueError) as e:
        raise StageRuntimeError(f"reconstruction failed: {e}") from e


def _run_job(job: ReconstructionJob) -> str:
    t_start = time.perf_counter()
    timers = StageTimers()

    try:
        full_geo = derive_volume_geometry(job.det)
    except ValueError as e:
        raise StageConstructionError(str(e)) from e
    logger.info("volume [vx]: %d x %d x %d, voxel %.4f mm",
                full_geo.dim_x, full_geo.dim_y, full_geo.dim_z,
                full_geo.l_vx_x)
    vol_geo = apply_roi(full_geo, job.roi) if job.roi else full_geo
    if job.roi:
        logger.info("ROI volume [vx]: %d x %d x %d",
                    vol_geo.dim_x, vol_geo.dim_y, vol_geo.dim_z)

    try:
        backend = resolve_backend(job.backend)
    except ValueError as e:
        raise StageConstructionError(str(e)) from e
    proj_bytes = 4 * job.det.n_row * job.det.n_col
    proj_buffer = 4 * proj_bytes * job.chunk_size
    hbm_budget = job.hbm_budget_bytes
    if hbm_budget is None:
        hbm_budget = _auto_hbm_budget()
        if hbm_budget is not None:
            logger.info("auto HBM budget: %.1f GB per device",
                        hbm_budget / 2**30)
    try:
        info = plan_z_blocks(
            vol_geo,
            hbm_budget_bytes=hbm_budget,
            proj_buffer_bytes=proj_buffer,
            block_dz=job.block_dz,
        )
    except ValueError as e:
        # planner failures (budget too small for one slice, bad forced
        # extent) are construction-phase, like the reference's
        # stage_construction_error (src/exception.h:31-36)
        raise StageConstructionError(str(e)) from e
    logger.info("z-split: %d block(s) of %d slices (padded)",
                info.num, info.dim_z_padded)

    # prefer an overlap-capable split: when the volume is multi-block
    # ANYWAY, capping the extent so TWO padded accumulators fit lets
    # the writer thread drain block k while k+1 reconstructs (the write
    # can dominate wall time on slow sinks); a user-forced --block-dz is
    # respected.
    # PARIS_WRITE_OVERLAP=0 disables the finalize/write overlap (and the
    # extent adjustment that serves it).  Default ON: with dedicated DMA
    # engines and a disk sink, hiding compute behind the write is free.
    import os as _os
    overlap_enabled = _os.environ.get("PARIS_WRITE_OVERLAP", "1") != "0"
    free_est = _overlap_free_est(hbm_budget,
                                 budget_is_auto=job.hbm_budget_bytes is None)
    if overlap_enabled and free_est is not None and info.num > 1 \
            and job.block_dz is None:
        dz2 = _overlap_block_dz(vol_geo, free_est, proj_buffer,
                                info.dim_z_padded, backend=backend)
        if dz2 is not None:
            info = plan_z_blocks(
                vol_geo, hbm_budget_bytes=hbm_budget,
                proj_buffer_bytes=proj_buffer, block_dz=dz2)
            logger.info(
                "z-split adjusted for write overlap: %d block(s) "
                "of %d slices (padded)", info.num, info.dim_z_padded)

    try:
        sink = VolumeSink(job.output_path, job.prefix, vol_geo.dim_x,
                          vol_geo.dim_y, vol_geo.dim_z, resume=job.resume)
    except (OSError, ValueError) as e:
        raise StageConstructionError(f"cannot open sink: {e}") from e

    try:
        rec = Reconstructor(
            job.det, full_geo, chunk_size=job.chunk_size, backend=backend,
            block_shape=(info.dim_z_padded, vol_geo.dim_y, vol_geo.dim_x),
        )
    except ValueError as e:
        raise StageConstructionError(str(e)) from e
    logger.info("backend: %s, chunk size %d", rec.backend, job.chunk_size)

    def new_source() -> ProjectionSource:
        return ProjectionSource(
            job.input_path, angle_file=job.angle_path,
            delta_phi=job.det.delta_phi, quality=job.quality,
        )

    # decide on host-side projection caching
    cache = job.cache_projections
    cached: Optional[Tuple[np.ndarray, np.ndarray]] = None

    rx1, ry1, rz1 = _roi_offset(job)
    n_done = 0
    # Overlapped finalize: block k's device->host drain + ddbvf write
    # run on a writer thread WHILE block k+1 reconstructs — the write
    # phase can dominate wall time on slow disks, and the reference
    # serialized it per
    # subvolume behind a mutex (src/sink.cpp:72-94).  Requires TWO
    # block accumulators resident at once, so overlap only engages when
    # they fit the device's free memory.
    import concurrent.futures as _cf
    overlap = overlap_enabled and _fits_two_blocks(
        vol_geo, info.dim_z_padded, proj_buffer, free_est,
        backend=backend)
    if overlap and info.num > 1:
        logger.info("write overlap: block k+1 reconstructs while "
                    "block k drains to disk")
    writer = _cf.ThreadPoolExecutor(1, thread_name_prefix="paris-write")
    pending: Optional[_cf.Future] = None

    def _finalize_write(vol_state, blk):
        with timers.time("finalize+write"):
            out = rec.finalize(vol_state)[: blk.dim_z]
            sink.write_block(blk.index, out, blk.z0)

    # The try/finally makes the failure path DELIBERATE (r4 verdict 6):
    # on an exception escaping the loop the writer thread is drained
    # synchronously — no torn block, no orphaned thread — and a pending
    # write's own failure surfaces without masking the original error.
    try:
        for block in info.blocks:
            if sink.is_done(block.index):
                logger.info("block %d already complete, skipping (resume)",
                            block.index)
                continue
            logger.info("reconstructing block %d/%d (z %d..%d)",
                        block.index + 1, info.num, block.z0,
                        block.z0 + block.dim_z - 1)
            volume = rec.init_block()
            n_proj = 0
            # rate counts VALID voxels only (padded tail slices are compute
            # overhead, not useful updates)
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
                    # explicit True always collects (dataclass contract);
                    # auto (None) collects only when a later block will
                    # reuse the cache
                    state = {"collect": cache is True
                             or (cache is None and info.num > 1)}
                    datas, angles = [], []

                    def pairs():
                        # consumed on THIS thread by stage_stream; staging
                        # (padding + h2d) runs on its worker threads
                        for plist in new_source().iter_chunks(rec.chunk_size):
                            data = np.stack([p.data for p in plist])
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

                    from .pipeline import stage_stream
                    stream = StreamTimer(first=n_done == 0)
                    for staged, k in stage_stream(rec.stage_chunk, pairs()):
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
                        cached = (np.concatenate(datas), np.concatenate(angles))
                # close the stage only when the device has actually finished
                # (async dispatch returns early); keeps the reconstruct /
                # finalize+write split honest
                jax.block_until_ready(volume)
            if n_proj == 0:
                logger.warning("no projections found in %s", job.input_path)
            if pending is not None:
                # bound in-flight accumulators at 2 (this block's + the one
                # draining); also surfaces writer-thread errors
                pending.result()
                pending = None
            pending = writer.submit(_finalize_write, volume, block)
            # drop the loop's reference NOW: without overlap the wait below
            # frees the accumulator before the next init_block (a 2x-block
            # peak would not fit when one block fills the budget)
            volume = None
            if not overlap:
                pending.result()
                pending = None
            n_done += 1
            pps, gups = meter.rates()
            logger.info("block %d done (%d projections, %.1f proj/s, %.1f Gupd/s)",
                        block.index, n_proj, pps, gups)
            if job.max_blocks is not None and n_done >= job.max_blocks:
                logger.info("stopping after %d block(s) (max_blocks); "
                            "resume=True completes the remaining blocks",
                            n_done)
                break

        if pending is not None:
            pending.result()
            pending = None
    finally:
        _finish_writer(writer, pending, logger)
    total = time.perf_counter() - t_start
    timers.report(logger)
    logger.info("reconstruction finished in %s -> %s",
                fmt_duration(total), sink.path)
    return sink.path
