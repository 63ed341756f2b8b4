"""Single-device FDK reconstruction pipeline.

Replaces the reference's per-projection streaming loop
(src/main.cpp:98-105: load -> h2d -> weight -> filter -> backproject, one
projection at a time) with a chunked design:

  * projections are processed in fixed-size CHUNKS (static shapes, one
    XLA program) — weighting+filtering batch over the whole chunk (FFTs
    want batches), and the backprojection accumulates the full chunk
    into the volume block in one call;
  * the volume accumulator is DONATED between steps (in-place update,
    no copy) and stays in the ``(dz, ny, nx)`` layout it is written in;
  * host->device feeding is overlapped with device compute via JAX async
    dispatch: while the device runs chunk i, worker threads stage the
    next chunks.

Backends: ``"gpu"`` — the Pallas/Triton kernel
(``ops/backprojection_gpu.py``); ``"xla"`` — the portable in-graph op
(``ops/backprojection_xla.py``).  ``"auto"`` picks the kernel on a GPU
and the XLA op elsewhere; nothing falls back silently.

``Reconstructor`` is the reusable compiled program; ``reconstruct`` is
the convenience one-shot driver.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import itertools
import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .geometry import DetectorGeometry, VolumeGeometry
from .ops.weighting import weight_map
from .ops.filtering import ramp_filter_spectrum, filter_projections
from .ops.backprojection_xla import backproject_chunk_xla, make_bp_grid

__all__ = ["Reconstructor", "reconstruct", "preprocess_chunk",
           "resolve_backend", "backprojector"]

BACKENDS = ("auto", "gpu", "xla")


def preprocess_chunk(chunk, weights, spectrum, n_row):
    """weight + ramp-filter a (C, n_col, n_row) chunk (fused by XLA)."""
    return filter_projections(chunk * weights, spectrum, n_row)


def resolve_backend(backend: str, interpret: bool = False) -> str:
    """``auto`` -> ``gpu`` on a GPU, ``xla`` elsewhere.

    An explicit ``gpu`` where JAX has no GPU raises unless
    ``interpret=True`` (the kernel then runs in the Pallas interpreter,
    which is what the CPU tests do).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(choose from {', '.join(BACKENDS)})")
    platform = jax.default_backend()
    if backend == "auto":
        return "gpu" if platform == "gpu" else "xla"
    if backend == "gpu" and platform != "gpu" and not interpret:
        raise ValueError(
            f"backend 'gpu' needs a GPU but JAX runs on {platform!r}; "
            "use backend='xla' (or 'auto'), or interpret=True to emulate "
            "the kernel")
    return backend


def backprojector(backend: str, grid, interpret: bool = False):
    """``bp(volume, filtered, sin, cos, offs)`` for a resolved backend;
    ``offs`` = int32 ``[roi x1, roi y1, global z of volume[0]]``."""
    if backend == "gpu":
        from .ops.backprojection_gpu import backproject_chunk_gpu

        def bp_gpu(volume, filtered, sin_phi, cos_phi, offs):
            return backproject_chunk_gpu(volume, filtered, sin_phi, cos_phi,
                                         grid, offs, interpret=interpret)
        return bp_gpu

    def bp_xla(volume, filtered, sin_phi, cos_phi, offs):
        return backproject_chunk_xla(
            volume, filtered, sin_phi, cos_phi, grid,
            z_offset=offs[2], roi_offset=(offs[0], offs[1], 0))
    return bp_xla


def host_chunk(chunk, ang, chunk_size: int):
    """One (chunk, angles) pair -> host f32 ``(chunk, sin, cos)``,
    zero-padded to ``chunk_size`` frames (padded frames filter to zero
    and add nothing; their angle is 0)."""
    chunk = np.asarray(chunk, dtype=np.float32)
    ang = np.asarray(ang, dtype=np.float32)
    pad = chunk_size - chunk.shape[0]
    if pad > 0:
        chunk = np.pad(chunk, ((0, pad), (0, 0), (0, 0)))
        ang = np.pad(ang, (0, pad))
    phi = np.deg2rad(ang).astype(np.float32)
    return chunk, np.sin(phi), np.cos(phi)


def step_offsets(z_offset: int, roi_offset: Tuple[int, int, int]):
    """The step's int32 ``offs``: ``[roi x1, roi y1, global z0]``."""
    rx1, ry1, rz1 = roi_offset
    return jnp.asarray([rx1, ry1, int(rz1 + z_offset)], jnp.int32)


# concurrent staging workers (stage_stream default)
_STAGE_WORKERS = 2


def stage_stream(stage_fn, pairs, *, depth: int = 3,
                 workers: int = _STAGE_WORKERS):
    """Run ``stage_fn(data, angles)`` on a thread pool, keeping up to
    ``depth`` staged chunks in flight; yields ``(staged, n)`` in order.

    With staging on worker threads, the host-side preparation and h2d
    transfer of the next chunks overlap each other (device_put releases
    the GIL) and the device's execution of the current step; the
    consumer thread only dispatches steps.  ``depth`` bounds the
    device-side buffering to a few chunks.
    """
    with concurrent.futures.ThreadPoolExecutor(
            workers, thread_name_prefix="paris-stage") as ex:
        pairs = iter(pairs)
        futs: collections.deque = collections.deque()
        try:
            for data, ang in itertools.islice(pairs, depth):
                futs.append((ex.submit(stage_fn, data, ang), len(ang)))
            while futs:
                fut, n = futs.popleft()
                staged = fut.result()
                nxt = next(pairs, None)
                if nxt is not None:
                    futs.append(
                        (ex.submit(stage_fn, nxt[0], nxt[1]), len(nxt[1])))
                yield staged, n
        finally:
            for fut, _ in futs:
                fut.cancel()


def _cache_key_det(det: DetectorGeometry) -> DetectorGeometry:
    """Detector as keyed in the compiled-step cache: delta_phi zeroed.

    The compiled program is delta-phi-INVARIANT — angles enter as
    runtime sin/cos arrays, and every trace-time constant (weights,
    filter spectrum, BpGrid) depends only on pixel pitches, offsets and
    distances — so two scans of the same geometry at different angular
    steps (e.g. a 360- and a 3600-projection scan) share one step."""
    return dataclasses.replace(det, delta_phi=0.0)


# Compiled steps keyed by everything that shapes the program, shared
# across Reconstructor instances: a new Reconstructor for the same
# (geometry, config) reuses the jitted step, so repeated jobs in one
# process (warmup + timed run, multi-job services, the CLI called as a
# library) trace and compile ONCE.  LRU-bounded (PARIS_STEP_CACHE_MAX
# entries, default 64): a long-lived service rotating geometries must
# not accumulate compiled executables without limit; live
# Reconstructors keep their own reference, so eviction only drops the
# shared handle.
_STEP_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def _step_cache_put(key, step):
    _STEP_CACHE[key] = step
    _STEP_CACHE.move_to_end(key)
    raw = os.environ.get("PARIS_STEP_CACHE_MAX", "64")
    try:
        limit = int(raw)
    except ValueError:
        logging.getLogger("paris_tpu.pipeline").warning(
            "ignoring malformed PARIS_STEP_CACHE_MAX=%r (using 64)", raw)
        limit = 64
    while len(_STEP_CACHE) > max(1, limit):
        _STEP_CACHE.popitem(last=False)


def _step_cache_get(key):
    step = _STEP_CACHE.get(key)
    if step is not None:
        _STEP_CACHE.move_to_end(key)
    return step


class Reconstructor:
    """Compiled single-device FDK step for one (det, vol) geometry.

    ``chunk_size`` is the number of projections accumulated per volume
    pass.  Larger chunks amortize volume traffic; the projections of a
    chunk must fit on-device alongside the volume block.
    """

    def __init__(
        self,
        det: DetectorGeometry,
        vol: VolumeGeometry,
        *,
        chunk_size: int = 16,
        block_shape: Optional[Tuple[int, int, int]] = None,  # (dz, ny, nx)
        backend: str = "auto",
        interpret: bool = False,
        device=None,
    ):
        self.det = det
        self.vol = vol
        self.chunk_size = int(chunk_size)
        self.block_shape = tuple(block_shape or vol.shape_zyx)
        self.device = device
        self.grid = make_bp_grid(det, vol)
        self.backend = resolve_backend(backend, interpret)

        key = (self.backend, _cache_key_det(det), vol, self.chunk_size,
               self.block_shape, interpret,
               None if device is None else repr(device))
        step = _step_cache_get(key)
        if step is None:
            weights = weight_map(det)
            spectrum = ramp_filter_spectrum(det.n_row, det.l_px_row)
            bp = backprojector(self.backend, self.grid, interpret)

            @functools.partial(jax.jit, donate_argnums=(0,))
            def step(volume, chunk, sin_phi, cos_phi, offs):
                filtered = preprocess_chunk(chunk, weights, spectrum,
                                            det.n_row)
                return bp(volume, filtered, sin_phi, cos_phi, offs)

            _step_cache_put(key, step)
        self._step = step

    # -- chunk iteration ----------------------------------------------------

    def _chunks(self, projections, angles_deg) -> Iterator[Tuple[np.ndarray,
                                                                 np.ndarray]]:
        """Yield (chunk, angles) pairs of at most ``chunk_size`` frames
        (``stage_chunk`` zero-pads the tail to the static shape)."""
        C = self.chunk_size
        for i in range(0, len(angles_deg), C):
            yield projections[i:i + C], angles_deg[i:i + C]

    # -- public API ---------------------------------------------------------

    def init_block(self) -> jnp.ndarray:
        z = jnp.zeros(self.block_shape, jnp.float32)
        return jax.device_put(z, self.device) if self.device else z

    def stage_chunk(self, chunk, ang):
        """Start the async h2d of one (chunk, angles) pair (f32, padded
        by ``host_chunk``).  Returns the argument pack ``step_staged``
        consumes; issuing it one chunk AHEAD of its step overlaps the
        transfer with the previous step's execution."""
        put = (functools.partial(jax.device_put, device=self.device)
               if self.device else jax.device_put)
        return tuple(put(a) for a in host_chunk(chunk, ang, self.chunk_size))

    def step_staged(self, volume, staged, *, z_offset: int = 0,
                    roi_offset: Tuple[int, int, int] = (0, 0, 0)):
        """Accumulate one pre-staged chunk (see ``stage_chunk``)."""
        return self._step(volume, *staged, step_offsets(z_offset, roi_offset))

    def accumulate(
        self,
        volume: jnp.ndarray,
        projections,
        angles_deg,
        *,
        z_offset: int = 0,
        roi_offset: Tuple[int, int, int] = (0, 0, 0),
    ) -> jnp.ndarray:
        """Stream all projections through weight/filter/backproject,
        staged ahead on worker threads (``stage_stream``)."""
        offs = step_offsets(z_offset, roi_offset)
        for staged, _ in stage_stream(
                self.stage_chunk, self._chunks(projections, angles_deg)):
            volume = self._step(volume, *staged, offs)
        return volume

    def finalize(self, volume: jnp.ndarray) -> np.ndarray:
        """Device block -> (dz, ny, nx) ndarray."""
        return np.asarray(volume)

    def run(self, projections, angles_deg, **kw) -> np.ndarray:
        return self.finalize(
            self.accumulate(self.init_block(), projections, angles_deg, **kw))


def reconstruct(
    det: DetectorGeometry,
    vol: VolumeGeometry,
    projections,
    angles_deg,
    *,
    chunk_size: int = 16,
    backend: str = "auto",
    z_offset: int = 0,
    roi_offset: Tuple[int, int, int] = (0, 0, 0),
    block_shape: Optional[Tuple[int, int, int]] = None,
    interpret: bool = False,
) -> np.ndarray:
    """One-shot FDK reconstruction; returns the (dz, ny, nx) volume."""
    rec = Reconstructor(
        det, vol, chunk_size=chunk_size, backend=backend,
        block_shape=block_shape, interpret=interpret,
    )
    return rec.run(projections, angles_deg,
                   z_offset=z_offset, roi_offset=roi_offset)
