"""Multi-host execution support.

The reference was strictly single-node (SURVEY.md §2: no MPI/NCCL — one
process, one thread per GPU).  Within one host a single process drives
all local GPUs over one mesh; across hosts the pattern is
single-controller-per-host SPMD:

  * every host calls ``initialize()`` (jax.distributed) and then builds
    the SAME global mesh over all devices;
  * every host walks the projection stream's headers but pixel-DECODES
    only the frames of its own chunk shard (``ProjectionSource
    slot_filter`` + ``read_his_selective``) — input decode bandwidth
    scales with hosts;
  * each host materializes only ITS OWN shards of the sharded volume
    (``local_block_slices``) and writes them to the shared ddbvf at
    their global offsets via positional pwrite — no gather, no lock
    (io/ddbvf.py semantics).

These helpers are exercised in CI on a single process (where they
degenerate to trivial cases) and by two-process CPU tests
(tests/test_multihost_2proc.py).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import traceback
from typing import List, Optional, Tuple

import numpy as np
import jax

logger = logging.getLogger("paris_tpu.multihost")

__all__ = ["initialize", "is_multihost", "barrier", "local_block_slices",
           "write_local_shards", "crash_diagnostics"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when single-process with no env).

    With no arguments, defers to ``jax.distributed.initialize()``'s own
    environment detection only when a coordinator address is exported
    (``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS``), and stays
    single-process otherwise (one process drives all GPUs of one host;
    a single machine must not block on a nonexistent coordinator).
    Multi-host runs pass the coordinator, process count and id
    explicitly (CLI ``--coordinator``).  Must run before the first
    device query (the CLI calls it before any jax computation;
    reference analog: the per-device fan-out in src/main.cpp:157-169
    happened before any work was dispatched).
    """
    if num_processes is not None and num_processes <= 1:
        return
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        hints = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
        if not any(os.environ.get(h) for h in hints):
            logger.info("no multi-host environment detected; running "
                        "single-process over local devices")
            return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info("jax.distributed initialized: process %d/%d, %d/%d devices "
                "local", jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())


def is_multihost() -> bool:
    return jax.process_count() > 1


@contextlib.contextmanager
def crash_diagnostics(stage: str, marker_dir: Optional[str] = None):
    """Name the failing PROCESS when a distributed run dies.

    On a multi-host run, every host runs the same SPMD program; a bare traceback
    doesn't say which host/process failed (the reference's
    signal-handler backtrace was per-process but single-node,
    src/main.cpp:69-77).  This wraps a stage so a failure logs
    ``process <i>/<n> on <host>`` with the exception, optionally drops a
    ``crash.p<i>.log`` marker into ``marker_dir`` (a shared filesystem
    makes every host's failure visible from any host), then re-raises.
    """
    try:
        yield
    except Exception as e:
        pid = jax.process_index()
        pcount = jax.process_count()
        host = socket.gethostname()
        logger.error(
            "DISTRIBUTED FAILURE in stage %r: process %d/%d on %s "
            "(pid %d): %s: %s", stage, pid, pcount, host, os.getpid(),
            type(e).__name__, e)
        if marker_dir:
            try:
                os.makedirs(marker_dir, exist_ok=True)
                with open(os.path.join(marker_dir, f"crash.p{pid}.log"),
                          "w") as f:
                    f.write(f"stage: {stage}\nprocess: {pid}/{pcount}\n"
                            f"host: {host}\npid: {os.getpid()}\n\n")
                    f.write(traceback.format_exc())
            except OSError:
                logger.warning("could not write crash marker to %s",
                               marker_dir)
        raise


def local_block_slices(volume: jax.Array) -> List[Tuple[int, np.ndarray]]:
    """(global_offset_dim0, data) for each addressable contiguous shard.

    For a dim-0-sharded volume this yields the z-slabs this host owns.
    """
    out = []
    for shard in volume.addressable_shards:
        idx = shard.index[0]
        start = idx.start if idx.start is not None else 0
        out.append((start, np.asarray(shard.data)))
    return out


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op single-process)."""
    if not is_multihost():
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def agree_min(*values: Optional[int]) -> tuple:
    """Cross-process agreement on host-probed quantities (min-reduce).

    Planning inputs probed per process (live free-HBM stats, auto
    budgets) can differ between hosts; feeding them unagreed into the
    block planner or the write-overlap gate would let processes pick
    DIFFERENT block maps or different collective orderings — silent
    shard misplacement or a barrier deadlock.  Every process receives
    the same elementwise minimum (the most conservative probe wins);
    ``None`` (no information) is encoded as -1 and wins only when NO
    process has a value.  No-op single-process.
    """
    if not is_multihost():
        return values
    from jax.experimental import multihost_utils
    enc = np.asarray([-1 if v is None else int(v) for v in values],
                     np.int64)
    allv = np.asarray(multihost_utils.process_allgather(enc))
    out = []
    for i in range(len(values)):
        known = allv[:, i][allv[:, i] >= 0]
        out.append(int(known.min()) if known.size else None)
    return tuple(out)


def write_local_shards(path: str, volume: jax.Array, z_base: int,
                       max_z: Optional[int] = None) -> int:
    """Write this host's z-shards of a (dz, ny, nx)-sharded block into the
    ddbvf at global offset ``z_base``; returns slices written."""
    from ..io import ddbvf
    written = 0
    for z0, data in local_block_slices(volume):
        dz = data.shape[0]
        if max_z is not None:
            dz = min(dz, max_z - (z_base + z0))
            if dz <= 0:
                continue
        ddbvf.write_slices(path, data[:dz], z_base + z0)
        written += dz
    return written
