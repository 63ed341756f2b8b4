"""Device mesh construction for z-sharded FDK reconstruction.

The reference scaled by handing z-subvolume tasks to one worker thread
per GPU from a shared queue (src/main.cpp:141-169).  Here the
equivalent is deterministic: a 1-D ``jax.sharding.Mesh`` over all
devices (the GPUs of a host are joined all to all, so the mesh
follows the algorithm alone), the volume z-axis sharded across it,
projections all-gathered —
backprojection is embarrassingly parallel across z-shards (zero
steady-state collectives, matching the reference's zero-communication
structure — SURVEY.md §2 parallelism table).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_z_mesh", "volume_sharding", "replicated_sharding", "Z_AXIS"]

Z_AXIS = "z"


def make_z_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the given (default: all) devices, axis name 'z'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (Z_AXIS,))


def volume_sharding(mesh: Mesh, z_dim_index: int = 0) -> NamedSharding:
    """Sharding for a volume array, sharded along its z dimension
    (``z_dim_index``; 0 for the (z, y, x) layout every path uses)."""
    spec = [None, None, None]
    spec[z_dim_index] = Z_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
