"""Multi-device / multi-host parallel execution over device meshes."""

from .mesh import make_z_mesh, volume_sharding, replicated_sharding, Z_AXIS
from .dist import DistributedReconstructor
from .multihost import initialize as init_multihost, is_multihost
