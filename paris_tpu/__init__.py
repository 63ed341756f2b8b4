"""paris_tpu — cone-beam CT (FDK) reconstruction framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
reference C++/CUDA framework (hzdr/PARIS): HIS projection ingest, FDK
cosine weighting, FFT ramp filtering, voxel-driven filtered
backprojection over z-subvolumes, ddbvf output — one GPU to the GPUs
of several hosts.  The backprojection hot path is a Pallas/Triton
kernel for NVIDIA GPUs; a portable XLA op runs everywhere else.
"""

from .exceptions import (
    ParisError,
    StageConstructionError,
    StageRuntimeError,
)
from .geometry import (
    DetectorGeometry,
    VolumeGeometry,
    RegionOfInterest,
    SubvolumeInfo,
    ZBlock,
    derive_volume_geometry,
    apply_roi,
    plan_z_blocks,
    detector_row_band,
    filter_size_for,
)

__version__ = "0.1.0"
