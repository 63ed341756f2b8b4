"""FDK cosine weighting.

Reference math: src/cuda/weighting.cu:49-56 / src/openmp/weighting.cpp:36-56:

    h_s  = l_px_row/2 + s*l_px_row + h_min        (detector coord, mm)
    v_t  = l_px_col/2 + t*l_px_col + v_min
    w    = d_sd / sqrt(d_sd^2 + h_s^2 + v_t^2)
    p   *= w

Design: the weight map depends only on geometry, never on the
projection data, so we precompute it ONCE as an (n_col, n_row) array and
apply it as a broadcast multiply over a whole projection chunk — XLA
fuses this into the surrounding filter pipeline, so there is no separate
kernel launch or extra HBM pass (unlike the reference, which runs a
dedicated CUDA kernel per projection).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry import DetectorGeometry, weighting_constants

__all__ = ["weight_map", "apply_weights"]


def weight_map(det: DetectorGeometry, dtype=jnp.float32) -> jnp.ndarray:
    """(n_col, n_row) FDK cosine-weight image for this detector."""
    h_min, v_min, d_sd = weighting_constants(det)
    s = jnp.arange(det.n_row, dtype=jnp.float32)
    t = jnp.arange(det.n_col, dtype=jnp.float32)
    h_s = det.l_px_row / 2.0 + s * det.l_px_row + h_min       # (n_row,)
    v_t = det.l_px_col / 2.0 + t * det.l_px_col + v_min       # (n_col,)
    w = d_sd / jnp.sqrt(d_sd * d_sd + h_s[None, :] ** 2 + v_t[:, None] ** 2)
    return w.astype(dtype)


def apply_weights(projections: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Multiply a (..., n_col, n_row) projection chunk by the weight map."""
    return projections * weights
