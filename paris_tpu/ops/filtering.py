"""Ramp (Ram-Lak) filtering of projections via batched real FFTs.

Reference math (src/cuda/filtering.cu:45-121, src/openmp/filtering.cpp):

  * filter_size = 2 * next_pow2(n_row)
  * spatial ramp kernel r(j), j = -(filter_size-2)/2 .. filter_size/2:
        r(0)      = 1/(8 tau^2)
        r(even j) = 0
        r(odd j)  = -1/(2 j^2 pi^2 tau^2)        tau = l_px_row [mm]
  * frequency response K = tau * |FFT(r)|  (real, length filter_size/2+1)
  * application per detector row: zero-pad the row to filter_size, R2C
    FFT, multiply by K, C2R FFT, crop to n_row, divide by filter_size.

Design: the reference's cuFFT/FFTW plans + expand/shrink/
normalize kernels collapse into one jnp expression — ``jnp.fft.rfft``
over the minor axis of a (chunk, n_col, n_row) block, a broadcast
multiply, and ``irfft`` (whose built-in 1/n normalization equals the
reference's explicit ÷filter_size since cuFFT/FFTW are unnormalized).
XLA batches the FFTs over chunk x n_col rows and fuses the multiply, the
weight map (ops/weighting.py), and the crop into the surrounding
computation; no intermediate buffers hit HBM.

Note the reference multiplies the complex spectrum COMPONENT-wise by a
"complex" filter whose re and im parts both equal K
(cuda/filtering.cu:81-104) — i.e. (a+bi) -> (K*a) + (K*b)i, which is
exactly scalar multiplication by the real K.  We keep K real.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..geometry import filter_size_for

__all__ = ["ramp_kernel_real", "ramp_filter_spectrum", "filter_projections"]


def ramp_kernel_real(filter_size: int, tau: float) -> np.ndarray:
    """Spatial-domain ramp kernel r(j) (host-side, float32)."""
    j = np.arange(filter_size, dtype=np.int64) - (filter_size - 2) // 2
    r = np.zeros(filter_size, dtype=np.float64)
    r[j == 0] = 1.0 / (8.0 * tau * tau)
    odd = (j % 2) != 0
    r[odd] = -1.0 / (2.0 * j[odd].astype(np.float64) ** 2 * np.pi**2 * tau * tau)
    return r.astype(np.float32)


def ramp_filter_spectrum(n_row: int, tau: float) -> jnp.ndarray:
    """K = tau * |rfft(r)|, shape (filter_size//2 + 1,) float32."""
    size = filter_size_for(n_row)
    r = ramp_kernel_real(size, tau)
    spectrum = np.abs(np.fft.rfft(r.astype(np.float64))) * tau
    return jnp.asarray(spectrum.astype(np.float32))


def filter_projections(
    projections: jnp.ndarray,
    spectrum: jnp.ndarray,
    n_row: int,
) -> jnp.ndarray:
    """Ramp-filter a (..., n_col, n_row) projection block along rows.

    Equivalent to the reference expand -> R2C -> multiply -> C2R ->
    shrink -> normalize chain (src/cuda/filtering.cu:189-261) in one
    fused XLA expression.
    """
    size = filter_size_for(n_row)
    spec = jnp.fft.rfft(projections, n=size, axis=-1)
    filtered = jnp.fft.irfft(spec * spectrum, n=size, axis=-1)
    return filtered[..., :n_row].astype(projections.dtype)
