"""Pallas backprojection kernel for GPUs (Triton route) vs the XLA op and
the NumPy oracle.

On CPU the kernel runs in the Pallas interpreter (``interpret=True``),
which executes the same kernel body program by program; the compiled
kernel runs on the card in ``chip_smoke.py`` and in the ``gpu``-marked
test below.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paris_tpu.geometry import (
    DetectorGeometry, VolumeGeometry, derive_volume_geometry,
)
from paris_tpu.golden import golden_backproject, golden_fdk
from paris_tpu.ops.backprojection_gpu import TXY, TZ, backproject_chunk_gpu
from paris_tpu.ops.backprojection_xla import backproject_chunk_xla, make_bp_grid


def _det(**kw) -> DetectorGeometry:
    base = dict(n_row=96, n_col=80, l_px_row=2.0, l_px_col=2.0,
                delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0,
                delta_phi=2.0)
    base.update(kw)
    return DetectorGeometry(**base)


def _angles(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.0, 360.0, n).astype(
        np.float32)


def _both(det, vol, projs, angles, block, *, z_offset=0, roi=(0, 0, 0),
          base=None):
    """(kernel, XLA op) results for one chunk into one block."""
    grid = make_bp_grid(det, vol)
    phi = jnp.deg2rad(jnp.asarray(angles))
    sin, cos = jnp.sin(phi), jnp.cos(phi)
    v0 = jnp.zeros(block, jnp.float32) if base is None else jnp.asarray(base)
    p = jnp.asarray(projs)
    ref = backproject_chunk_xla(v0, p, sin, cos, grid, z_offset=z_offset,
                                roi_offset=roi)
    offs = jnp.asarray([roi[0], roi[1], roi[2] + z_offset], jnp.int32)
    out = backproject_chunk_gpu(v0, p, sin, cos, grid, offs, interpret=True)
    return np.asarray(out), np.asarray(ref)


def _assert_close(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    peak = float(np.abs(ref).max())
    assert peak > 0
    rel = float(np.sqrt(np.mean((out.astype(np.float64) - ref) ** 2))) / peak
    assert rel <= 1e-5, f"rel RMSE {rel:.2e}"
    assert float(np.abs(out - ref).max()) <= 1e-4 * peak


def _parity(seed, det_kw, n, block=None, z_offset=0, roi=(0, 0, 0),
            accumulate=False):
    """Kernel vs XLA op for n random projections into one block
    (``block`` None = the full volume)."""
    det = _det(**det_kw)
    vol = derive_volume_geometry(det)
    block = block or vol.shape_zyx
    rng = np.random.default_rng(seed)
    projs = rng.standard_normal((n, det.n_col, det.n_row)).astype(np.float32)
    base = (rng.standard_normal(block).astype(np.float32)
            if accumulate else None)
    out, ref = _both(det, vol, projs, _angles(n, seed + 1), block,
                     z_offset=z_offset, roi=roi, base=base)
    _assert_close(out, ref)


def test_pallas_matches_xla():
    """BASELINE config 1 geometry: 64^2 detector, 64^3 volume."""
    _parity(7, dict(n_row=64, n_col=64), 4)


def test_pallas_accumulates_into_existing():
    _parity(8, {}, 3, accumulate=True)


def test_pallas_z_offset_roi():
    _parity(9, {}, 3, block=(16, 40, 52), z_offset=24, roi=(5, 3, 2))


def test_pallas_offset_detector():
    """Nonzero delta_s/delta_t (offset detector, doc/roi_* cases)."""
    _parity(10, dict(delta_s=4.6, delta_t=-2.0), 3)


# name -> (seed, detector overrides, n_proj, block, z_offset, roi offset)
MORE_CASES = {
    "ragged_non_pow2": (11, dict(n_row=50, n_col=41), 5, (13, 37, 29), 7,
                        (3, 5, 0)),
    "single_projection": (12, {}, 1, (9, 96, 96), 30, (0, 0, 0)),
    "odd_chunk": (13, {}, 9, (8, 96, 96), 40, (0, 0, 0)),
    "wide_fan": (14, dict(n_row=64, n_col=64, d_so=68.0, d_od=60.0), 4,
                 None, 0, (0, 0, 0)),
}


@pytest.mark.parametrize("case", list(MORE_CASES), ids=list(MORE_CASES))
def test_kernel_matches_xla(case):
    seed, kw, n, block, z_offset, roi = MORE_CASES[case]
    _parity(seed, kw, n, block=block, z_offset=z_offset, roi=roi)


def test_kernel_zero_padded_chunk_tail():
    """Zero frames padding a chunk tail add exactly nothing: a 2+2
    padded chunk equals the 2 real frames alone."""
    det = _det()
    vol = derive_volume_geometry(det)
    rng = np.random.default_rng(3)
    real = rng.standard_normal((2, det.n_col, det.n_row)).astype(np.float32)
    padded = np.concatenate([real, np.zeros_like(real)])
    angles = np.asarray([10.0, 75.0, 0.0, 0.0], np.float32)
    block = (12, vol.dim_y, vol.dim_x)
    out_pad, _ = _both(det, vol, padded, angles, block, z_offset=20)
    out_real, ref = _both(det, vol, real, angles[:2], block, z_offset=20)
    np.testing.assert_array_equal(out_pad, out_real)
    _assert_close(out_real, ref)


# (dz, ny, nx) blocks against the fixed (TZ, TXY) tile: smaller than
# one tile, one past a tile in each dimension, an exact multiple, and
# rows that straddle xy tiles
RAGGED_BLOCKS = {
    "below_one_tile": (TZ - 5, 3, 7),
    "one_past_tile": (TZ + 1, 1, TXY + 1),
    "exact_multiple": (2 * TZ, 4, TXY // 4),
    "rows_straddle_tiles": (TZ - 1, 9, 29),
    "single_slice": (1, 23, 19),
}


@pytest.mark.parametrize("block", list(RAGGED_BLOCKS.values()),
                         ids=list(RAGGED_BLOCKS))
def test_kernel_ragged_block_masks(block):
    """Load/store masks at the block's ragged edges: the XLA result on
    blocks that the tile does and does not divide."""
    det = _det(n_row=50, n_col=41)
    vol = derive_volume_geometry(det)
    rng = np.random.default_rng(11)
    projs = rng.standard_normal((3, det.n_col, det.n_row)).astype(np.float32)
    out, ref = _both(det, vol, projs, _angles(3, 12), block,
                     z_offset=9, roi=(4, 2, 0))
    _assert_close(out, ref)


@pytest.mark.parametrize("edge", ("h_low", "h_high", "v_low", "v_high"))
def test_kernel_border_zero_at_each_detector_edge(edge):
    """A sample with any bilinear corner off the detector is zero (the
    reference's border rule); one just inside is not — checked per
    detector edge against the NumPy oracle."""
    det = _det(n_row=48, n_col=40)
    # enlarged volume (1.6x the reconstructable one): at phi = 0 its
    # samples cross every detector edge
    base = derive_volume_geometry(det)
    big = VolumeGeometry(dim_x=int(base.dim_x * 1.6),
                         dim_y=int(base.dim_y * 1.6),
                         dim_z=int(base.dim_z * 1.6),
                         l_vx_x=base.l_vx_x, l_vx_y=base.l_vx_y,
                         l_vx_z=base.l_vx_z)
    ones = np.ones((1, det.n_col, det.n_row), np.float32)
    out, _ = _both(det, big, ones, np.zeros(1, np.float32), big.shape_zyx)
    gold = golden_backproject(np.zeros(big.shape_zyx, np.float32), ones[0],
                              0.0, det, big)
    np.testing.assert_allclose(out, gold, rtol=1e-5, atol=1e-6)

    # detector coordinates of every voxel at phi = 0 (s = x, t = y)
    def centered(n, l):
        return -(n * l) / 2.0 + l / 2.0 + np.arange(n) * l
    xs = centered(big.dim_x, big.l_vx_x)
    ys = centered(big.dim_y, big.l_vx_y)
    zs = centered(big.dim_z, big.l_vx_z)
    factor = np.broadcast_to(det.d_sd / (xs[None, :] + det.d_so),
                             (big.dim_y, big.dim_x))
    h = (ys[:, None] * factor + det.n_row * det.l_px_row / 2.0) \
        / det.l_px_row - 0.5
    v = (zs[:, None, None] * factor[None] + det.n_col * det.l_px_col / 2.0) \
        / det.l_px_col - 0.5                                      # (z, y, x)
    h = np.broadcast_to(h[None], v.shape)
    h1, v1 = np.floor(h), np.floor(v)
    inside_h = (h1 >= 0) & (h1 + 1 < det.n_row)
    inside_v = (v1 >= 0) & (v1 + 1 < det.n_col)
    beyond, edge_in = {
        "h_low": (h1 < 0, inside_v & (h1 == 0)),
        "h_high": (h1 + 1 >= det.n_row, inside_v & (h1 == det.n_row - 2)),
        "v_low": (v1 < 0, inside_h & (v1 == 0)),
        "v_high": (v1 + 1 >= det.n_col, inside_h & (v1 == det.n_col - 2)),
    }[edge]
    assert beyond.any() and edge_in.any()
    assert np.all(out[beyond] == 0.0)
    assert np.all(out[edge_in] > 0.0)


def test_kernel_wide_fan_reconstruction_matches_golden():
    """A wide-fan geometry (source 68 mm from the axis) through the full
    chain with the kernel meets the 1e-3 gate against the oracle."""
    from paris_tpu.phantom import cone_beam_project
    from paris_tpu.pipeline import Reconstructor
    det = _det(n_row=64, n_col=64, d_so=68.0, d_od=60.0)
    vol = derive_volume_geometry(det)
    angles = np.arange(0, 180, 4, dtype=np.float32) * 2.0
    scale = vol.dim_x * vol.l_vx_x / 2.0 * 0.9
    projs = cone_beam_project(det, angles, scale_mm=scale)
    rec = Reconstructor(det, vol, chunk_size=16, backend="gpu",
                        interpret=True)
    ours = rec.run(projs, angles)
    golden = golden_fdk(projs, angles, det, vol)
    rel = float(np.sqrt(np.mean((ours - golden) ** 2))
                / np.abs(golden).max())
    assert rel <= 1e-3, f"relative RMSE {rel:.2e} > 1e-3"


def test_kernel_without_gpu_raises():
    """Compiling the kernel for a GPU that is not there fails loudly —
    no silent interpreter or XLA fallback."""
    det = _det()
    vol = derive_volume_geometry(det)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        backproject_chunk_gpu(
            jnp.zeros((8, vol.dim_y, vol.dim_x)),
            jnp.zeros((1, det.n_col, det.n_row)), jnp.zeros(1),
            jnp.ones(1), make_bp_grid(det, vol),
            jnp.zeros(3, jnp.int32))


def test_kernel_rejects_mismatched_projections():
    det = _det()
    vol = derive_volume_geometry(det)
    with pytest.raises(ValueError, match="do not match the detector"):
        backproject_chunk_gpu(
            jnp.zeros((8, vol.dim_y, vol.dim_x)),
            jnp.zeros((1, det.n_row, det.n_col)), jnp.zeros(1),
            jnp.ones(1), make_bp_grid(det, vol),
            jnp.zeros(3, jnp.int32), interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu():
    """The kernel as compiled for the card (no interpreter)."""
    det = _det(n_row=50, n_col=41, delta_s=2.5)
    vol = derive_volume_geometry(det)
    grid = make_bp_grid(det, vol)
    rng = np.random.default_rng(5)
    projs = jnp.asarray(rng.standard_normal((8, det.n_col, det.n_row)),
                        jnp.float32)
    phi = jnp.deg2rad(jnp.asarray(_angles(8, 6)))
    sin, cos = jnp.sin(phi), jnp.cos(phi)
    v0 = jnp.zeros(vol.shape_zyx, jnp.float32)
    ref = backproject_chunk_xla(v0, projs, sin, cos, grid)
    out = jax.jit(backproject_chunk_gpu, static_argnums=(4,))(
        v0, projs, sin, cos, grid, jnp.zeros(3, jnp.int32))
    _assert_close(np.asarray(out), np.asarray(ref))
