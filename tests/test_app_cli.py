"""End-to-end app driver + CLI tests (CPU, synthetic scan on disk)."""

import json
import os

import numpy as np
import pytest

from paris_tpu.cli import main as cli_main
from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu.io import ddbvf
from paris_tpu.io.geometry_file import dump_geometry_file
from paris_tpu.io.his import write_his
from paris_tpu.app import ReconstructionJob, run_job
from paris_tpu.phantom import cone_beam_project
from paris_tpu.pipeline import reconstruct


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan")
    det = DetectorGeometry(
        n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
        delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0, delta_phi=6.0,
    )
    vol = derive_volume_geometry(det)
    angles = np.arange(60, dtype=np.float32) * det.delta_phi
    scale = vol.dim_x * vol.l_vx_x / 2.0 * 0.9
    projs = cone_beam_project(det, angles, scale_mm=scale)

    pdir = root / "proj"
    pdir.mkdir()
    for i in range(0, 60, 15):
        write_his(str(pdir / f"b{i:03d}.his"), projs[i:i + 15])
    gpath = root / "scan.geo"
    dump_geometry_file(det, str(gpath))
    return dict(root=root, det=det, vol=vol, projs=projs, angles=angles,
                pdir=str(pdir), gpath=str(gpath))


def test_run_job_single_block(scan, tmp_path):
    det, vol = scan["det"], scan["vol"]
    job = ReconstructionJob(
        det=det, input_path=scan["pdir"], output_path=str(tmp_path),
        prefix="v1", chunk_size=16, backend="xla",
    )
    out = run_job(job)
    assert ddbvf.open_meta(out) == (vol.dim_x, vol.dim_y, vol.dim_z)
    got = ddbvf.read_volume(out)
    ref = reconstruct(det, vol, scan["projs"], scan["angles"],
                      chunk_size=16, backend="xla")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_run_job_multi_block_matches_single(scan, tmp_path):
    det, vol = scan["det"], scan["vol"]
    slice_bytes = 4 * vol.dim_x * vol.dim_y
    job = ReconstructionJob(
        det=det, input_path=scan["pdir"], output_path=str(tmp_path),
        prefix="v2", chunk_size=16, backend="xla",
        hbm_budget_bytes=slice_bytes * 24 + 4 * (4 * 64 * 64) * 16,  # ~24-slice blocks
    )
    out = run_job(job)
    got = ddbvf.read_volume(out)
    ref = reconstruct(det, vol, scan["projs"], scan["angles"],
                      chunk_size=16, backend="xla")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_run_job_resume_skips_done_blocks(scan, tmp_path, caplog):
    det, vol = scan["det"], scan["vol"]
    slice_bytes = 4 * vol.dim_x * vol.dim_y
    kw = dict(
        det=det, input_path=scan["pdir"], output_path=str(tmp_path),
        prefix="v3", chunk_size=16, backend="xla",
        hbm_budget_bytes=slice_bytes * 24 + 4 * (4 * 64 * 64) * 16,
    )
    out = run_job(ReconstructionJob(**kw))
    manifest = json.load(open(out + ".manifest.json"))
    n_blocks = len(manifest["completed_blocks"])
    assert n_blocks >= 2

    # resume on a complete output: every block skipped
    import logging
    with caplog.at_level(logging.INFO):
        run_job(ReconstructionJob(**kw, resume=True))
    assert sum("skipping" in r.message for r in caplog.records) == n_blocks


def test_run_job_quality(scan, tmp_path):
    det, vol = scan["det"], scan["vol"]
    job = ReconstructionJob(
        det=det, input_path=scan["pdir"], output_path=str(tmp_path),
        prefix="vq", chunk_size=16, backend="xla", quality=2,
    )
    out = run_job(job)
    got = ddbvf.read_volume(out)
    ref = reconstruct(det, vol, scan["projs"][::2], scan["angles"][::2],
                      chunk_size=16, backend="xla")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ CLI

def test_cli_geometry_format(capsys):
    assert cli_main(["--geometry-format"]) == 0
    assert "n_row" in capsys.readouterr().out


def test_cli_dry_run(scan):
    assert cli_main(["--geometry", scan["gpath"]]) == 0


def test_cli_missing_geometry():
    assert cli_main([]) == 2


def test_cli_io_pair_enforced(scan, capsys):
    rc = cli_main(["--geometry", scan["gpath"], "--input", scan["pdir"]])
    assert rc == 2
    assert "--output" in capsys.readouterr().err


def test_cli_roi_requires_coords(scan, capsys):
    rc = cli_main(["--geometry", scan["gpath"], "--roi", "--roi-x1", "0"])
    assert rc == 2
    assert "roi" in capsys.readouterr().err


def test_cli_full_reconstruction(scan, tmp_path):
    rc = cli_main([
        "--geometry", scan["gpath"],
        "--input", scan["pdir"],
        "--output", str(tmp_path),
        "--name", "clivol",
        "--backend", "xla",
        "--chunk-size", "16",
    ])
    assert rc == 0
    det, vol = scan["det"], scan["vol"]
    assert ddbvf.open_meta(str(tmp_path / "clivol.ddbvf")) == \
        (vol.dim_x, vol.dim_y, vol.dim_z)


def test_cli_roi_reconstruction(scan, tmp_path):
    det, vol = scan["det"], scan["vol"]
    rc = cli_main([
        "--geometry", scan["gpath"],
        "--input", scan["pdir"],
        "--output", str(tmp_path),
        "--name", "roivol",
        "--backend", "xla",
        "--roi",
        "--roi-x1", "10", "--roi-x2", "29",
        "--roi-y1", "12", "--roi-y2", "31",
        "--roi-z1", "4", "--roi-z2", "23",
    ])
    assert rc == 0
    got = ddbvf.read_volume(str(tmp_path / "roivol.ddbvf"))
    assert got.shape == (20, 20, 20)
    full = reconstruct(det, vol, scan["projs"], scan["angles"],
                       chunk_size=16, backend="xla")
    np.testing.assert_allclose(got, full[4:24, 12:32, 10:30],
                               rtol=1e-4, atol=1e-4)


def test_two_tier_exceptions(tmp_path):
    """Construction vs runtime failures map to the reference's two tiers
    (src/exception.h:31-41, src/main.cpp:181-192)."""
    import pytest
    from paris_tpu import (ParisError, StageConstructionError,
                           StageRuntimeError)
    from paris_tpu.app import ReconstructionJob, run_job
    from paris_tpu.geometry import DetectorGeometry

    det = DetectorGeometry(32, 32, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 3.0)
    # unwritable sink path -> construction tier
    job = ReconstructionJob(det=det, input_path=str(tmp_path),
                            output_path="/proc/nope/denied", backend="xla")
    with pytest.raises(StageConstructionError):
        run_job(job)
    # a failure mid-stream (unreadable input dir) -> runtime tier
    job2 = ReconstructionJob(det=det, input_path=str(tmp_path / "missing"),
                             output_path=str(tmp_path), backend="xla")
    with pytest.raises(ParisError):
        run_job(job2)
    # both are catchable via the stdlib bases too
    assert issubclass(StageConstructionError, ValueError)
    assert issubclass(StageRuntimeError, RuntimeError)


def test_run_job_auto_hbm_budget(scan, tmp_path, monkeypatch, caplog):
    """With no explicit budget, the planner derives one from device
    memory stats and splits the volume (reference analog:
    cuda/subvolume_information.cpp memory probe)."""
    import logging
    import paris_tpu.app as app_mod
    det, vol = scan["det"], scan["vol"]
    slice_bytes = 4 * vol.dim_x * vol.dim_y
    fake_budget = slice_bytes * 24 + 4 * (4 * 64 * 64) * 16
    monkeypatch.setattr(app_mod, "_auto_hbm_budget", lambda: fake_budget)
    job = ReconstructionJob(
        det=det, input_path=scan["pdir"], output_path=str(tmp_path),
        prefix="vauto", chunk_size=16, backend="xla",
    )
    with caplog.at_level(logging.INFO, logger="paris_tpu.app"):
        out = run_job(job)
    assert "auto HBM budget" in caplog.text
    # budget forces >1 block, and the result still matches single-block
    assert any("z-split: 3 block(s)" in m or "z-split: 2 block(s)" in m
               for m in caplog.messages)
    got = ddbvf.read_volume(out)
    ref = reconstruct(det, vol, scan["projs"], scan["angles"],
                      chunk_size=16, backend="xla")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_auto_hbm_budget_no_stats(monkeypatch):
    """Platforms without memory stats fall back to a single block."""
    import paris_tpu.app as app_mod

    class Dev:
        def memory_stats(self):
            return None

    import jax
    monkeypatch.setattr(jax, "local_devices", lambda: [Dev()])
    assert app_mod._auto_hbm_budget() is None

    class Dev2:
        def memory_stats(self):
            return {"bytes_limit": 16 << 30, "bytes_in_use": 1 << 30}

    monkeypatch.setattr(jax, "local_devices", lambda: [Dev2()])
    budget = app_mod._auto_hbm_budget()
    assert budget == int((15 << 30) * 0.45)


def test_planner_error_is_construction_tier(scan, tmp_path):
    """Planner ValueErrors (bad forced block extent, impossible HBM
    budget) are construction-phase failures -> StageConstructionError,
    matching the reference's split (src/exception.h:31-41)."""
    import pytest
    from paris_tpu import StageConstructionError
    from paris_tpu.app import ReconstructionJob, run_job

    job = ReconstructionJob(det=scan["det"], input_path=scan["pdir"],
                            output_path=str(tmp_path), backend="xla",
                            block_dz=0)
    with pytest.raises(StageConstructionError):
        run_job(job)
    job2 = ReconstructionJob(det=scan["det"], input_path=scan["pdir"],
                             output_path=str(tmp_path), backend="xla",
                             hbm_budget_bytes=1)
    with pytest.raises(StageConstructionError):
        run_job(job2)


def test_cache_projections_true_honored_single_block(scan, tmp_path,
                                                     monkeypatch):
    """cache_projections=True collects even for a single-block run."""
    import paris_tpu.app as app_mod
    seen = {}
    orig_concat = app_mod.np.concatenate

    def spy_concat(arrs, *a, **k):
        seen["called"] = True
        return orig_concat(arrs, *a, **k)

    monkeypatch.setattr(app_mod.np, "concatenate", spy_concat)
    job = app_mod.ReconstructionJob(
        det=scan["det"], input_path=scan["pdir"],
        output_path=str(tmp_path), backend="xla", cache_projections=True)
    app_mod.run_job(job)
    assert seen.get("called"), "explicit cache_projections=True ignored"


def test_overlap_block_dz_2048_class():
    """With 12 GiB free per device the 2048 volume's 416-slice extent
    (6.5 GiB accumulator) cannot hold two accumulators; the overlap
    adjuster drops to the largest extent whose unpadded pair fits
    (368 slices), and leaves fitting extents alone."""
    from paris_tpu.app import _overlap_block_dz, _block_hbm_bytes
    from paris_tpu.geometry import VolumeGeometry
    vol = VolumeGeometry(dim_x=2048, dim_y=2048, dim_z=2055,
                         l_vx_x=1.0, l_vx_y=1.0, l_vx_z=1.0)
    free = 12 << 30
    proj = 512 << 20
    dz2 = _overlap_block_dz(vol, free, proj, 416)
    assert dz2 == 368
    assert 2 * _block_hbm_bytes(vol, dz2) + proj <= free
    assert 2 * _block_hbm_bytes(vol, dz2 + 8) + proj > free
    # an extent already fitting two accumulators is left alone
    assert _overlap_block_dz(vol, free, proj, 256) is None


def test_overlap_free_est_user_budget_not_inverted(monkeypatch):
    """A USER-supplied --hbm-budget-gb is an absolute cap: without live
    memory stats the overlap gate must stay within it, NOT invert it
    through the auto 45%-of-free formula (that fabricated ~2x the
    device's memory and let the two-accumulator overlap OOM)."""
    import paris_tpu.app as app
    monkeypatch.setattr(app, "_free_hbm_bytes", lambda: None)
    budget = 14 << 30
    assert app._overlap_free_est(budget, budget_is_auto=False) == budget
    # the auto budget (45% of free) is legitimately invertible
    auto = app._overlap_free_est(budget, budget_is_auto=True)
    assert auto == int(budget / 0.45 * 0.95)
    # no budget info at all -> no constraint (overlap allowed)
    assert app._overlap_free_est(None, budget_is_auto=True) is None
    # live stats win over any inversion
    monkeypatch.setattr(app, "_free_hbm_bytes", lambda: 10 << 30)
    assert app._overlap_free_est(budget, budget_is_auto=False) == \
        int((10 << 30) * 0.95)
