"""bench.py's helpers, which chip_smoke.py shares: scan synthesis, CLI
timing, the end-to-end rounds and the step rate — and the stream
timing log lines of the reconstruction loops that those runs report."""

import json
import logging
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402

SIZE = 16
N_PROJ = 24


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    return bench.write_scan(str(tmp_path_factory.mktemp("scan")), SIZE,
                            n_proj=N_PROJ)


def test_write_scan_is_config3_class(scan):
    from paris_tpu.io.geometry_file import load_geometry_file
    from paris_tpu.io.source import ProjectionSource
    assert scan.det.n_row == scan.det.n_col == SIZE
    assert scan.vol.dim_x == scan.vol.dim_y == scan.vol.dim_z
    assert abs(scan.vol.dim_x - SIZE) <= SIZE // 4       # volume ~size^3
    assert load_geometry_file(scan.geo) == scan.det
    frames = list(ProjectionSource(scan.proj_dir,
                                   delta_phi=scan.det.delta_phi))
    assert len(frames) == N_PROJ
    np.testing.assert_allclose([p.phi for p in frames],
                               np.arange(N_PROJ) * 360.0 / N_PROJ)
    assert all(np.isfinite(p.data).all() for p in frames)
    assert max(float(np.abs(p.data).max()) for p in frames) > 0


@pytest.mark.parametrize("distributed", [False, True],
                         ids=["one_device", "distributed"])
def test_time_cli_logs_stream_split(scan, tmp_path, caplog, distributed):
    """A timed CLI run writes its volume and logs the first chunk's read
    vs first step (compile) and each streamed block's input wait."""
    caplog.set_level(logging.INFO)
    out = tmp_path / "out"
    wall = bench.time_cli(
        ["--geometry", scan.geo, "--input", scan.proj_dir,
         "--output", str(out), "--block-dz", "8"]
        + (["--distributed"] if distributed else []))
    assert wall > 0
    assert (out / "vol.ddbvf").exists()
    msgs = [r.getMessage() for r in caplog.records]
    first = [m for m in msgs if m.startswith("first chunk: read + staged")]
    assert len(first) == 1 and "first step (compile/load + run)" in first[0]
    assert any(m.startswith("block 0 stream:") and
               "waiting for staged input" in m for m in msgs)


def test_time_cli_raises_on_failed_run(tmp_path):
    with pytest.raises(RuntimeError, match="returned"):
        bench.time_cli(["--geometry", str(tmp_path / "missing.geo"),
                        "--input", str(tmp_path), "--output",
                        str(tmp_path / "out")])


def test_e2e_rounds_print_one_line_per_run(tmp_path, capsys):
    bench.e2e(["xla"], SIZE, 1, 8, str(tmp_path), n_proj=N_PROJ)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["run"] for x in lines] == [0, 1]           # order a, a
    for x in lines:
        assert x["metric"].startswith("config3_cli_wall_s_")
        assert x["metric"].endswith("_dz8_xla")
        assert x["unit"] == "s" and x["value"] > 0 and x["gupd_per_s"] > 0
    assert not any(p.startswith("out") for p in os.listdir(tmp_path))


def test_step_rate_fields_off_a_known_device():
    r = bench.step_rate("xla", SIZE, 8, 4)
    assert r["metric"].endswith("_dz8_c4_xla")
    assert r["unit"] == "Gupd/s/device" and r["value"] > 0
    assert r["step_ms"] > 0 and r["device_count"] >= 1
    assert r["vs_streaming_bound"] is None      # no published peak for CPU
