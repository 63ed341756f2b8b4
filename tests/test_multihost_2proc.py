"""Real 2-process jax.distributed runs on CPU (SURVEY.md §4(e)).

The reference fanned work across devices of ONE process
(src/main.cpp:157-169); our multi-host design is SPMD over processes, which
single-process tests cannot exercise: a globally-sharded array's
non-addressable shards only exist multi-process.  These tests spawn two
real Python processes with ``jax.distributed.initialize`` against a
local coordinator (2 virtual CPU devices each -> a 4-device global
mesh) and verify the end-to-end output byte-compares against a
single-process reconstruction of the same scan.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mh_worker.py")

DET_KW = dict(n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
              delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0,
              delta_phi=22.5)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers(cfg_base, num_processes=2, timeout=300):
    """Launch the worker once per process id; assert all succeed."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count="
        f"{cfg_base['local_devices']}")
    procs = []
    for pid in range(num_processes):
        cfg = dict(cfg_base, process_id=pid)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, json.dumps(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"worker {pid} failed (rc={p.returncode})\n"
            f"--- stdout ---\n{out}\n--- stderr ---\n{err[-4000:]}")
        assert "WORKER-OK" in out, f"worker {pid} did not complete: {out}"
    return [out for out, _ in outs]


def test_two_process_e2e_matches_single_process(tmp_path):
    """Full distributed job on 2 processes == single-process run_job.

    Exercises: sink create/attach barrier, per-process z-shard writes at
    global offsets (multihost.write_local_shards), manifest marking, and
    the make_array_from_callback input path.
    """
    from paris_tpu.geometry import DetectorGeometry
    from paris_tpu.io.his import write_his
    from paris_tpu.io import ddbvf
    from paris_tpu.app import ReconstructionJob, run_job

    det = DetectorGeometry(**DET_KW)
    n_proj = 16
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 60000,
                         (n_proj, det.n_col, det.n_row)).astype(np.uint16)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, n_proj, 8):
        write_his(str(pdir / f"b{i:04d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)

    # single-process reference with the same z-split (2 blocks of 32)
    ref_path = run_job(ReconstructionJob(
        det=det, input_path=str(pdir), output_path=str(tmp_path / "ref"),
        prefix="v", chunk_size=8, backend="xla", block_dz=32))

    out_dir = tmp_path / "mh"
    outs = _spawn_workers({
        "mode": "e2e_xla",
        "coordinator": f"127.0.0.1:{_free_port()}",
        "num_processes": 2,
        "local_devices": 2,
        "repo": REPO,
        "det": DET_KW,
        "input": str(pdir),
        "output": str(out_dir),
        "prefix": "v",
        "chunk": 8,
        "block_dz": 32,
    })

    ref = ddbvf.read_volume(ref_path)
    got = ddbvf.read_volume(str(out_dir / "v.ddbvf"))
    np.testing.assert_array_equal(got, ref)
    # manifest records both blocks complete (written by process 0)
    with open(str(out_dir / "v.ddbvf.manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["completed_blocks"] == [0, 1]
    # disjoint input: each process pixel-decoded exactly its half of
    # the stream, once (the second block reused the host-side cache)
    decoded = [int(o.split("DECODE-FRAMES=")[1].split()[0]) for o in outs]
    assert decoded == [n_proj // 2, n_proj // 2], decoded


def test_two_process_kernel_shard_writes(tmp_path):
    """The GPU kernel branch (emulated) z-sharded over a 2-process mesh:
    per-process shard writes reassemble the volume a single-process
    run of the same kernel produces."""
    from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
    from paris_tpu.io import ddbvf
    from paris_tpu.pipeline import Reconstructor

    det = DetectorGeometry(**DET_KW)
    vol = derive_volume_geometry(det)
    chunk = 8
    block_dz = -(-vol.dim_z // 4) * 4          # divisible by the 4 devices

    # single-process reference: same kernel, interpret mode, one device
    rec = Reconstructor(det, vol, chunk_size=chunk, backend="gpu",
                        interpret=True)
    rng = np.random.default_rng(7)       # matches the worker's seed
    projs = rng.standard_normal(
        (chunk, det.n_col, det.n_row)).astype(np.float32)
    angles = np.arange(chunk, dtype=np.float32) * det.delta_phi
    ref = rec.run(projs, angles)

    path = str(tmp_path / "p.ddbvf")
    ddbvf.create(path, vol.dim_x, vol.dim_y, vol.dim_z)
    _spawn_workers({
        "mode": "kernel_shards",
        "coordinator": f"127.0.0.1:{_free_port()}",
        "num_processes": 2,
        "local_devices": 2,
        "repo": REPO,
        "det": DET_KW,
        "ddbvf": path,
        "chunk": chunk,
        "block_dz": block_dz,
    })

    got = ddbvf.read_volume(path)
    np.testing.assert_allclose(got, ref[:vol.dim_z], rtol=0, atol=1e-5)


def test_cli_two_process_launch(tmp_path):
    """`paris-tpu --distributed --coordinator ... --num-processes 2
    --process-id i` actually launches a multi-host job (VERDICT round 2:
    the CLI previously could not start one).  Output must byte-compare
    against a single-process run of the same scan."""
    import paris_tpu  # noqa: F401  (repo importability for the workers)
    from paris_tpu.geometry import DetectorGeometry
    from paris_tpu.io.his import write_his
    from paris_tpu.io.geometry_file import dump_geometry_file
    from paris_tpu.io import ddbvf
    from paris_tpu.app import ReconstructionJob, run_job

    det = DetectorGeometry(**DET_KW)
    n_proj = 16
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 60000,
                         (n_proj, det.n_col, det.n_row)).astype(np.uint16)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, n_proj, 8):
        write_his(str(pdir / f"b{i:04d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)
    gpath = tmp_path / "scan.geo"
    dump_geometry_file(det, str(gpath))

    ref_path = run_job(ReconstructionJob(
        det=det, input_path=str(pdir), output_path=str(tmp_path / "ref"),
        prefix="v", chunk_size=8, backend="xla", block_dz=32))

    out_dir = tmp_path / "mh"
    coord = f"127.0.0.1:{_free_port()}"
    argv = ["--geometry", str(gpath), "--input", str(pdir),
            "--output", str(out_dir), "--name", "v", "--backend", "xla",
            "--chunk-size", "8", "--block-dz", "32", "--distributed",
            "--coordinator", coord, "--num-processes", "2"]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    worker = os.path.join(REPO, "tests", "_cli_mh_worker.py")
    procs = []
    for pid in range(2):
        cfg = {"repo": REPO, "local_devices": 2, "argv": argv,
               "process_id": pid}
        procs.append(subprocess.Popen(
            [sys.executable, worker, json.dumps(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"CLI worker {pid} failed (rc={p.returncode})\n"
            f"--- stdout ---\n{out}\n--- stderr ---\n{err[-4000:]}")
        assert "WORKER-OK" in out

    ref = ddbvf.read_volume(ref_path)
    got = ddbvf.read_volume(str(out_dir / "v.ddbvf"))
    np.testing.assert_array_equal(got, ref)


def test_cli_distributed_flags_require_distributed(capsys):
    from paris_tpu.cli import main as cli_main
    rc = cli_main(["--geometry", "x.geo", "--coordinator", "h:1"])
    assert rc == 2
    assert "--distributed" in capsys.readouterr().err


def test_cli_process_id_zero_requires_distributed(capsys):
    """--process-id 0 (the most common id) must hit the same validation
    as id 1 — the old truthiness check let 0 slip through silently."""
    from paris_tpu.cli import main as cli_main
    rc = cli_main(["--geometry", "x.geo", "--process-id", "0"])
    assert rc == 2
    assert "--distributed" in capsys.readouterr().err
    rc = cli_main(["--geometry", "x.geo", "--num-processes", "0"])
    assert rc == 2
