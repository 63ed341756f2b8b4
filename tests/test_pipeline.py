"""Pipeline plumbing: backend resolution (no silent fallback), staging,
the compiled-step cache, the compile-cache directory, the device memory
model, the native library build, and the GPU smoke script off the GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import pytest

from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _det() -> DetectorGeometry:
    return DetectorGeometry(64, 64, 2.0, 2.0, 0.0, 0.0, 500.0, 500.0, 6.0)


# -- backend resolution -------------------------------------------------

@pytest.mark.parametrize("backend,interpret,expect", [
    ("auto", False, "xla"),        # CPU: auto never picks the kernel
    ("xla", False, "xla"),
    ("gpu", True, "gpu"),          # explicit emulation is allowed
    ("gpu", False, ValueError),    # no GPU: refuse, do not fall back
    ("pallas", False, ValueError),
])
def test_resolve_backend(backend, interpret, expect):
    from paris_tpu.pipeline import resolve_backend
    assert jax.default_backend() == "cpu"
    if isinstance(expect, type):
        with pytest.raises(expect):
            resolve_backend(backend, interpret)
    else:
        assert resolve_backend(backend, interpret) == expect


def test_reconstructor_gpu_backend_without_gpu_raises():
    from paris_tpu.pipeline import Reconstructor
    det = _det()
    with pytest.raises(ValueError, match="needs a GPU"):
        Reconstructor(det, derive_volume_geometry(det), backend="gpu")


def test_run_job_gpu_backend_without_gpu_is_construction_error(tmp_path):
    from paris_tpu.app import ReconstructionJob, run_job
    from paris_tpu.exceptions import StageConstructionError
    with pytest.raises(StageConstructionError, match="needs a GPU"):
        run_job(ReconstructionJob(det=_det(), input_path=str(tmp_path),
                                  output_path=str(tmp_path / "o"),
                                  backend="gpu"))


def test_cli_gpu_backend_without_gpu_fails(tmp_path, capsys):
    from paris_tpu.cli import main
    from paris_tpu.io.geometry_file import dump_geometry_file
    geo = str(tmp_path / "scan.geo")
    dump_geometry_file(_det(), geo)
    (tmp_path / "proj").mkdir()
    rc = main(["--geometry", geo, "--input", str(tmp_path / "proj"),
               "--output", str(tmp_path / "out"), "--backend", "gpu"])
    assert rc == 1
    assert "needs a GPU" in capsys.readouterr().err


def test_gpu_kernel_reconstructor_matches_xla():
    """The kernel step (emulated) streams a ragged chunk tail and a z
    offset exactly as the XLA step does."""
    from paris_tpu.pipeline import Reconstructor
    det = _det()
    vol = derive_volume_geometry(det)
    rng = np.random.default_rng(2)
    projs = rng.standard_normal((11, det.n_col, det.n_row)).astype(np.float32)
    angles = np.arange(11, dtype=np.float32) * 31.0
    kw = dict(chunk_size=4, block_shape=(24, vol.dim_y, vol.dim_x))
    ref = Reconstructor(det, vol, backend="xla", **kw).run(
        projs, angles, z_offset=20)
    out = Reconstructor(det, vol, backend="gpu", interpret=True, **kw).run(
        projs, angles, z_offset=20)
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


# -- staging and the step cache -----------------------------------------

def test_stage_chunk_pads_tail_to_chunk_size():
    from paris_tpu.pipeline import Reconstructor
    det = _det()
    rec = Reconstructor(det, derive_volume_geometry(det), chunk_size=4,
                        backend="xla")
    data = np.ones((3, det.n_col, det.n_row), np.float32)
    chunk, sin, cos = rec.stage_chunk(data, [90.0, 180.0, 0.0])
    chunk = np.asarray(chunk)
    assert chunk.shape == (4, det.n_col, det.n_row)
    assert chunk.dtype == np.float32                 # staged lossless
    np.testing.assert_array_equal(chunk[3], 0.0)
    np.testing.assert_allclose(np.asarray(sin), [1.0, 0.0, 0.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(cos), [0.0, -1.0, 1.0, 1.0],
                               atol=1e-6)


def test_stage_stream_order_counts_and_errors():
    """stage_stream yields staged packs IN ORDER with true counts,
    runs the stage fn on worker threads, and propagates producer
    exceptions to the consumer."""
    from paris_tpu.pipeline import stage_stream
    import threading

    seen_threads = set()

    def stage(data, ang):
        seen_threads.add(threading.current_thread().name)
        return data * 2

    pairs = [(np.full(3, i), list(range(i + 1))) for i in range(7)]
    out = list(stage_stream(stage, iter(pairs), depth=3, workers=2))
    assert [int(s[0]) for s, _ in out] == [0, 2, 4, 6, 8, 10, 12]
    assert [n for _, n in out] == [1, 2, 3, 4, 5, 6, 7]
    assert all(t.startswith("paris-stage") for t in seen_threads)

    def bad_pairs():
        yield pairs[0]
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(stage_stream(stage, bad_pairs()))

    def bad_stage(data, ang):
        raise ValueError("stage died")

    with pytest.raises(ValueError, match="stage died"):
        list(stage_stream(bad_stage, iter(pairs)))


def test_step_cache_lru_bound(monkeypatch):
    """The in-process compiled-step cache is LRU-bounded
    (PARIS_STEP_CACHE_MAX): a service rotating geometries must not
    accumulate executables without limit; recently-touched keys survive
    eviction."""
    from paris_tpu import pipeline

    monkeypatch.setattr(pipeline, "_STEP_CACHE", __import__(
        "collections").OrderedDict())
    monkeypatch.setenv("PARIS_STEP_CACHE_MAX", "3")
    for i in range(3):
        pipeline._step_cache_put(("k", i), f"step{i}")
    assert pipeline._step_cache_get(("k", 0)) == "step0"   # refresh k0
    pipeline._step_cache_put(("k", 3), "step3")            # evicts k1 (LRU)
    assert set(pipeline._STEP_CACHE) == {("k", 0), ("k", 2), ("k", 3)}
    assert pipeline._step_cache_get(("k", 1)) is None


def test_step_cache_keys_on_backend_and_shape():
    """Same (geometry, config) shares one step; another backend or block
    shape gets its own."""
    from paris_tpu.pipeline import Reconstructor
    det = _det()
    vol = derive_volume_geometry(det)

    def build(**kw):
        return Reconstructor(det, vol, chunk_size=2, **kw)._step

    a = build(backend="xla")
    assert build(backend="xla") is a
    assert build(backend="gpu", interpret=True) is not a
    assert build(backend="xla", block_shape=(8, vol.dim_y, vol.dim_x)) \
        is not a


# -- persistent compile cache directory ----------------------------------

def test_compile_cache_honours_env(monkeypatch):
    from paris_tpu.utils import jax_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert jax_cache.enable_persistent_cache() == "/some/cache"
    assert calls == []                  # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from paris_tpu.utils import jax_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jax_cache.enable_persistent_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert jax_cache.enable_persistent_cache() == path     # never moves


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- device memory model --------------------------------------------------

def test_block_bytes_unpadded_accumulator():
    """The kernel path holds exactly the (dz, ny, nx) f32 block — no
    lane padding (the 1016x401 offset detector of doc/schaum.geo gives
    such ragged dims)."""
    from paris_tpu.app import _block_hbm_bytes
    from paris_tpu.geometry import VolumeGeometry
    vol = VolumeGeometry(dim_x=401, dim_y=401, dim_z=333,
                         l_vx_x=1.0, l_vx_y=1.0, l_vx_z=1.0)
    assert _block_hbm_bytes(vol, 37) == 4 * 37 * 401 * 401
    assert _block_hbm_bytes(vol, 37, "gpu") == 4 * 37 * 401 * 401


def test_block_bytes_xla_adds_slab_temporaries():
    from paris_tpu import app
    from paris_tpu.geometry import VolumeGeometry
    vol = VolumeGeometry(dim_x=1024, dim_y=1024, dim_z=1024,
                         l_vx_x=1.0, l_vx_y=1.0, l_vx_z=1.0)
    acc = 4 * 256 * 1024 * 1024
    assert app._block_hbm_bytes(vol, 256, "xla") == \
        acc + app._XLA_SLAB_TEMPS * app._XLA_SLAB_BYTES
    # a block smaller than one slab is bounded by its own size
    small = 4 * 8 * 1024 * 1024
    assert app._block_hbm_bytes(vol, 8, "xla") == \
        small * (1 + app._XLA_SLAB_TEMPS)


def test_auto_budget_assumes_no_size_for_statless_device(monkeypatch):
    """A device that reports no memory stats gets no budget (single
    whole-volume block) whatever its kind — no size table."""
    import paris_tpu.app as app_mod

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return {}

    monkeypatch.setattr(jax, "local_devices", lambda: [Dev()])
    assert app_mod._auto_hbm_budget() is None


# -- native I/O library built from source ----------------------------------

def test_native_library_path_keyed_by_source(tmp_path):
    from paris_tpu.io import native
    src = tmp_path / "paris_io.cpp"
    shutil.copy(os.path.join(REPO, "native", "paris_io.cpp"), src)
    a = native.built_library_path(str(src))
    assert os.path.dirname(a) == str(tmp_path / "build")
    with open(src, "a") as f:
        f.write("\n// edited\n")
    assert native.built_library_path(str(src)) != a


def test_native_library_builds_from_committed_source(tmp_path):
    import ctypes
    from paris_tpu.io import native
    src = tmp_path / "paris_io.cpp"
    shutil.copy(os.path.join(REPO, "native", "paris_io.cpp"), src)
    out = native.build_library(str(src))
    assert out == native.built_library_path(str(src))
    assert native.build_library(str(src)) == out          # built once
    lib = ctypes.CDLL(out)
    assert hasattr(lib, "paris_his_read")


def test_no_binary_tracked_in_native_dir():
    """Git tracks only the library's source under native/; the build
    directory is ignored.  Outside a git checkout (an exported tree holds
    exactly the tracked files) the tree itself is checked."""
    if os.path.isdir(os.path.join(REPO, ".git")) and shutil.which("git"):
        tracked = subprocess.run(
            ["git", "ls-files", "--cached", "--", "native"], cwd=REPO,
            capture_output=True, text=True, check=True).stdout.split()
        assert tracked == ["native/paris_io.cpp"]
        ignored = subprocess.run(
            ["git", "check-ignore", "-q", "native/build/libparis_io.so"],
            cwd=REPO)
        assert ignored.returncode == 0
    else:
        assert sorted(set(os.listdir(os.path.join(REPO, "native")))
                      - {"build"}) == ["paris_io.cpp"]


# -- the GPU smoke script refuses to run without a GPU ----------------------

def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_no_result(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    _assert_no_result(proc)
    assert "not on a GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    _assert_no_result(proc)
    assert "paris_tpu package is not next to chip_smoke.py" in proc.stderr
