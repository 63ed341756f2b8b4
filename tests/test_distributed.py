"""Distributed (shard_map) reconstruction vs single-device, on a virtual
8-device CPU mesh (SURVEY.md §4(d))."""

import numpy as np
import jax
import pytest

from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry
from paris_tpu.parallel import DistributedReconstructor, make_z_mesh
from paris_tpu.pipeline import reconstruct


@pytest.fixture(scope="module")
def setup():
    det = DetectorGeometry(
        n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
        delta_s=0.0, delta_t=0.0, d_so=400.0, d_od=400.0, delta_phi=9.0,
    )
    vol = derive_volume_geometry(det)
    rng = np.random.default_rng(0)
    n_proj = 24
    projs = rng.standard_normal((n_proj, det.n_col, det.n_row)).astype(np.float32)
    angles = np.arange(n_proj, dtype=np.float32) * det.delta_phi
    return det, vol, projs, angles


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_distributed_matches_single_device(setup):
    det, vol, projs, angles = setup
    mesh = make_z_mesh()
    n = mesh.devices.size
    block_dz = -(-vol.dim_z // n) * n

    dist = DistributedReconstructor(
        det, vol, mesh=mesh, chunk_size=8, block_dz=block_dz, backend="xla",
    )
    out_dist = dist.reconstruct(projs, angles)

    out_single = reconstruct(
        det, vol, projs, angles, chunk_size=8, backend="xla",
        block_shape=(block_dz, vol.dim_y, vol.dim_x),
    )[: vol.dim_z]

    np.testing.assert_allclose(out_dist, out_single, rtol=1e-5, atol=1e-5)


def test_distributed_rejects_bad_chunk(setup):
    det, vol, _, _ = setup
    with pytest.raises(ValueError):
        DistributedReconstructor(det, vol, chunk_size=3, block_dz=64, backend="xla")


def test_distributed_z_offset(setup):
    """Distributed block at z_offset must equal the matching slab of a
    single-device full reconstruction."""
    det, vol, projs, angles = setup
    mesh = make_z_mesh()
    n = mesh.devices.size

    full = reconstruct(det, vol, projs, angles, chunk_size=8, backend="xla")

    block_dz = 16
    assert block_dz % n == 0
    dist = DistributedReconstructor(
        det, vol, mesh=mesh, chunk_size=8, block_dz=block_dz, backend="xla",
    )
    z0 = 8
    out = np.asarray(
        dist.accumulate(dist.init_block(), projs, angles, z_offset=z0)
    )
    np.testing.assert_allclose(out, full[z0:z0 + block_dz], rtol=1e-5, atol=1e-5)


def test_distributed_pallas_matches_single(setup):
    """GPU kernel branch (z-sharded, interpret mode) == single device."""
    det, vol, projs, angles = setup
    mesh = make_z_mesh()
    n = mesh.devices.size
    dist = DistributedReconstructor(
        det, vol, mesh=mesh, chunk_size=8, block_dz=-(-vol.dim_z // n) * n,
        backend="gpu", interpret=True,
    )
    out = dist.reconstruct(projs[:8], angles[:8])
    ref = reconstruct(det, vol, projs[:8], angles[:8],
                      chunk_size=8, backend="xla")
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_local_block_slices_single_host(setup):
    """multihost helpers degenerate correctly on one process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paris_tpu.parallel.multihost import local_block_slices, is_multihost
    assert not is_multihost()
    mesh = make_z_mesh()
    vol = jax.device_put(
        jnp.arange(16 * 4 * 4, dtype=jnp.float32).reshape(16, 4, 4),
        NamedSharding(mesh, P("z", None, None)))
    slabs = sorted(local_block_slices(vol))
    assert [z for z, _ in slabs] == [0, 2, 4, 6, 8, 10, 12, 14]
    full = np.concatenate([d for _, d in slabs])
    np.testing.assert_array_equal(full, np.asarray(vol))


def test_write_local_shards(setup, tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paris_tpu.parallel.multihost import write_local_shards
    from paris_tpu.io import ddbvf
    mesh = make_z_mesh()
    rng = np.random.default_rng(3)
    data = rng.standard_normal((16, 4, 4)).astype(np.float32)
    vol = jax.device_put(jnp.asarray(data),
                         NamedSharding(mesh, P("z", None, None)))
    p = str(tmp_path / "mh.ddbvf")
    ddbvf.create(p, 4, 4, 30)
    n = write_local_shards(p, vol, z_base=5)
    assert n == 16
    np.testing.assert_array_equal(ddbvf.read_slices(p, 5, 16), data)


def test_crash_diagnostics_marker(setup, tmp_path, caplog):
    """Failure in a distributed stage names the process and drops a marker."""
    import logging
    from paris_tpu.parallel.multihost import crash_diagnostics
    with caplog.at_level(logging.ERROR, logger="paris_tpu.multihost"):
        with pytest.raises(RuntimeError, match="boom"):
            with crash_diagnostics("unit-test", str(tmp_path)):
                raise RuntimeError("boom")
    assert "process 0/1" in caplog.text
    marker = tmp_path / "crash.p0.log"
    assert marker.exists()
    text = marker.read_text()
    assert "RuntimeError: boom" in text and "stage: unit-test" in text


def test_run_job_distributed_caches_projections(setup, tmp_path, monkeypatch):
    """The HIS directory is read ONCE for N blocks (the reference
    re-scanned per task, SURVEY.md §3.2; single-chip driver already
    caches — this guards the distributed driver's cache)."""
    from paris_tpu.app import ReconstructionJob
    from paris_tpu.parallel.app import run_job_distributed
    from paris_tpu.io.his import write_his
    from paris_tpu.io import ddbvf
    import paris_tpu.io.source as source_mod

    det = DetectorGeometry(
        n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
        delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0, delta_phi=22.5,
    )
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 60000, (16, det.n_col, det.n_row)).astype(np.uint16)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, 16, 8):
        write_his(str(pdir / f"b{i:03d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)

    calls = {"n": 0}
    real = source_mod.read_his

    def counting(path):
        calls["n"] += 1
        return real(path)

    monkeypatch.setattr(source_mod, "read_his", counting)
    out = run_job_distributed(ReconstructionJob(
        det=det, input_path=str(pdir), output_path=str(tmp_path / "out"),
        prefix="vd", chunk_size=8, backend="xla", block_dz=32,
    ))
    assert calls["n"] == 2, f"HIS files read {calls['n']} times, expected 2"
    vol = derive_volume_geometry(det)
    assert ddbvf.open_meta(out) == (vol.dim_x, vol.dim_y, vol.dim_z)


def test_run_job_distributed_overlap_matches_serial(setup, tmp_path,
                                                    monkeypatch):
    """The finalize/write overlap (writer thread draining block k while
    k+1 reconstructs) must be a pure scheduling change: byte-identical
    output vs PARIS_WRITE_OVERLAP=0 (r4 verdict 3 driver parity)."""
    from paris_tpu.app import ReconstructionJob
    from paris_tpu.parallel.app import run_job_distributed
    from paris_tpu.io.his import write_his
    from paris_tpu.io import ddbvf

    det = DetectorGeometry(
        n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
        delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0, delta_phi=22.5,
    )
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 60000, (16, det.n_col, det.n_row)).astype(np.uint16)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, 16, 8):
        write_his(str(pdir / f"b{i:03d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)

    def run(outdir, overlap):
        monkeypatch.setenv("PARIS_WRITE_OVERLAP", "1" if overlap else "0")
        return run_job_distributed(ReconstructionJob(
            det=det, input_path=str(pdir), output_path=str(tmp_path / outdir),
            prefix="vd", chunk_size=8, backend="xla", block_dz=32,
        ))

    a = ddbvf.read_volume(run("ov", True))
    b = ddbvf.read_volume(run("ser", False))
    np.testing.assert_array_equal(a, b)


def test_run_job_distributed_max_blocks_resume(setup, tmp_path):
    """max_blocks parity with the single driver: one new block per
    invocation, resume completes, output equals an uninterrupted run."""
    from paris_tpu.app import ReconstructionJob
    from paris_tpu.parallel.app import run_job_distributed
    from paris_tpu.io.his import write_his
    from paris_tpu.io import ddbvf
    import json

    det = DetectorGeometry(
        n_row=64, n_col=64, l_px_row=2.0, l_px_col=2.0,
        delta_s=0.0, delta_t=0.0, d_so=500.0, d_od=500.0, delta_phi=22.5,
    )
    rng = np.random.default_rng(9)
    frames = rng.uniform(0, 60000, (16, det.n_col, det.n_row)).astype(np.uint16)
    pdir = tmp_path / "proj"
    pdir.mkdir()
    for i in range(0, 16, 8):
        write_his(str(pdir / f"b{i:03d}.his"), frames[i:i + 8],
                  number_dtype=np.uint16)

    def job(outdir, **kw):
        return ReconstructionJob(
            det=det, input_path=str(pdir), output_path=str(tmp_path / outdir),
            prefix="vd", chunk_size=8, backend="xla", block_dz=32, **kw)

    out = run_job_distributed(job("mb", max_blocks=1))
    manifest = json.load(open(out + ".manifest.json"))
    assert manifest["completed_blocks"] == [0]
    out = run_job_distributed(job("mb", resume=True))
    ref = run_job_distributed(job("ref"))
    np.testing.assert_array_equal(ddbvf.read_volume(out),
                                  ddbvf.read_volume(ref))


def test_distributed_roi_matches_single_device_roi(setup):
    """ROI job through DistributedReconstructor == single-device ROI path.

    Exercises the per-shard z offset composition with a nonzero ROI
    (offs[2] + my_z0, dist.py; reference ROI kernel path:
    src/cuda/backprojection.cu:86-90,124-126) on both backends.
    """
    from paris_tpu.geometry import RegionOfInterest, apply_roi

    det, vol, projs, angles = setup
    roi = RegionOfInterest(x1=6, x2=53, y1=10, y2=49, z1=4, z2=51)
    roi_geo = apply_roi(vol, roi)
    mesh = make_z_mesh()
    n = mesh.devices.size

    ref = reconstruct(
        det, roi_geo, projs[:8], angles[:8], chunk_size=8, backend="xla",
        roi_offset=(roi.x1, roi.y1, roi.z1))

    # XLA backend: z-sharded (block_dz must divide by mesh)
    block_dz = -(-roi_geo.dim_z // n) * n
    dist = DistributedReconstructor(
        det, roi_geo, mesh=mesh, chunk_size=8, block_dz=block_dz,
        backend="xla")
    out = dist.finalize(dist.accumulate(
        dist.init_block(), projs[:8], angles[:8],
        roi_offset=(roi.x1, roi.y1, roi.z1)))[: roi_geo.dim_z]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)

    # GPU kernel branch (interpret mode): same z-sharded layout
    distp = DistributedReconstructor(
        det, roi_geo, mesh=mesh, chunk_size=8, block_dz=block_dz,
        backend="gpu", interpret=True)
    outp = distp.finalize(distp.accumulate(
        distp.init_block(), projs[:8], angles[:8],
        roi_offset=(roi.x1, roi.y1, roi.z1)))[: roi_geo.dim_z]
    np.testing.assert_allclose(outp, ref, rtol=1e-4, atol=1e-4)


def test_distributed_staged_path_matches_accumulate(setup):
    """Manual stage_chunk/step_staged streaming (the app driver's
    double-buffered path) == accumulate == single-device result."""
    det, vol, projs, angles = setup
    mesh = make_z_mesh()
    n = mesh.devices.size
    block_dz = -(-vol.dim_z // n) * n
    dist = DistributedReconstructor(
        det, vol, mesh=mesh, chunk_size=8, block_dz=block_dz,
        backend="xla")
    volume = dist.init_block()
    staged = None
    for i in range(0, len(angles), 8):
        nxt = dist.stage_chunk(projs[i:i + 8], angles[i:i + 8])
        if staged is not None:
            volume = dist.step_staged(volume, staged)
        staged = nxt
    volume = dist.step_staged(volume, staged)
    out = dist.finalize(volume)[: vol.dim_z]

    ref = DistributedReconstructor(
        det, vol, mesh=mesh, chunk_size=8, block_dz=block_dz,
        backend="xla").reconstruct(projs, angles)
    np.testing.assert_array_equal(out, ref)


def test_owned_slots_partition(monkeypatch):
    """_owned_slots: each process owns exactly the chunk slots of its
    devices (blockwise over the mesh axis); the union over processes is
    a disjoint cover of all slots."""
    import types
    from paris_tpu.parallel.app import _owned_slots

    devs = np.array([types.SimpleNamespace(process_index=i // 2)
                     for i in range(4)])       # 2 procs x 2 devices
    mesh = types.SimpleNamespace(devices=devs)
    C = 8
    seen = {}
    for pidx in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda p=pidx: p)
        seen[pidx] = _owned_slots(mesh, C)
    assert seen[0] == {0, 1, 2, 3}
    assert seen[1] == {4, 5, 6, 7}
    assert seen[0] | seen[1] == set(range(C))
    assert not (seen[0] & seen[1])


def test_distributed_gpu_kernel_write_shards(setup, tmp_path):
    """GPU kernel branch (interpret mode) on the 8-device mesh: a block
    at a z offset goes through write_shards into the ddbvf at its global
    slices, byte-identical to finalize, and matches the single-device
    kernel result."""
    from paris_tpu.io import ddbvf
    det, vol, projs, angles = setup
    mesh = make_z_mesh()
    dist = DistributedReconstructor(
        det, vol, mesh=mesh, chunk_size=8, block_dz=16,
        backend="gpu", interpret=True)
    z0 = 24
    out = dist.accumulate(dist.init_block(), projs[:8], angles[:8],
                          z_offset=z0)
    path = str(tmp_path / "k.ddbvf")
    ddbvf.create(path, vol.dim_x, vol.dim_y, vol.dim_z)
    assert dist.write_shards(out, path, z0, 16) == 16
    block = dist.finalize(out)
    np.testing.assert_array_equal(ddbvf.read_slices(path, z0, 16), block)
    ref = reconstruct(det, vol, projs[:8], angles[:8], chunk_size=8,
                      backend="gpu", interpret=True, z_offset=z0,
                      block_shape=(16, vol.dim_y, vol.dim_x))
    np.testing.assert_allclose(block, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
