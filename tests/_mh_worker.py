"""Worker process for the 2-process jax.distributed CPU tests.

Spawned by tests/test_multihost_2proc.py — NOT a test module (pytest
ignores the leading underscore).  Each worker initializes
jax.distributed against a local coordinator, forces the CPU platform
with N virtual devices, and runs the requested mode:

  * ``e2e_xla``      — full ``run_job_distributed`` (XLA backend,
                       z-sharded volume, per-process shard writes,
                       sink create/attach barrier, manifest).
  * ``kernel_shards``— ``DistributedReconstructor(backend="gpu",
                       interpret=True)`` (the GPU kernel branch, emulated)
                       + ``write_shards`` into a pre-created ddbvf.

Config arrives as one JSON argv blob so the parent fully controls it.
"""

import json
import os
import sys


def main() -> None:
    cfg = json.loads(sys.argv[1])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={cfg['local_devices']}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=cfg["coordinator"],
        num_processes=cfg["num_processes"],
        process_id=cfg["process_id"],
    )
    sys.path.insert(0, cfg["repo"])
    import numpy as np
    from paris_tpu.geometry import DetectorGeometry, derive_volume_geometry

    det = DetectorGeometry(**cfg["det"])

    if cfg["mode"] == "e2e_xla":
        from paris_tpu.app import ReconstructionJob
        from paris_tpu.parallel.app import run_job_distributed

        job = ReconstructionJob(
            det=det, input_path=cfg["input"], output_path=cfg["output"],
            prefix=cfg["prefix"], chunk_size=cfg["chunk"], backend="xla",
            block_dz=cfg["block_dz"],
        )
        run_job_distributed(job)
        # disjoint-input observability: the parent asserts each process
        # pixel-decoded only its own chunk-shard's frames
        from paris_tpu.io import his
        print(f"DECODE-FRAMES={his.DECODE_STATS['frames']}", flush=True)
    elif cfg["mode"] == "kernel_shards":
        from paris_tpu.parallel import multihost
        from paris_tpu.parallel.dist import DistributedReconstructor
        from paris_tpu.parallel.mesh import make_z_mesh

        vol = derive_volume_geometry(det)
        rec = DistributedReconstructor(
            det, vol, mesh=make_z_mesh(), chunk_size=cfg["chunk"],
            block_dz=cfg["block_dz"], backend="gpu", interpret=True,
        )
        rng = np.random.default_rng(7)   # same data on every process
        projs = rng.standard_normal(
            (cfg["chunk"], det.n_col, det.n_row)).astype(np.float32)
        angles = np.arange(cfg["chunk"], dtype=np.float32) * det.delta_phi
        v = rec.accumulate(rec.init_block(), projs, angles)
        rec.write_shards(v, cfg["ddbvf"], 0, vol.dim_z)
        multihost.barrier("paris-test-writes-done")
    else:
        raise SystemExit(f"unknown mode {cfg['mode']!r}")
    print("WORKER-OK", flush=True)


if __name__ == "__main__":
    main()
