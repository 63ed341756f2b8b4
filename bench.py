"""Benchmark: backprojection throughput on one device, per backend.

    python bench.py                  # step timing, gpu kernel and xla op
    python bench.py --backend xla    # one backend
    python bench.py --e2e 5          # + 5 rounds of full CLI runs (config 3)
    python bench.py --chunk --e2e 5 --e2e-block-dz 256   # CLI runs only

Step mode times the compiled reconstruction step (weight + ramp filter +
backprojection of one chunk) on a (block_dz, size, size) z-block of the
~size^3 volume, compile and warm-up excluded, and prints one JSON line
per backend:

  {"metric": ..., "value": Gupd/s, "unit": "Gupd/s/device",
   "device_kind": ..., "device_count": ..., "vs_streaming_bound": ...}

``vs_streaming_bound`` is the rate over the device's per-projection
streaming bound (memory bandwidth / 8 B per voxel update — what an
implementation that reads and writes the volume once per projection can
reach), given only for a ``device_kind`` with a published bandwidth in
``PEAK_BYTES_PER_S``; null otherwise.

``--e2e N`` synthesizes BASELINE config 3's class of scan (``--size``^2
detector, 360 projections over 360 degrees, HIS files) and times
``paris_tpu.cli.main`` for each backend in N rounds of the order a, b,
b, a (the first run of each backend includes its compile, as a user's
first run does).  The z-blocks are the planner's (the user's default)
unless ``--e2e-block-dz`` forces an extent.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

# Published memory bandwidth by device_kind (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

N_PROJ = 360           # projections over 360 degrees (BASELINE config 3)


def detector(size: int, n_proj: int = N_PROJ):
    from paris_tpu.geometry import DetectorGeometry
    # geometry scaled so the derived volume is ~size^3
    return DetectorGeometry(
        n_row=size, n_col=size, l_px_row=1.0, l_px_col=1.0,
        delta_s=0.0, delta_t=0.0, d_so=8.0 * size, d_od=4.0 * size,
        delta_phi=360.0 / n_proj)


def step_rate(backend: str, size: int, block_dz: int, C: int) -> dict:
    import jax
    from paris_tpu.geometry import derive_volume_geometry
    from paris_tpu.pipeline import Reconstructor

    det = detector(size)
    vol = derive_volume_geometry(det)
    dz = min(block_dz, vol.dim_z)
    rec = Reconstructor(det, vol, chunk_size=C, backend=backend,
                        block_shape=(dz, vol.dim_y, vol.dim_x))
    rng = np.random.default_rng(0)
    chunk = rng.standard_normal((C, det.n_col, det.n_row)).astype(np.float32)
    angles = np.arange(C, dtype=np.float32) * det.delta_phi
    staged = rec.stage_chunk(chunk, angles)
    volume = rec.step_staged(rec.init_block(), staged)    # compile + warm-up
    volume.block_until_ready()
    updates = dz * vol.dim_y * vol.dim_x * C
    iters = min(100, max(3, int(np.ceil(2.0e11 / updates))))
    t0 = time.perf_counter()
    for _ in range(iters):
        volume = rec.step_staged(volume, staged)
    volume.block_until_ready()
    dt = (time.perf_counter() - t0) / iters
    gups = updates / dt / 1e9
    dev = jax.devices()[0]
    peak = PEAK_BYTES_PER_S.get(dev.device_kind)
    return {
        "metric": (f"fdk_step_gvoxel_updates_per_s_{vol.dim_x}cube_"
                   f"dz{dz}_c{C}_{rec.backend}"),
        "value": round(gups, 3),
        "unit": "Gupd/s/device",
        "step_ms": round(dt * 1e3, 4),
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "vs_streaming_bound": (None if peak is None
                               else round(gups * 1e9 * 8.0 / peak, 4)),
    }


class Scan(NamedTuple):
    det: object          # DetectorGeometry
    vol: object          # VolumeGeometry derived from it
    geo: str             # geometry file
    proj_dir: str        # directory of HIS files


def write_scan(workdir: str, size: int, n_proj: int = N_PROJ) -> Scan:
    """BASELINE config 3's class of scan: a Shepp-Logan phantom seen
    from ``n_proj`` angles over 360 degrees by a ``size``^2 detector,
    written as HIS files with its geometry file."""
    from paris_tpu.geometry import derive_volume_geometry
    from paris_tpu.io.geometry_file import dump_geometry_file
    from paris_tpu.phantom import write_his_scan

    det = detector(size, n_proj)
    vol = derive_volume_geometry(det)
    geo = os.path.join(workdir, "scan.geo")
    dump_geometry_file(det, geo)
    proj_dir = os.path.join(workdir, "proj")
    angles = np.arange(n_proj, dtype=np.float32) * det.delta_phi
    write_his_scan(det, angles, vol.dim_x * vol.l_vx_x / 2 * 0.9, proj_dir)
    return Scan(det, vol, geo, proj_dir)


def time_cli(argv) -> float:
    """Wall seconds of one in-process ``paris_tpu.cli.main(argv)`` run;
    a failed run raises."""
    from paris_tpu import cli
    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"paris_tpu.cli.main({argv}) returned {rc}")
    return wall


def e2e(backends, size: int, rounds: int, block_dz: int,
        workdir: str, n_proj: int = N_PROJ) -> None:
    scan = write_scan(workdir, size, n_proj)
    order = (list(backends) + list(reversed(backends))) * rounds
    for i, backend in enumerate(order):
        out = os.path.join(workdir, f"out{i}")
        try:
            wall = time_cli(
                ["--geometry", scan.geo, "--input", scan.proj_dir,
                 "--output", out, "--backend", backend]
                + (["--block-dz", str(block_dz)] if block_dz else []))
        finally:
            shutil.rmtree(out, ignore_errors=True)
        print(json.dumps({
            "metric": (f"config3_cli_wall_s_{scan.vol.dim_x}cube_"
                       f"dz{block_dz or 'auto'}_{backend}"),
            "value": round(wall, 3), "unit": "s", "run": i,
            "gupd_per_s": round(n_proj * scan.vol.voxels / wall / 1e9, 3)}),
            flush=True)


def main():
    ap = argparse.ArgumentParser(description="paris_tpu benchmark")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--block-dz", type=int, default=256)
    ap.add_argument("--chunk", type=int, nargs="*", default=[16, 32],
                    help="chunk sizes of the step timing (none: skip it)")
    ap.add_argument("--backend", nargs="+", default=None,
                    help="backends to time (default: gpu and xla on a "
                         "GPU, xla elsewhere)")
    ap.add_argument("--e2e", type=int, default=0, metavar="ROUNDS",
                    help="also time ROUNDS rounds (a, b, b, a) of full CLI "
                         "runs of the config-3 scan")
    ap.add_argument("--e2e-block-dz", type=int, default=0,
                    help="force the CLI runs' z-block extent (0: planner)")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paris_tpu.utils.jax_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)
    backends = args.backend or (
        ["gpu", "xla"] if dev.platform == "gpu" else ["xla"])
    for backend in backends:
        for C in args.chunk:
            print(json.dumps(step_rate(backend, args.size, args.block_dz,
                                       C)), flush=True)
    if args.e2e:
        workdir = tempfile.mkdtemp(prefix="paris_bench_")
        try:
            e2e(backends, args.size, args.e2e, args.e2e_block_dz, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
