#!/usr/bin/env python3
"""Smoke test of paris_tpu on NVIDIA GPUs: the quickest proof that the
FDK path starts, compiles and is right on the card.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the --distributed path on 4 GPUs

Runs in ONE process (a JAX process reserves most of a card's memory, so
a second one would starve) and exits non-zero at the first failed gate:

  1. device — JAX must run on a GPU; prints its kind, the device count,
     ``nvidia-smi``'s name and power limit; builds the native I/O
     library from ``native/paris_io.cpp`` (set-up);
  2. kernel (one-GPU mode) — the Pallas/Triton backprojection kernel
     against the XLA op at a 1024^2 detector and a (256, 1024, 1024)
     block with z and ROI offsets (rel RMSE <= 1e-5), then the step
     (weight + filter + backprojection) timed with each, C = 16 and 32,
     compile excluded (``bench.step_rate``);
  3. end to end, BASELINE config 3 class — a 1024^2-detector Shepp-Logan
     scan (360 projections over 360 degrees, ~1024^3 volume) written as
     HIS files, reconstructed by ``paris_tpu.cli.main`` with
     ``--block-dz 256`` (several z-blocks), read back from the ddbvf and
     gated at rel RMSE <= 1e-3 against ``golden.golden_fdk_stream`` (f64)
     on three 2-slice slabs: interior, straddling the first block seam,
     and in the top block;
  4. ``--four-cards`` (instead of 2 and 3) — the same scan through
     ``cli.main([... "--distributed"])`` on a 4-GPU mesh, compared with
     a one-GPU run made in this process (max abs diff <= 1e-6 max|vol|)
     and with the same golden slabs.  The runs go in the order one GPU,
     four, four, one, so neither setting's wall carries the process's
     first-run costs alone.

Scan synthesis and the timings are ``bench.py``'s; this script keeps
only the gates.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE = 1024            # detector pixels per side (volume ~SIZE^3)
BLOCK_DZ = 256         # z-block extent of the CLI runs
SLAB = 2               # slices per golden slab


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_rmse(got: np.ndarray, ref: np.ndarray) -> float:
    """RMSE over the reference's peak magnitude (the repo's gate metric)."""
    got = got.astype(np.float64)
    ref = ref.astype(np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.abs(ref).max())


def phase_device(n_cards: int):
    from paris_tpu.utils.jax_cache import enable_persistent_cache
    cache = enable_persistent_cache()
    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        fail(f"JAX runs on {dev.platform!r}, not on a GPU")
    if len(devices) < n_cards:
        fail(f"{n_cards} GPUs needed, JAX sees {len(devices)}")
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)} (using {n_cards})")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {card}")
    log(f"compile cache: {cache}")
    t0 = time.perf_counter()
    from paris_tpu.io import native
    if not native.available():
        fail("native I/O library did not build from native/paris_io.cpp")
    log(f"native I/O library ready in {time.perf_counter() - t0:.2f}s "
        f"(set-up)")
    return dev, card


def phase_kernel(card: str) -> None:
    import jax
    import jax.numpy as jnp
    from bench import detector, step_rate
    from paris_tpu.geometry import derive_volume_geometry
    from paris_tpu.ops.backprojection_xla import make_bp_grid
    from paris_tpu.ops.filtering import ramp_filter_spectrum
    from paris_tpu.ops.weighting import weight_map
    from paris_tpu.phantom import cone_beam_project_jax
    from paris_tpu.pipeline import backprojector, preprocess_chunk

    det = detector(SIZE)
    vol = derive_volume_geometry(det)
    grid = make_bp_grid(det, vol)
    scale = vol.dim_x * vol.l_vx_x / 2 * 0.9
    block = (BLOCK_DZ, vol.dim_y, vol.dim_x)
    # nonzero ROI offset and z offset (a middle block: z = 384 at 1024)
    offs = jnp.asarray([24, 16, 3 * vol.dim_z // 8], jnp.int32)
    weights = weight_map(det)
    spectrum = ramp_filter_spectrum(det.n_row, det.l_px_row)
    prep = jax.jit(lambda x: preprocess_chunk(x, weights, spectrum,
                                              det.n_row))
    gpu = jax.jit(backprojector("gpu", grid))
    xla = jax.jit(backprojector("xla", grid))
    for C in (16, 32):
        angles = np.arange(C, dtype=np.float32) * (360.0 / C) + 3.0
        filtered = prep(jnp.asarray(
            cone_beam_project_jax(det, angles, scale)))
        phi = np.deg2rad(angles)
        sin = jnp.asarray(np.sin(phi), jnp.float32)
        cos = jnp.asarray(np.cos(phi), jnp.float32)
        zeros = jnp.zeros(block, jnp.float32)
        ref = np.asarray(xla(zeros, filtered, sin, cos, offs))
        got = np.asarray(gpu(zeros, filtered, sin, cos, offs))
        err = rel_rmse(got, ref)
        log(f"kernel parity C={C} block={block} offs={np.asarray(offs)}: "
            f"rel RMSE {err:.3e} (gate 1e-5)")
        if not np.isfinite(got).all() or not err <= 1e-5:
            fail(f"kernel vs XLA op rel RMSE {err:.3e} > 1e-5 at C={C}")
        del got, ref, zeros
        rate = {b: step_rate(b, SIZE, BLOCK_DZ, C) for b in ("gpu", "xla")}
        log(f"step C={C} {block}: gpu kernel {rate['gpu']['step_ms']} ms "
            f"({rate['gpu']['value']} Gupd/s), xla op "
            f"{rate['xla']['step_ms']} ms ({rate['xla']['value']} Gupd/s), "
            f"speedup {rate['xla']['step_ms'] / rate['gpu']['step_ms']:.2f}x"
            f" [{card}]")


def synthesize(workdir: str):
    """Write the config-3 scan; pick its golden slabs."""
    from bench import N_PROJ, write_scan

    t0 = time.perf_counter()
    scan = write_scan(workdir, SIZE)
    vol = scan.vol
    log(f"config-3 scan: detector {scan.det.n_row}x{scan.det.n_col}, "
        f"{N_PROJ} HIS projections over 360 deg written in "
        f"{time.perf_counter() - t0:.1f}s (set-up), volume "
        f"{vol.shape_zyx} (z, y, x)")
    if vol.dim_z <= BLOCK_DZ:
        fail(f"volume z {vol.dim_z} does not span several blocks")
    slabs = [(vol.dim_z * 5 // 8, SLAB),            # interior
             (BLOCK_DZ - SLAB // 2, SLAB),           # first block seam
             (vol.dim_z * 13 // 16, SLAB)]          # top block
    return scan, slabs


def golden_slabs(det, vol, proj_dir, slabs):
    """``golden_fdk_stream`` (f64) of the stored scan on host threads:
    each thread takes a disjoint share of the HIS files, and the shares'
    slabs add up exactly (backprojection is linear in the projections).
    Run after the timed device runs so it does not share their cores."""
    from paris_tpu.golden import golden_fdk_stream
    from paris_tpu.io.source import ProjectionSource

    frames = [(p.data, p.phi) for p in
              ProjectionSource(proj_dir, delta_phi=det.delta_phi)]
    n_workers = max(1, min(8, (os.cpu_count() or 2) // 2))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            n_workers, thread_name_prefix="golden") as pool:
        parts = list(pool.map(
            lambda w: golden_fdk_stream(frames[w::n_workers], det, vol,
                                        slabs),
            range(n_workers)))
    log(f"golden slabs (f64, {len(frames)} projections, {n_workers} "
        f"threads) in {time.perf_counter() - t0:.1f}s")
    return [np.sum([p[i].astype(np.float64) for p in parts], axis=0)
            for i in range(len(slabs))]


def check_slabs(path: str, slabs, golden, label: str) -> None:
    """Each slab's RMSE over the peak of all golden slabs (the gate's
    whole-volume normalization; a slab's own peak can be near zero)."""
    from paris_tpu.io import ddbvf
    peak = max(float(np.abs(g).max()) for g in golden)
    names = ("interior", "block seam", "top block")
    for name, (z0, dz), ref in zip(names, slabs, golden):
        got = ddbvf.read_slices(path, z0, dz).astype(np.float64)
        if not np.isfinite(got).all():
            fail(f"{label}: non-finite voxels in the {name} slab")
        err = float(np.sqrt(np.mean((got - ref) ** 2)) / peak)
        log(f"{label}: golden slab {name} z={z0}..{z0 + dz - 1}: "
            f"rel RMSE {err:.3e} (gate 1e-3)")
        if not err <= 1e-3:
            fail(f"{label}: {name} slab rel RMSE {err:.3e} > 1e-3")


def phase_e2e(workdir: str, card: str) -> None:
    from bench import N_PROJ, time_cli
    scan, slabs = synthesize(workdir)
    out = os.path.join(workdir, "out")
    wall = time_cli(["--geometry", scan.geo, "--input", scan.proj_dir,
                     "--output", out, "--block-dz", str(BLOCK_DZ)])
    n_blocks = -(-scan.vol.dim_z // BLOCK_DZ)
    updates = float(N_PROJ) * scan.vol.voxels
    log(f"config-3 CLI run (auto backend, {n_blocks} z-blocks of "
        f"{BLOCK_DZ}): wall {wall:.2f}s, {N_PROJ / wall:.1f} proj/s, "
        f"{updates / wall / 1e9:.1f} Gupd/s end to end [{card}]")
    check_slabs(os.path.join(out, "vol.ddbvf"), slabs,
                golden_slabs(scan.det, scan.vol, scan.proj_dir, slabs),
                "config-3 CLI")


def phase_four_cards(workdir: str, card: str) -> None:
    from bench import N_PROJ, time_cli
    from paris_tpu.io import ddbvf
    scan, slabs = synthesize(workdir)
    common = ["--geometry", scan.geo, "--input", scan.proj_dir,
              "--block-dz", str(BLOCK_DZ)]
    runs = {"1-GPU": [], "4-GPU": []}
    outs = {}
    for i, label in enumerate(("1-GPU", "4-GPU", "4-GPU", "1-GPU")):
        out = os.path.join(workdir, f"out{i}")
        runs[label].append(time_cli(
            common + ["--output", out]
            + (["--distributed"] if label == "4-GPU" else [])))
        if label in outs:          # keep the first output of each
            shutil.rmtree(out, ignore_errors=True)
        else:
            outs[label] = os.path.join(out, "vol.ddbvf")
    updates = float(N_PROJ) * scan.vol.voxels
    for label, walls in runs.items():
        log(f"{label} CLI walls in order of run: "
            + ", ".join(f"{w:.2f}s ({updates / w / 1e9:.1f} Gupd/s)"
                        for w in walls) + f" [{card}]")
    a = ddbvf.read_volume(outs["4-GPU"])
    b = ddbvf.read_volume(outs["1-GPU"])
    diff = float(np.abs(a - b).max())
    peak = float(np.abs(b).max())
    log(f"4-GPU vs 1-GPU volume: max abs diff {diff:.3e} "
        f"(gate {1e-6 * peak:.3e} = 1e-6 max|vol|)")
    if not np.isfinite(a).all() or not diff <= 1e-6 * peak:
        fail(f"4-GPU output differs from 1-GPU output by {diff:.3e}")
    del a, b
    check_slabs(outs["4-GPU"], slabs,
                golden_slabs(scan.det, scan.vol, scan.proj_dir, slabs),
                "4-GPU CLI")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --distributed path on 4 GPUs and "
                         "what it is compared with")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the scan and volumes "
                         "(default: a new temporary directory, removed "
                         "at exit)")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1

    sys.path.insert(0, HERE)
    try:
        import paris_tpu  # noqa: F401
    except ImportError as e:
        fail(f"the paris_tpu package is not next to chip_smoke.py ({e})")

    dev, card = phase_device(n_cards)
    workdir = args.workdir or tempfile.mkdtemp(prefix="paris_smoke_")
    try:
        if args.four_cards:
            phase_four_cards(workdir, card)
        else:
            phase_kernel(card)
            phase_e2e(workdir, card)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
