"""Worker for the CLI-level 2-process test: forces the CPU platform,
then enters ``paris_tpu.cli.main`` with real command-line flags — the
path a multi-host user takes (`paris-tpu --distributed --coordinator ...`).

Config arrives as one JSON argv blob (see tests/_mh_worker.py).
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
    sys.path.insert(0, cfg["repo"])
    from paris_tpu.cli import main as cli_main

    rc = cli_main(cfg["argv"] + ["--process-id", str(cfg["process_id"])])
    if rc != 0:
        raise SystemExit(rc)
    print("WORKER-OK", flush=True)


if __name__ == "__main__":
    main()
