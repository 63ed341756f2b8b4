"""Test config: run JAX on a virtual 8-device CPU platform.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), per SURVEY.md §4(d).  The GPU
kernel's tests run here through the Pallas interpreter; tests marked
``gpu`` need the card itself and skip on CPU.  ``chip_smoke.py`` runs
the compiled path on a GPU; ``PARIS_TEST_GPU=1 python -m pytest -m gpu``
runs the ``gpu``-marked tests there.

``jax.config.update`` (not the JAX_PLATFORMS variable) pins the platform,
so the choice holds even when jax was imported before this file.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if os.environ.get("PARIS_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided per
    test, never at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and \
            jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel); "
                    "run with PARIS_TEST_GPU=1 on the card")
