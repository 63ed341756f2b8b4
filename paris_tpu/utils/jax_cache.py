"""Where JAX keeps its persistent compilation cache.

A cold process compiles the reconstruction step (weight + filter +
backprojection) once per block shape.  JAX's own persistent cache keeps
the compiled programs across processes; this helper only decides its
directory:

  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it — nothing
    is changed here;
  * otherwise: ``<checkout>/.jax_cache`` — a fixed path (listed in
    ``.gitignore``), never derived from a temp name, a pid or the time,
    so the next process of this checkout finds the entries again.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["default_cache_dir", "enable_persistent_cache"]


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` (the directory holding ``paris_tpu``)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_persistent_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at its directory (see
    the module docstring); returns that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
