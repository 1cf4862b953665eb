"""Persistent XLA compilation cache setup.

Every process that compiles the renderer pays seconds of XLA and Triton
compile time; the persistent cache makes later processes start warm.
Called by the CLI, bench, viewer and chip_smoke entry points (safe to call
more than once, and on the CPU).

Where the cache lives:

- ``RAYTRACER_TPU_CACHE=off`` disables it (the test suite sets this);
- else ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is — JAX
  reads it itself and nothing here sets another directory;
- else one fixed directory inside the checkout, ``.jax_cache/``
  (git-ignored). A fixed path matters: the path is part of what makes
  a cached entry hit.
"""

from __future__ import annotations

import os

#: the fixed in-checkout default
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir() -> str | None:
    """The directory the cache uses under the current environment, or
    None when it is switched off."""
    if os.environ.get("RAYTRACER_TPU_CACHE") == "off":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str | None:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return it (None: disabled)."""
    import jax

    path = cache_dir()
    if path is None:
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
