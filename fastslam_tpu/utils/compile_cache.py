"""JAX's persistent compilation cache, in one place.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set,
and otherwise in ``.jax_cache/`` at the root of this checkout (listed in
``.gitignore``).  The path is part of the cache key, so it is fixed: a run
from the same checkout finds what an earlier run compiled.
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns
    the directory."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
