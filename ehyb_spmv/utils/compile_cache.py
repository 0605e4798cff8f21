"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins.
Otherwise the cache lives at a fixed, gitignored path inside the checkout
(``.jax_cache/``): the path is part of what a later run must find again, so
it never depends on a temp name, a pid or the time.
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
