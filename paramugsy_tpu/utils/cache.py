"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets no directory.  Otherwise the cache goes to
``<checkout>/.jax_cache``: a fixed path, since the path is part of what a
later process must find again.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
