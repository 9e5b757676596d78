"""Placement of JAX's persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at import and that
directory is the only cache. Otherwise the cache goes to a fixed
directory inside the checkout, ``<repo>/.jax_cache``: the path is part
of the cache key, so a fixed path is what lets a later process hit it.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the path.

    Idempotent. Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set,
    or when the cache directory was already configured."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
