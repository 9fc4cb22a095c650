"""Persistent XLA compilation cache.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
module changes nothing. Otherwise the cache goes to one fixed directory,
`.jax_cache` at the repository root (listed in .gitignore): the path is
part of the cache key, so a cache that moves never hits.
"""

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
