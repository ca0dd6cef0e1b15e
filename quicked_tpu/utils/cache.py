"""Where the program keeps what it computes once and reuses: XLA's
persistent compilation cache and the router's probe/rate cache.

Both live inside the checkout unless the environment says otherwise,
at fixed paths (the compilation cache's path is part of its key, so a
directory that moves never hits):

  - compilation cache: JAX_COMPILATION_CACHE_DIR verbatim when set (JAX
    reads the variable itself; nothing else is set in code), else
    <checkout>/.jax_cache;
  - probe/rate cache: QUICKED_TPU_CACHE when set, else
    <checkout>/.quicked_cache.
"""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        os.path.join(REPO, ".jax_cache")


def state_dir() -> str:
    return os.environ.get("QUICKED_TPU_CACHE") or \
        os.path.join(REPO, ".quicked_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    cache_dir = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
