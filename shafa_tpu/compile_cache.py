"""Where JAX keeps its persistent compilation cache.

JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting: JAX reads it and
this module sets nothing. Otherwise the cache goes to the fixed
``<repo>/.jax_cache``, so that every run from one checkout finds the
programs an earlier run compiled.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Turn the persistent compilation cache on; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return DEFAULT_DIR
