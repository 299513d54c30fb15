"""JAX's persistent compilation cache, in one place.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, nothing here
overrides it.  Otherwise the cache lives at `<checkout>/.jax_cache`, a path
fixed by this package's location (the path is part of what makes a cached
entry found again).
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
