"""JAX's persistent compilation cache, in one place for every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing is changed.  Otherwise the cache goes to the checkout's
fixed ``.jax_cache/`` directory: the path is part of the cache key, so a
directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
