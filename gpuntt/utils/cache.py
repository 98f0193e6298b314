"""Persistent XLA compile cache for the scripts that drive the device.

`enable_compile_cache()` is called by chip_smoke.py, bench.py and the
examples before their first compilation.  Where JAX_COMPILATION_CACHE_DIR
is set, JAX reads it itself and nothing is set here.  Otherwise the
cache goes to `.jax_cache/` at the root of the checkout: a fixed path,
so that a later run of the same checkout finds what an earlier one
compiled (the path is part of the cache key).
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
