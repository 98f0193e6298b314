"""Set-up shared by the example scripts.

`--platform=cpu` (or `--platform cpu`) / the GPUNTT_PLATFORM env var
pick the JAX backend via jax.config.update before first backend use;
without either, JAX takes its default (the GPU where there is one).
Then the persistent compile cache is turned on
(gpuntt.utils.cache.enable_compile_cache).
"""

import os
import sys


def apply():
    plat = None
    argv = sys.argv
    i = 1
    while i < len(argv):
        a = argv[i]
        if a.startswith("--platform="):
            plat = a.split("=", 1)[1]
            del argv[i]
            continue
        if a == "--platform" and i + 1 < len(argv):
            plat = argv[i + 1]
            del argv[i:i + 2]
            continue
        i += 1
    plat = plat or os.environ.get("GPUNTT_PLATFORM")
    import jax

    if plat:
        jax.config.update("jax_platforms", plat)
    from gpuntt.utils.cache import enable_compile_cache

    enable_compile_cache()
