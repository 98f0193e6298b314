"""Host-clock timing of jitted calls on the device.

JAX dispatch is asynchronous, so every timed call ends in
block_until_ready; the first call compiles and is left out.  This is
what bench.py, benchmarks/ and the A/B measurements use: warm calls,
one process, one card.
"""

from __future__ import annotations

import time


def time_calls(fn, *args, n: int = 20) -> list[float]:
    """Seconds of n warm calls fn(*args), each ending in
    block_until_ready, after one untimed call that compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out
