"""Contract test for the host-clock timing utility (CPU)."""

import jax
import jax.numpy as jnp

from gpuntt.utils.timing import time_calls


def test_time_calls_counts_warm_calls_only():
    """One untimed compiling call, then n timed ones, each positive."""
    calls = []

    @jax.jit
    def step(v):
        return v * 3 + 1

    def fn(v):
        calls.append(1)
        return step(v)

    t = time_calls(fn, jnp.arange(1024, dtype=jnp.uint32), n=5)
    assert len(t) == 5 and all(s > 0 for s in t)
    assert len(calls) == 6
