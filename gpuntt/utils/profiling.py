"""Profiling and roofline analysis.

The reference's only observability is nvbench's built-in counters
(L1/L2 hit rates, declared global-memory traffic —
bench_merge_ntt.cu:34-40).  The equivalents here:

- `trace(...)`: a context manager around jax.profiler emitting an
  xplane trace viewable in TensorBoard / Perfetto;
- `ntt_cost(...)`: the declared-work model (butterflies, HBM bytes),
  mirroring the reference's declared global-memory sizes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass



@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: `with trace('/tmp/ntt-trace'): run()`."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass(frozen=True)
class NTTCost:
    """Declared work for one batched transform (reference analog:
    bench_merge_ntt.cu:34-38 declares (N + N/2)*batch reads etc.)."""

    butterflies: int
    modmuls: int
    hbm_read_bytes: int
    hbm_write_bytes: int


def ntt_cost(logn: int, batch: int, is64: bool) -> NTTCost:
    n = 1 << logn
    butterflies = (n // 2) * logn * batch
    itemsize = 8 if is64 else 4
    return NTTCost(
        butterflies=butterflies,
        modmuls=butterflies,  # one twiddle modmul per butterfly
        hbm_read_bytes=(n + n // 2) * batch * itemsize,
        hbm_write_bytes=n * batch * itemsize,
    )
