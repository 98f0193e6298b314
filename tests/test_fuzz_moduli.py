"""Randomized-modulus cross-engine consistency (deterministic seeds).

The reference accepts ANY caller-supplied NTTFactors (nttparameters.cuh:
38-54); the pool-prime tests exercise only ~60-bit and ~30-bit moduli.
Here we sample NTT-friendly primes across the supported width range and
assert golden == butterfly engine, forward and inverse, for each, so
width-dependent branches (Barrett schedules, lazy Shoup bounds) stay
honest off the pools.
"""

import numpy as np
import pytest

from gpuntt.arith.host import is_prime_u64
from gpuntt import (
    Modulus,
    NTTCPU,
    NTTFactors,
    NTTParameters,
    ReductionPolynomial,
)
from gpuntt.ops.merge_ntt import from_lanes, to_lanes


def _find_ntt_prime(bits: int, logn: int, seed: int):
    """A prime q = k*2^(logn+1) + 1 with bit_length == bits, plus a
    2N-th root of unity mod q (psi) — searched deterministically."""
    two_n = 1 << (logn + 1)
    rng = np.random.default_rng(seed)
    while True:
        k = int(rng.integers(1 << (bits - logn - 2),
                             1 << (bits - logn - 1)))
        q = k * two_n + 1
        if q.bit_length() != bits or not is_prime_u64(q):
            continue
        # psi = g^((q-1)/2N) for g not a QR-degenerate base: require
        # full order 2N (psi^N == -1)
        for g in range(2, 40):
            psi = pow(g, (q - 1) // two_n, q)
            if pow(psi, two_n // 2, q) == q - 1:
                return q, psi


CELLS = [
    # (bits, logn, dtype) — widths between/below the pools, plus the
    # wide range [2^60, 2^62) up to the documented Barrett bound
    (34, 8, np.uint64),
    (42, 9, np.uint64),
    (50, 10, np.uint64),
    (58, 9, np.uint64),
    (61, 9, np.uint64),
    (62, 10, np.uint64),
    (24, 8, np.uint32),
    (29, 10, np.uint32),
]


@pytest.mark.parametrize("bits,logn,dtype", CELLS)
def test_random_modulus_cross_engine(bits, logn, dtype):
    q, psi = _find_ntt_prime(bits, logn, seed=1000 * bits + logn)
    omega = pow(psi, 2, q)
    fac = NTTFactors(Modulus(q), omega, psi)
    p = NTTParameters(logn, ReductionPolynomial.X_N_plus, factors=fac,
                      dtype=dtype)
    gen = NTTCPU(p)
    rng = np.random.default_rng(bits * 7 + logn)
    x = rng.integers(0, q, size=(2, p.n), dtype=np.uint64).astype(dtype)
    exp = np.stack([gen.ntt(x[i]) for i in range(2)])

    # butterfly engine, both directions
    from gpuntt.ops.merge_ntt import MergePlan, merge_intt_lanes, merge_ntt_lanes
    import jax

    plan = MergePlan.from_params(p)
    lanes = to_lanes(x, plan.is64)
    got = from_lanes(jax.jit(merge_ntt_lanes)(lanes, plan), plan.is64)
    np.testing.assert_array_equal(got.astype(dtype), exp)
    back = from_lanes(jax.jit(merge_intt_lanes)(
        to_lanes(exp, plan.is64), plan), plan.is64)
    np.testing.assert_array_equal(back.astype(dtype), x)
    exp_inv = np.stack([gen.intt(x[i]) for i in range(2)])
    got_inv = from_lanes(jax.jit(merge_intt_lanes)(lanes, plan), plan.is64)
    np.testing.assert_array_equal(got_inv.astype(dtype), exp_inv)
