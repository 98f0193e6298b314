"""Native C++ core vs pure-Python exact arithmetic (independence check).

The native library accelerates table generation and the u64 golden
models; these tests prove it agrees with the Python-int implementations
it replaces, so the golden oracle stays trustworthy.
"""

import numpy as np
import pytest

from gpuntt import NTTParameters, NTTParameters4Step, ReductionPolynomial
from gpuntt import _native
from gpuntt.params.bitrev import bitreverse
from gpuntt.reference import vecmod as vm
from gpuntt.reference.fourstep_cpu import NTT4StepCPU, intt_input_indices

pytestmark = pytest.mark.skipif(not _native.available(), reason="no native toolchain")

Q64 = 576460756061519873


def test_power_table_matches_python():
    got = _native.power_table(229929041166717729, Q64, 4096)
    acc = 1
    for i in range(0, 4096, 97):
        assert int(got[i]) == pow(229929041166717729, i, Q64)


def test_shoup_table_matches_python(rng):
    w = rng.integers(0, Q64, size=257, dtype=np.uint64)
    got = _native.shoup_table(w, Q64)
    for i in range(257):
        assert int(got[i]) == (int(w[i]) << 64) // Q64


def test_native_merge_golden_vs_python(rng):
    """Force the Python object-dtype path and compare with native."""
    for poly in (ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus):
        p = NTTParameters(9, poly, dtype=np.uint64)
        x = rng.integers(0, p.modulus.value, size=p.n, dtype=np.uint64)
        xnp = poly == ReductionPolynomial.X_N_plus
        got = _native.ntt_merge(x, p.logn, p.forward_root_of_unity_table,
                                p.modulus.value, xnp)

        # pure-Python reference path (the pre-native NTTCPU body)
        q = p.modulus.value
        out = [int(v) for v in x]
        t, m = p.n, 1
        while m < p.n:
            t >>= 1
            for i in range(m):
                j1 = 2 * i * t
                idx = bitreverse(m + i, p.logn) if xnp else bitreverse(i, p.logn - 1)
                s = int(p.forward_root_of_unity_table[idx])
                for j in range(j1, j1 + t):
                    u, v = out[j], (out[j + t] * s) % q
                    out[j], out[j + t] = (u + v) % q, (u - v) % q
            m <<= 1
        assert [int(v) for v in got] == out

        back = _native.intt_merge(got, p.logn, p.inverse_root_of_unity_table,
                                  p.modulus.value, xnp)
        np.testing.assert_array_equal(back, x)


def test_native_fourstep_golden_roundtrip(rng):
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    gen = NTT4StepCPU(p)
    x = rng.integers(0, p.modulus.value, size=p.n, dtype=np.uint64)
    np.testing.assert_array_equal(gen.intt(gen.ntt(x)), x)


def test_native_w_tables_match_python():
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    q = p.modulus.value
    W = _native.w_table_forward(p.root_of_unity, q, p.n1, p.n2)
    for i, j in [(0, 0), (1, 3), (31, 127), (13, 99)]:
        assert int(W[i * p.n2 + j]) == pow(p.root_of_unity, bitreverse(i, 5) * j, q)
    Wi = _native.w_table_inverse(p.inverse_root_of_unity, q, p.n1, p.n2)
    for i, j in [(0, 0), (1, 3), (31, 127), (13, 99)]:
        assert int(Wi[i * p.n2 + j]) == pow(
            p.inverse_root_of_unity, bitreverse(j, 7) * i, q
        )
