"""Big-ring merge NTT parity (u64 logn 24-26, u32 24-25) — the
reference's upper range.

The reference dispatches merge NTTs to 2^28 with dedicated multi-launch
plans above 2^23 (ntt.cuh:665-698, ntt.cu:2163-2224).  Here that range
is served by the butterfly engine (any q), checked bit-exact against the
native C++ oracle on CPU; chip_smoke.py runs 2^24 on the GPU.

These tests are the slowest in the suite (a 2^24 transform per case);
they exist because an untested "structural" claim is not coverage.
"""

import numpy as np
import pytest

import jax

from gpuntt import NTTCPU, NTTParameters, ReductionPolynomial
from gpuntt import _native
from gpuntt.ops.merge_ntt import (MergePlan, from_lanes, merge_intt_lanes,
                                      merge_ntt_lanes, to_lanes)


def _rand(rng, n, q, dtype):
    return rng.integers(0, q, size=(1, n), dtype=np.uint64).astype(dtype)


@pytest.mark.skipif(not _native.available(), reason="no native toolchain")
def test_merge_u64_logn24_parity_vs_native(rng):
    """XLA engine == native oracle at 2^24 (X_N_plus), fwd and inv."""
    p = NTTParameters(24, ReductionPolynomial.X_N_plus, dtype=np.uint64)
    q = p.modulus.value
    x = _rand(rng, p.n, q, np.uint64)
    plan = MergePlan.from_params(p)

    exp = _native.ntt_merge(x, p.logn, p.forward_root_of_unity_table, q, True)
    got = from_lanes(
        jax.jit(merge_ntt_lanes)(to_lanes(x, True), plan), True)
    np.testing.assert_array_equal(got, exp)

    back_exp = _native.intt_merge(exp, p.logn,
                                  p.inverse_root_of_unity_table, q, True)
    np.testing.assert_array_equal(back_exp, x)  # oracle self-check
    back = from_lanes(
        jax.jit(merge_intt_lanes)(to_lanes(exp, True), plan), True)
    np.testing.assert_array_equal(back, x)


@pytest.mark.skipif(not _native.available(), reason="no native toolchain")
def test_merge_u64_logn25_fwd_parity_vs_native(rng):
    """XLA engine == native oracle at 2^25 (X_N_minus), forward."""
    p = NTTParameters(25, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    q = p.modulus.value
    x = _rand(rng, p.n, q, np.uint64)
    plan = MergePlan.from_params(p)
    exp = _native.ntt_merge(x, p.logn, p.forward_root_of_unity_table, q,
                            False)
    got = from_lanes(
        jax.jit(merge_ntt_lanes)(to_lanes(x, True), plan), True)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.skipif(not _native.available(), reason="no native toolchain")
def test_merge_u64_logn26_fwd_parity_vs_native(rng):
    """XLA engine == native oracle at 2^26, forward.  Feasible in-suite
    because MergePlan is a pytree and rides as a jit ARGUMENT — as a
    closure constant the 2^26 tables constant-fold for ~8 extra minutes
    of compile."""
    p = NTTParameters(26, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    q = p.modulus.value
    x = _rand(rng, p.n, q, np.uint64)
    plan = MergePlan.from_params(p)
    exp = _native.ntt_merge(x, p.logn, p.forward_root_of_unity_table, q,
                            False)
    got = from_lanes(
        jax.jit(merge_ntt_lanes)(to_lanes(x, True), plan), True)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.skipif(not _native.available(), reason="no native toolchain")
def test_fourstep_logn24_parity(rng):
    """4-step at logn 24 (n1=256, n2=65536 — the top of the reference's
    MATRIX_DIMENSIONS table, nttparameters.cu:305-354), fwd + inv vs
    the golden model."""
    from gpuntt import NTT4StepCPU, NTTParameters4Step
    from gpuntt.ops.fourstep import (FourStepPlan, fourstep_intt_full,
                                         fourstep_ntt_full)

    p = NTTParameters4Step(24, ReductionPolynomial.X_N_minus,
                           dtype=np.uint64)
    assert (p.n1, p.n2) == (256, 65536)
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    x = _rand(rng, p.n, p.modulus.value, np.uint64)
    got = from_lanes(
        jax.jit(fourstep_ntt_full)(to_lanes(x, True), plan), True)
    exp = gen.ntt(x[0])[None]
    np.testing.assert_array_equal(got, exp)
    back = from_lanes(
        jax.jit(fourstep_intt_full)(to_lanes(exp, True), plan), True)
    np.testing.assert_array_equal(back, x)


def test_merge_u32_logn25_fwd_parity(rng):
    """u32 pool TOP (logn 25, nttparameters.cu:84-98): XLA engine vs the
    vectorized golden at 2^25, forward.  With this the u32 dispatch
    range is suite-covered end to end (2-25), matching the u64 cells."""
    p = NTTParameters(25, ReductionPolynomial.X_N_minus, dtype=np.uint32)
    q = p.modulus.value
    x = _rand(rng, p.n, q, np.uint32)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    exp = gen.ntt(x[0])[None]
    got = from_lanes(
        jax.jit(merge_ntt_lanes)(to_lanes(x, False), plan), False)
    np.testing.assert_array_equal(got, exp)


def test_merge_u32_logn24_parity(rng):
    """u32 pool reaches logn 25 (nttparameters.cu:84-98); check the XLA
    engine at 2^24 against the vectorized golden, fwd + inv."""
    p = NTTParameters(24, ReductionPolynomial.X_N_plus, dtype=np.uint32)
    q = p.modulus.value
    x = _rand(rng, p.n, q, np.uint32)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    exp = gen.ntt(x[0])[None]
    got = from_lanes(
        jax.jit(merge_ntt_lanes)(to_lanes(x, False), plan), False)
    np.testing.assert_array_equal(got, exp)
    back = from_lanes(
        jax.jit(merge_intt_lanes)(to_lanes(exp, False), plan), False)
    np.testing.assert_array_equal(back, x)
