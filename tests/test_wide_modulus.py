"""Wide-modulus coverage: q in [2^60, 2^62) for u64, 30-bit for u32.

The reference documents Barrett validity for moduli up to 62 bits
(u64) / 30 bits (u32) (modular_arith.cuh:66-67).  The butterfly
engines cover that full domain (lazy Shoup bound 3q < 2^64), asserted
here against the golden models (the native oracle's __int128 mulmod is
exact for q < 2^63) through the engine, the public numpy API, the
4-step engine and the polynomial product.

Primes found by Miller-Rabin search with q ≡ 1 (mod 2N) and psi of
exact order 2N; omega = psi^2.
"""

import numpy as np
import pytest

import jax

from gpuntt import (NTTCPU, NTTFactors, NTTParameters,
                        NTTParameters4Step, ReductionPolynomial)
from gpuntt.arith.modulus import Modulus32, Modulus64
from gpuntt.ops.merge_ntt import (MergePlan, from_lanes, merge_intt_lanes,
                                      merge_ntt_lanes, to_lanes)

# (q, psi) with psi of order 2^13 (logn 12)
WIDE61 = (1152921504606904321, 372252312640463555)
WIDE62 = (4611684918915809281, 4166544109213919754)  # q = 2^62 - 1.1e9
# psi of order 2^14 (logn 13)
WIDE62_L13 = (2305843009214414849, 2225036270695883949)
# 30-bit u32 prime, psi of order 2^13
U32_30BIT = (1072766977, 685863465)

POLYS = [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]


def _params(logn, q, psi, poly, dtype=np.uint64):
    mod = Modulus64(q) if dtype == np.uint64 else Modulus32(q)
    return NTTParameters(
        logn, poly, dtype=dtype,
        factors=NTTFactors(mod, psi * psi % q, psi))


# ------------------------------------------- public API and 4-step: wide


@pytest.mark.parametrize("poly", POLYS)
def test_public_api_exact_wide_modulus_logn13(poly, rng):
    """ntt / intt over numpy at a near-2^62 modulus and logn 13, forward
    against the golden model and an exact round trip."""
    from gpuntt import intt, ntt

    q, psi = WIDE62_L13
    p = _params(13, q, psi, poly)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    x = rng.integers(0, q, size=(2, p.n), dtype=np.uint64)
    got = ntt(x, plan)
    np.testing.assert_array_equal(got, np.stack([gen.ntt(r) for r in x]))
    np.testing.assert_array_equal(intt(got, plan), x)


def test_fourstep_engine_exact_wide_modulus(rng):
    """4-step engine at a near-2^62 modulus vs the 4-step golden model,
    forward and inverse."""
    from gpuntt import NTT4StepCPU
    from gpuntt.ops.fourstep import (FourStepPlan, fourstep_intt_full,
                                     fourstep_ntt_full)

    q, psi = WIDE62
    p = NTTParameters4Step(
        12, ReductionPolynomial.X_N_minus, dtype=np.uint64,
        factors=NTTFactors(Modulus64(q), psi * psi % q, psi))
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    x = rng.integers(0, q, size=(2, p.n), dtype=np.uint64)
    got = from_lanes(jax.jit(fourstep_ntt_full)(to_lanes(x, True), plan), True)
    np.testing.assert_array_equal(got, np.stack([gen.ntt(r) for r in x]))
    back = from_lanes(jax.jit(fourstep_intt_full)(to_lanes(got, True), plan),
                      True)
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("q,psi", [WIDE61, WIDE62])
def test_polymul_exact_wide_modulus(q, psi, rng):
    """Negacyclic product at a wide modulus equals the schoolbook
    product (the pointwise Barrett runs at the full 62-bit width)."""
    from gpuntt import polymul, schoolbook_poly_multiplication

    # psi has order 2^13; its 16th power has the order 2^9 that logn 8 needs
    p = _params(8, q, pow(psi, 16, q), ReductionPolynomial.X_N_plus)
    plan = MergePlan.from_params(p)
    a = rng.integers(0, q, size=(2, p.n), dtype=np.uint64)
    b = rng.integers(0, q, size=(2, p.n), dtype=np.uint64)
    got = polymul(a, b, plan)
    for i in range(2):
        exp = schoolbook_poly_multiplication(a[i], b[i], p.modulus,
                                             ReductionPolynomial.X_N_plus)
        np.testing.assert_array_equal(got[i], exp)


def test_signed_variants_wide_modulus(rng):
    """Signed input / centered output at a near-2^62 modulus: the
    sign-fix add (q + x) and the centered subtract both stay inside
    u64 for q < 2^63, asserted against the golden on sign-fixed data
    (reference Data64s semantics, test_merge_ntt.cu:184-341)."""
    from gpuntt import intt, ntt

    q, psi = WIDE62
    p = _params(10, q, psi, ReductionPolynomial.X_N_minus)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    mag = rng.integers(0, q // 2, size=(2, p.n), dtype=np.uint64)
    sign = rng.integers(0, 2, size=(2, p.n)) * 2 - 1
    signed = (mag.astype(object) * sign).astype(object)
    x_signed = np.array(signed.tolist(), dtype=np.int64)

    got = ntt(x_signed, plan)
    unsigned = np.where(signed < 0, q + signed, signed).astype(object)
    exp = np.stack([gen.ntt(np.array(unsigned[i].tolist(), dtype=np.uint64))
                    for i in range(2)])
    np.testing.assert_array_equal(got.astype(np.uint64), exp)

    back = intt(exp, plan, signed_output=True)
    exp_u = np.stack([gen.intt(exp[i]) for i in range(2)]).astype(object)
    half = q >> 1
    exp_c = np.where(exp_u > half, exp_u - q, exp_u)
    np.testing.assert_array_equal(back.astype(object), exp_c)


# ----------------------------------------- butterfly engine: wide bit-exact


@pytest.mark.parametrize("q,psi", [WIDE61, WIDE62])
@pytest.mark.parametrize("poly", POLYS)
def test_xla_engine_exact_wide_modulus(q, psi, poly, rng):
    """Shoup butterfly engines stay bit-exact for q up to the 62-bit
    documented bound (lazy bound 3q < 2^64 over the transform)."""
    p = _params(12, q, psi, poly)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    x = rng.integers(0, q, size=(2, p.n), dtype=np.uint64)
    got = from_lanes(
        jax.jit(lambda v: merge_ntt_lanes(v, plan))(to_lanes(x, True)), True)
    exp = np.stack([gen.ntt(x[i]) for i in range(2)])
    np.testing.assert_array_equal(got, exp)
    back = from_lanes(
        jax.jit(lambda v: merge_intt_lanes(v, plan))(to_lanes(exp, True)),
        True)
    np.testing.assert_array_equal(back, x)


def test_u32_engine_exact_30bit_modulus(rng):
    """u32 at the reference's 30-bit modulus bound."""
    q, psi = U32_30BIT
    p = _params(12, q, psi, ReductionPolynomial.X_N_plus, dtype=np.uint32)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    x = rng.integers(0, q, size=(2, p.n), dtype=np.uint64).astype(np.uint32)
    got = from_lanes(
        jax.jit(lambda v: merge_ntt_lanes(v, plan))(to_lanes(x, False)),
        False)
    exp = np.stack([gen.ntt(x[i]) for i in range(2)])
    np.testing.assert_array_equal(got, exp)
    back = from_lanes(
        jax.jit(lambda v: merge_intt_lanes(v, plan))(to_lanes(exp, False)),
        False)
    np.testing.assert_array_equal(back, x)
