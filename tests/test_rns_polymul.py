"""RNS polynomial multiplication — the HE evaluation workload.

The reference leaves both the per-modulus pointwise loop and the CRT
lift to the caller (its RNS surface is transforms only); these tests
pin the framework's additions:

- rns_pointwise_mult / rns_polymul residues == per-modulus golden
  (NTTCPU.mult / schoolbook), cyclic and ordered schedules;
- rns_pointwise_mult_lanes (the jittable mask-select path) == the
  sliced host path;
- crt_reconstruct: residue-wise cyclic convolution lifts to the exact
  big-integer schoolbook product mod prod(q_i).
"""

import numpy as np
import pytest

from gpuntt import (
    NTTCPU,
    NTTParameters,
    ReductionPolynomial,
    RNSMergePlan,
    crt_reconstruct,
    rns_pointwise_mult,
    rns_polymul,
)
from gpuntt.arith.host import find_ntt_primes, ntt_root_pair
from gpuntt.models.polymul import RNSPolynomialMultiplier
from gpuntt.reference.schoolbook import schoolbook_poly_multiplication


def _members(logn, count, dtype, poly=ReductionPolynomial.X_N_minus):
    """Distinct pool-style members: the default pool prime plus
    NTT-friendly neighbours q = k * 2^(logn+1) + 1."""
    from gpuntt import Modulus32, Modulus64, NTTFactors

    bits = 59 if np.dtype(dtype) == np.uint64 else 29
    mk = Modulus64 if np.dtype(dtype) == np.uint64 else Modulus32
    out = []
    for q in find_ntt_primes(bits, logn, count):
        om, psi = ntt_root_pair(q, logn)
        out.append(
            NTTParameters(logn, poly, dtype=dtype,
                          factors=NTTFactors(mk(q), om, psi)))
    return out


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_rns_polymul_matches_per_modulus_schoolbook(dtype, rng):
    logn, mc, k = 9, 3, 2
    members = _members(logn, mc, dtype)
    plan = RNSMergePlan.from_params(members)
    n = 1 << logn
    batch = k * mc
    mod_idx = np.arange(batch) % mc
    a = np.stack([
        rng.integers(0, members[m].modulus.value, n, dtype=np.uint64)
        .astype(dtype) for m in mod_idx])
    b = np.stack([
        rng.integers(0, members[m].modulus.value, n, dtype=np.uint64)
        .astype(dtype) for m in mod_idx])
    got = rns_polymul(a, b, plan)
    for r, m in enumerate(mod_idx):
        exp = schoolbook_poly_multiplication(
            a[r], b[r], members[m].modulus, members[m].poly_reduction)
        np.testing.assert_array_equal(got[r], exp.astype(dtype))


def test_rns_polymul_ordered_schedule(rng):
    logn, mc = 8, 3
    members = _members(logn, mc, np.uint64)
    plan = RNSMergePlan.from_params(members)
    order = np.array([2, 0, 1])
    n = 1 << logn
    mod_idx = order[np.arange(mc) % len(order)]
    a = np.stack([rng.integers(0, members[m].modulus.value, n,
                               dtype=np.uint64) for m in mod_idx])
    b = np.stack([rng.integers(0, members[m].modulus.value, n,
                               dtype=np.uint64) for m in mod_idx])
    got = rns_polymul(a, b, plan, order=order)
    for r, m in enumerate(mod_idx):
        exp = schoolbook_poly_multiplication(
            a[r], b[r], members[m].modulus, members[m].poly_reduction)
        np.testing.assert_array_equal(got[r], exp)


def test_rns_pointwise_lanes_matches_host(rng):
    import jax

    from gpuntt.ops.dispatch import rns_pointwise_mult_lanes
    from gpuntt.ops.merge_ntt import from_lanes, to_lanes

    logn, mc, batch = 8, 3, 6
    members = _members(logn, mc, np.uint64)
    plan = RNSMergePlan.from_params(members)
    n = 1 << logn
    mod_idx = np.arange(batch) % mc
    a = np.stack([rng.integers(0, members[m].modulus.value, n,
                               dtype=np.uint64) for m in mod_idx])
    b = np.stack([rng.integers(0, members[m].modulus.value, n,
                               dtype=np.uint64) for m in mod_idx])
    exp = rns_pointwise_mult(a, b, plan)
    got = from_lanes(
        jax.jit(lambda u, v: rns_pointwise_mult_lanes(u, v, plan, mod_idx))(
            to_lanes(a, True), to_lanes(b, True)), True)
    np.testing.assert_array_equal(got, exp)


def test_rns_model_crt_lifts_to_bigint_product(rng):
    """Residue-wise cyclic convolution == big-integer schoolbook mod
    Q = prod(q_i) — the property HE stacks rely on."""
    logn, mc = 6, 3
    members = _members(logn, mc, np.uint64)
    qs = [m.modulus.value for m in members]
    big_q = 1
    for q in qs:
        big_q *= q
    n = 1 << logn
    model = RNSPolynomialMultiplier(members)

    a_int = [int(x) for x in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    b_int = [int(x) for x in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    a = np.stack([np.array([x % q for x in a_int], dtype=np.uint64)
                  for q in qs])
    b = np.stack([np.array([x % q for x in b_int], dtype=np.uint64)
                  for q in qs])
    got = crt_reconstruct(model(a, b), qs)

    exp = [0] * n
    for i in range(n):
        for j in range(n):
            exp[(i + j) % n] = (exp[(i + j) % n]
                                + a_int[i] * b_int[j]) % big_q
    assert got == exp

    # batch-of-stacks shape (k, mod_count, N) round-trips too
    batched = model(np.stack([a, a]), np.stack([b, b]))
    assert batched.shape == (2, mc, n)
    np.testing.assert_array_equal(batched[0], batched[1])


def test_rns_model_rejects_bad_shapes(rng):
    members = _members(6, 2, np.uint64)
    model = RNSPolynomialMultiplier(members)
    with pytest.raises(ValueError):
        model(np.zeros((3, 64), dtype=np.uint64),
              np.zeros((3, 64), dtype=np.uint64))
