"""API-surface parity tests, mirroring the reference example binaries.

- signed input / signed output (test_merge_ntt.cu:184-341,
  test_merge_intt.cu:205-370)
- PerCoefficient layout == transpose . PerPolynomial . transpose
  (test_merge_ntt.cu:343-474)
- RNS and ordered variants (untested in the reference — SURVEY.md §4 —
  we test them against per-modulus golden models)
"""

import numpy as np
import pytest

from gpuntt import (
    NTTCPU,
    NTTFactors,
    NTTLayout,
    NTTParameters,
    Modulus64,
    Modulus32,
    ReductionPolynomial,
)
from gpuntt.arith import host
from gpuntt.ops.dispatch import (
    intt,
    intt_modulus_ordered,
    intt_poly_ordered,
    intt_rns,
    ntt,
    ntt_modulus_ordered,
    ntt_poly_ordered,
    ntt_rns,
)
from gpuntt.ops.merge_ntt import MergePlan
from gpuntt.ops.rns import RNSMergePlan


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_signed_input_ntt(dtype, rng):
    """Signed (centered) input -> unsigned spectrum, vs golden on the
    sign-fixed input (reference section 2 semantics)."""
    p = NTTParameters(8, ReductionPolynomial.X_N_minus, dtype=dtype)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    q = p.modulus.value
    batch = 2
    mag = rng.integers(0, q // 2, size=(batch, p.n), dtype=np.uint64)
    sign = rng.integers(0, 2, size=(batch, p.n)) * 2 - 1
    signed = (mag.astype(object) * sign).astype(object)
    sdtype = np.int32 if dtype == np.uint32 else np.int64
    x_signed = np.array(signed.tolist(), dtype=sdtype)

    got = ntt(x_signed, plan)
    unsigned = np.where(signed < 0, q + signed, signed).astype(object)
    exp = np.stack(
        [gen.ntt(np.array(unsigned[i].tolist(), dtype=dtype)) for i in range(batch)]
    )
    np.testing.assert_array_equal(got.astype(dtype), exp)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_signed_output_intt(dtype, rng):
    """INTT with centered (signed) output (test_merge_intt.cu:205-370)."""
    p = NTTParameters(8, ReductionPolynomial.X_N_plus, dtype=dtype)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    q = p.modulus.value
    x = rng.integers(0, q, size=(2, p.n), dtype=np.uint64).astype(dtype)

    got = intt(x, plan, signed_output=True)
    exp_u = np.stack([gen.intt(x[i]) for i in range(2)]).astype(object)
    half = q >> 1
    exp = np.where(exp_u > half, exp_u - q, exp_u)
    np.testing.assert_array_equal(got.astype(object), exp)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_percoefficient_layout(dtype, rng):
    """PerCoefficient == transpose . PerPolynomial . transpose
    (test_merge_ntt.cu:343-474; buffer (N, batch), transform along axis 0)."""
    p = NTTParameters(7, ReductionPolynomial.X_N_plus, dtype=dtype)
    plan = MergePlan.from_params(p)
    batch = 16
    x = rng.integers(0, p.modulus.value, size=(p.n, batch), dtype=np.uint64).astype(dtype)

    got = ntt(x, plan, layout=NTTLayout.PerCoefficient)
    exp = ntt(x.T.copy(), plan).T
    np.testing.assert_array_equal(got, exp)

    got_i = intt(x, plan, layout=NTTLayout.PerCoefficient)
    exp_i = intt(x.T.copy(), plan).T
    np.testing.assert_array_equal(got_i, exp_i)


def _rns_params(logn, dtype, poly=ReductionPolynomial.X_N_minus):
    """Build 3 same-logn parameter sets with distinct moduli via NTTFactors."""
    if np.dtype(dtype) == np.uint64:
        triples = [
            (576460752303415297, 288482366111684746, 238394956950829),
            (576460752303439873, 37048445140799662, 54612008597396),
            (576460752304439297, 459782973201979845, 8242615629351),
        ]
        mk = Modulus64
    else:
        # q, with omega = generator^((q-1)/n) computed below
        qs = [268460033, 268582913, 268664833]
        triples = []
        for q in qs:
            m = mk32 = Modulus32(q)
            # find a 2n-th root: use a generator g, psi = g^((q-1)/(2n))
            g = 3
            while pow(g, (q - 1) // 2, q) == 1:
                g += 1
            psi = pow(g, (q - 1) // (2 << logn), q)
            omega = pow(psi, 2, q)
            triples.append((q, omega, psi))
        mk = Modulus32
    params = []
    for q, omega, psi in triples:
        f = NTTFactors(mk(q), omega, psi)
        params.append(NTTParameters(logn, poly, dtype=dtype, factors=f))
    return params


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_rns_roundtrip_and_parity(dtype, rng):
    logn = 6
    params = _rns_params(logn, dtype)
    plan = RNSMergePlan.from_params(params)
    batch = 7  # not a multiple of mod_count on purpose
    n = 1 << logn
    qmin = min(p.modulus.value for p in params)
    x = rng.integers(0, qmin, size=(batch, n), dtype=np.uint64).astype(dtype)

    got = ntt_rns(x, plan)
    for b in range(batch):
        gen = NTTCPU(params[b % 3])
        np.testing.assert_array_equal(got[b].astype(dtype), gen.ntt(x[b]))

    back = intt_rns(got.astype(dtype), plan)
    np.testing.assert_array_equal(back.astype(dtype), x)


@pytest.mark.parametrize("dtype", [np.uint64])
def test_modulus_ordered(dtype, rng):
    logn = 5
    params = _rns_params(logn, dtype)
    plan = RNSMergePlan.from_params(params)
    order = [2, 0]  # batch b uses modulus order[b % 2]
    batch = 4
    n = 1 << logn
    qmin = min(p.modulus.value for p in params)
    x = rng.integers(0, qmin, size=(batch, n), dtype=np.uint64).astype(dtype)

    got = ntt_modulus_ordered(x, plan, order)
    for b in range(batch):
        gen = NTTCPU(params[order[b % 2]])
        np.testing.assert_array_equal(got[b].astype(dtype), gen.ntt(x[b]))

    back = intt_modulus_ordered(got.astype(dtype), plan, order)
    np.testing.assert_array_equal(back.astype(dtype), x)


@pytest.mark.parametrize("dtype", [np.uint64])
def test_poly_ordered(dtype, rng):
    logn = 5
    params = _rns_params(logn, dtype)
    plan = RNSMergePlan.from_params(params)
    order = [3, 0, 2]  # poly order[b] gets modulus b % mod_count
    n = 1 << logn
    total_polys = 5
    qmin = min(p.modulus.value for p in params)
    x = rng.integers(0, qmin, size=(total_polys, n), dtype=np.uint64).astype(dtype)

    got = ntt_poly_ordered(x, plan, order)
    for b, poly_idx in enumerate(order):
        gen = NTTCPU(params[b % 3])
        np.testing.assert_array_equal(
            got[poly_idx].astype(dtype), gen.ntt(x[poly_idx])
        )
    # untouched rows pass through
    np.testing.assert_array_equal(got[1], x[1])
    np.testing.assert_array_equal(got[4], x[4])


# ------------------------------------------------- pointwise / polymul


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
def test_polymul_matches_schoolbook(dtype, poly, rng):
    """Fused device polymul == schoolbook mod (q, X^N -+ 1) — the
    reference example flow (test_cpu_merge_ntt.cu:70-77) as one jitted
    computation, for both reduction polynomials and widths."""
    from gpuntt import polymul, schoolbook_poly_multiplication

    p = NTTParameters(9, poly, dtype=dtype)
    plan = MergePlan.from_params(p)
    a = rng.integers(0, p.modulus.value, size=(2, p.n),
                     dtype=np.uint64).astype(dtype)
    b = rng.integers(0, p.modulus.value, size=(2, p.n),
                     dtype=np.uint64).astype(dtype)
    got = polymul(a, b, plan)
    exp = np.stack([
        schoolbook_poly_multiplication(a[i], b[i], p.modulus, poly)
        for i in range(2)
    ])
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_pointwise_mult_matches_host(dtype, rng):
    """Device pointwise Barrett product == NTTCPU.mult (ntt_cpu.cu:67-79)."""
    from gpuntt import pointwise_mult

    p = NTTParameters(8, ReductionPolynomial.X_N_minus, dtype=dtype)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    a = rng.integers(0, p.modulus.value, size=(3, p.n),
                     dtype=np.uint64).astype(dtype)
    b = rng.integers(0, p.modulus.value, size=(3, p.n),
                     dtype=np.uint64).astype(dtype)
    got = pointwise_mult(a, b, plan)
    exp = np.stack([gen.mult(a[i], b[i]) for i in range(3)])
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("logn", [12, 14, 16, 17])
def test_rns_engine_at_former_kernel_sizes(logn, rng):
    """ntt_rns / intt_rns over a 3-prime u64 ladder at the sizes a
    stacked-table device kernel used to own: each row bit-exact vs its
    member's golden model, and an exact round trip."""
    from gpuntt.arith.host import find_ntt_primes, ntt_root_pair

    members = []
    for q in find_ntt_primes(59, logn, 3):
        om, psi = ntt_root_pair(q, logn)
        members.append(NTTParameters(
            logn, ReductionPolynomial.X_N_plus, dtype=np.uint64,
            factors=NTTFactors(Modulus64(q), om, psi)))
    plan = RNSMergePlan.from_params(members)
    mod_idx = np.arange(4) % 3
    x = np.stack([rng.integers(0, members[m].modulus.value, 1 << logn,
                               dtype=np.uint64) for m in mod_idx])
    got = ntt_rns(x, plan)
    for r, m in enumerate(mod_idx):
        np.testing.assert_array_equal(got[r], NTTCPU(members[m]).ntt(x[r]))
    np.testing.assert_array_equal(intt_rns(got, plan), x)


@pytest.mark.parametrize("fn", ["ntt_lanes", "intt_lanes", "polymul_lanes"])
def test_lane_api_rejects_use_pallas(fn):
    """The device-specific kernel selector is gone from the public signatures:
    no argument can ask for a device-specific kernel any more."""
    from gpuntt.ops import dispatch
    from gpuntt.ops.merge_ntt import to_lanes

    p = NTTParameters(6, ReductionPolynomial.X_N_plus, dtype=np.uint64)
    plan = MergePlan.from_params(p)
    x = to_lanes(np.zeros((1, p.n), dtype=np.uint64), True)
    args = (x, x, plan) if fn == "polymul_lanes" else (x, plan)
    with pytest.raises(TypeError, match="use_pallas"):
        getattr(dispatch, fn)(*args, use_pallas=True)


def test_engine_choice_and_non_root_factors(rng):
    """select_engine is the one engine decision; every plan, including
    one built from caller factors that are NOT roots of unity, gets the
    butterfly engine, which reproduces the reference's
    garbage-in/garbage-out output for such tables exactly."""
    from gpuntt.ops.dispatch import select_engine

    for dtype in (np.uint32, np.uint64):
        p = NTTParameters(9, ReductionPolynomial.X_N_plus, dtype=dtype)
        assert select_engine(MergePlan.from_params(p)) == "butterfly"
    q = NTTParameters(9, ReductionPolynomial.X_N_plus,
                      dtype=np.uint64).modulus.value
    bad = NTTParameters(9, ReductionPolynomial.X_N_plus, dtype=np.uint64,
                        factors=NTTFactors(Modulus64(q), 5, 7))
    assert pow(bad.root_of_unity, 2 * bad.n, q) != 1
    plan = MergePlan.from_params(bad)
    assert select_engine(plan) == "butterfly"
    x = rng.integers(0, q, size=(2, bad.n), dtype=np.uint64)
    gen = NTTCPU(bad)
    np.testing.assert_array_equal(ntt(x, plan),
                                  np.stack([gen.ntt(r) for r in x]))
