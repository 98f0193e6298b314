"""RNS 4-step NTT parity (GPU_4STEP_NTT RNS overload, ntt_4step.cu:2293-2765).

Each batch row, transformed under its schedule's modulus, must be
bit-identical to the matching member's NTT_4STEP_CPU golden — forward,
inverse, both dtypes.
"""

import numpy as np
import pytest

from gpuntt import (Modulus32, Modulus64, NTT4StepCPU, NTTFactors,
                        NTTParameters4Step, ReductionPolynomial,
                        RNSFourStepPlan, rns_fourstep_intt_full,
                        rns_fourstep_ntt_full)
from gpuntt.arith.host import find_ntt_primes, ntt_root_pair
from gpuntt.ops.merge_ntt import from_lanes, to_lanes

LOGN = 12


def _member(q, logn, dtype):
    om, psi = ntt_root_pair(q, logn)
    mk = Modulus64 if np.dtype(dtype) == np.uint64 else Modulus32
    return NTTParameters4Step(
        logn, ReductionPolynomial.X_N_minus, dtype=dtype,
        factors=NTTFactors(mk(q), om, psi))


_QS = {
    np.uint64: (576460752303415297, 576460752303439873, 576460752304439297),
    np.uint32: (268460033, 268582913, 268664833),
}


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_rns_fourstep_matches_golden(dtype, rng):
    members = [_member(q, LOGN, dtype) for q in _QS[dtype]]
    plan = RNSFourStepPlan.from_params(members)
    gens = [NTT4StepCPU(p) for p in members]
    batch = 5
    mod_idx = np.arange(batch) % plan.mod_count
    qs = np.array(plan.qs, dtype=np.uint64)
    x = np.stack([rng.integers(0, qs[mod_idx[b]], 1 << LOGN,
                               dtype=np.uint64) for b in range(batch)]
                 ).astype(dtype)

    lanes = to_lanes(x, plan.is64)
    got = from_lanes(rns_fourstep_ntt_full(lanes, plan, mod_idx),
                     plan.is64).astype(dtype)
    exp = np.stack([gens[mod_idx[b]].ntt(x[b]) for b in range(batch)])
    np.testing.assert_array_equal(got, exp)

    back = from_lanes(
        rns_fourstep_intt_full(to_lanes(exp, plan.is64), plan, mod_idx),
        plan.is64).astype(dtype)
    np.testing.assert_array_equal(back, x)


def test_rns_fourstep_rejects_mixed_shapes():
    a = _member(576460752303415297, 12, np.uint64)
    b = _member(576460752303439873, 13, np.uint64)
    with pytest.raises(ValueError):
        RNSFourStepPlan.from_params([a, b])




@pytest.mark.parametrize("logn", [14, 17])
def test_rns_fourstep_engine_golden_at_former_kernel_sizes(logn, rng):
    """The stacked-table RNS 4-step engine at the sizes a dedicated
    kernel used to own: logn 14 (n2 = 512) and 17 (n2 = 4096), mixed
    moduli in one batch, each row bit-identical to its member's golden
    model, forward and inverse."""
    from gpuntt.ops.fourstep_rns import (rns_fourstep_intt_lanes,
                                         rns_fourstep_ntt_lanes)
    from gpuntt.reference.fourstep_cpu import intt_input_indices

    import jax

    members = [_member(q, logn, np.uint64) for q in find_ntt_primes(59, logn, 2)]
    plan = RNSFourStepPlan.from_params(members)
    gens = [NTT4StepCPU(p) for p in members]
    mod_idx = np.array([1, 0, 1], dtype=np.int64)
    qs = np.array(plan.qs, dtype=np.uint64)
    x = np.stack([rng.integers(0, qs[m], 1 << logn, dtype=np.uint64)
                  for m in mod_idx])
    n1, n2 = plan.n1, plan.n2
    # the _lanes entry points take the reference's pre-transposed input
    xt = x.reshape(-1, n1, n2).transpose(0, 2, 1).reshape(x.shape)
    got = from_lanes(jax.jit(lambda v, pl: rns_fourstep_ntt_lanes(
        v, pl, mod_idx))(to_lanes(xt, True), plan), True)
    got = got.reshape(-1, n1, n2).transpose(0, 2, 1).reshape(x.shape)
    exp = np.stack([gens[m].ntt(x[b]) for b, m in enumerate(mod_idx)])
    np.testing.assert_array_equal(got, exp)
    perm = exp[:, intt_input_indices(n1, n2)]
    back = from_lanes(jax.jit(lambda v, pl: rns_fourstep_intt_lanes(
        v, pl, mod_idx))(to_lanes(perm, True), plan), True)
    back = back.reshape(-1, n1, n2).transpose(0, 2, 1).reshape(x.shape)
    np.testing.assert_array_equal(back, x)
