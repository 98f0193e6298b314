"""XLA merge-NTT engine vs the golden model — bit-exact parity.

Covers the cells of the reference's gpu_merge_ntt/intt_examples
(test_merge_ntt.cu / test_merge_intt.cu section 1): logn sweep, batch,
both dtypes, both reduction polynomials, forward + inverse + roundtrip.
"""

import numpy as np
import pytest

import jax

from gpuntt import NTTCPU, NTTParameters, ReductionPolynomial
from gpuntt.ops.merge_ntt import (
    MergePlan,
    from_lanes,
    merge_intt_lanes,
    merge_ntt_lanes,
    to_lanes,
)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
@pytest.mark.parametrize("logn", [2, 5, 9, 12])
def test_forward_parity(dtype, poly, logn, rng):
    p = NTTParameters(logn, poly, dtype=dtype)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    batch = 3
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64).astype(dtype)

    got = from_lanes(
        jax.jit(lambda v: merge_ntt_lanes(v, plan))(to_lanes(x, plan.is64)),
        plan.is64,
    ).astype(dtype)
    exp = np.stack([gen.ntt(x[i]) for i in range(batch)])
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
@pytest.mark.parametrize("logn", [2, 5, 9, 12])
def test_inverse_parity(dtype, poly, logn, rng):
    p = NTTParameters(logn, poly, dtype=dtype)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    x = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64).astype(dtype)

    got = from_lanes(
        jax.jit(lambda v: merge_intt_lanes(v, plan))(to_lanes(x, plan.is64)),
        plan.is64,
    ).astype(dtype)
    exp = np.stack([gen.intt(x[i]) for i in range(2)])
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_roundtrip(dtype, rng):
    p = NTTParameters(10, ReductionPolynomial.X_N_plus, dtype=dtype)
    plan = MergePlan.from_params(p)
    x = rng.integers(0, p.modulus.value, size=(4, p.n), dtype=np.uint64).astype(dtype)
    lanes = to_lanes(x, plan.is64)
    back = from_lanes(
        merge_intt_lanes(merge_ntt_lanes(lanes, plan), plan), plan.is64
    ).astype(dtype)
    np.testing.assert_array_equal(back, x)
