"""4-step engine parity vs golden model.

Mirrors gpu_4step_ntt_examples / gpu_4step_intt_examples
(test_4step_ntt.cu:147-178, test_4step_intt.cu:83-88, :151-179):
the GPU-convention core (caller-side transposes) and the full pipeline
must be bit-exact vs NTT_4STEP_CPU.
"""

import numpy as np
import pytest

import jax

from gpuntt import (
    NTT4StepCPU,
    NTTParameters4Step,
    ReductionPolynomial,
)
from gpuntt.ops.fourstep import (
    FourStepPlan,
    fourstep_intt_full,
    fourstep_intt_lanes,
    fourstep_ntt_full,
    fourstep_ntt_lanes,
    transpose_lanes,
)
from gpuntt.ops.merge_ntt import from_lanes, to_lanes


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("logn", [12, 13])
def test_fourstep_forward_parity(dtype, logn, rng):
    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=dtype)
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    batch = 2
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64).astype(dtype)

    got = from_lanes(
        jax.jit(lambda v: fourstep_ntt_full(v, plan))(to_lanes(x, plan.is64)),
        plan.is64,
    ).astype(dtype)
    exp = np.stack([gen.ntt(x[i]) for i in range(batch)])
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("logn", [12, 13])
def test_fourstep_inverse_parity(dtype, logn, rng):
    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=dtype)
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    x = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64).astype(dtype)

    got = from_lanes(
        jax.jit(lambda v: fourstep_intt_full(v, plan))(to_lanes(x, plan.is64)),
        plan.is64,
    ).astype(dtype)
    exp = np.stack([gen.intt(x[i]) for i in range(2)])
    np.testing.assert_array_equal(got, exp)


def test_gpu_calling_convention(rng):
    """The lanes-core matches the reference's caller-wrapped pipeline:
    GPU_Transpose -> GPU_4STEP_NTT -> GPU_Transpose (test_4step_ntt.cu:147-154)."""
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=np.uint32)
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    x = rng.integers(0, p.modulus.value, size=p.n, dtype=np.uint64).astype(np.uint32)

    lanes = to_lanes(x, False)
    pre = transpose_lanes(lanes, p.n1, p.n2)
    core = fourstep_ntt_lanes(pre, plan)
    out = from_lanes(transpose_lanes(core, p.n1, p.n2), False).astype(np.uint32)
    np.testing.assert_array_equal(out, gen.ntt(x))

    # inverse: CPU-side intt_first_transpose pre-permute, then core, then transpose
    y = gen.ntt(x)
    pre_i = to_lanes(gen.intt_first_transpose(y), False)
    core_i = fourstep_intt_lanes(pre_i, plan)
    out_i = from_lanes(transpose_lanes(core_i, p.n1, p.n2), False).astype(np.uint32)
    np.testing.assert_array_equal(out_i, x)


def test_fourstep_roundtrip_u64(rng):
    p = NTTParameters4Step(14, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    plan = FourStepPlan.from_params(p)
    x = rng.integers(0, p.modulus.value, size=(3, p.n), dtype=np.uint64)
    lanes = to_lanes(x, True)
    back = from_lanes(
        jax.jit(lambda v: fourstep_intt_full(fourstep_ntt_full(v, plan), plan))(lanes),
        True,
    )
    np.testing.assert_array_equal(back, x)


def test_custom_dims_factorization(rng):
    """The `dims` extension (no reference counterpart): an
    explicit n1 x n2 override evaluates the same polynomial at the same
    points (a permuted spectrum — each split is its own output
    convention), inverts exactly, keeps pointwise products
    order-independent, and the engines stay bit-exact vs the same-dims
    golden."""
    p_def = NTTParameters4Step(13, ReductionPolynomial.X_N_minus,
                               dtype=np.uint64)
    p_cus = NTTParameters4Step(13, ReductionPolynomial.X_N_minus,
                               dtype=np.uint64, dims=(64, 128))
    assert (p_cus.n1, p_cus.n2) == (64, 128) != (p_def.n1, p_def.n2)
    x = rng.integers(0, p_def.modulus.value, size=(2, p_def.n),
                     dtype=np.uint64)
    gen_def, gen_cus = NTT4StepCPU(p_def), NTT4StepCPU(p_cus)
    exp_def = np.stack([gen_def.ntt(x[i]) for i in range(2)])
    got = np.stack([gen_cus.ntt(x[i]) for i in range(2)])
    # the spectrum ORDER is factorization-dependent (each split is its
    # own output convention, exactly as the reference's convention is
    # its table's); the values are the same evaluation multiset and the
    # pair inverts exactly
    assert not np.array_equal(got, exp_def)
    np.testing.assert_array_equal(np.sort(got, axis=1),
                                  np.sort(exp_def, axis=1))
    np.testing.assert_array_equal(
        np.stack([gen_cus.intt(got[i]) for i in range(2)]), x)
    # pointwise products are order-independent: polymul through the
    # custom split equals polymul through the default split
    y = rng.integers(0, p_def.modulus.value, size=(2, p_def.n),
                     dtype=np.uint64)
    prod_def = np.stack([
        gen_def.intt(gen_def.mult(gen_def.ntt(x[i]), gen_def.ntt(y[i])))
        for i in range(2)])
    prod_cus = np.stack([
        gen_cus.intt(gen_cus.mult(gen_cus.ntt(x[i]), gen_cus.ntt(y[i])))
        for i in range(2)])
    np.testing.assert_array_equal(prod_cus, prod_def)
    # engine parity + roundtrip on the custom split (the engines must be
    # bit-exact vs the SAME-dims golden for any valid split)
    plan = FourStepPlan.from_params(p_cus)
    lanes = to_lanes(x, True)
    spec = from_lanes(
        jax.jit(lambda v: fourstep_ntt_full(v, plan))(lanes), True)
    np.testing.assert_array_equal(spec, got)
    back = from_lanes(
        jax.jit(lambda v: fourstep_intt_full(fourstep_ntt_full(v, plan),
                                             plan))(lanes), True)
    np.testing.assert_array_equal(back, x)


def test_invalid_dims_rejected():
    import pytest as _pytest

    from gpuntt.common.errors import NTTError

    for dims in ((48, 128), (64, 64), (1, 8192)):
        with _pytest.raises((NTTError, AssertionError)):
            NTTParameters4Step(13, ReductionPolynomial.X_N_minus,
                               dtype=np.uint64, dims=dims)


@pytest.mark.parametrize("logn", range(14, 21))
def test_fourstep_engine_at_former_kernel_sizes(logn, rng):
    """The 4-step engine over the range a dedicated u64 device kernel
    used to own (2^14 and up), through the whole pipeline: forward
    bit-exact vs NTT_4STEP_CPU (native core) and an exact inverse."""
    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus,
                           dtype=np.uint64)
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    x = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64)
    spec = jax.jit(fourstep_ntt_full)(to_lanes(x, True), plan)
    got = from_lanes(spec, True)
    np.testing.assert_array_equal(got, np.stack([gen.ntt(r) for r in x]))
    back = from_lanes(jax.jit(fourstep_intt_full)(spec, plan), True)
    np.testing.assert_array_equal(back, x)
