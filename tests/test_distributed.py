"""Distributed 4-step NTT on a virtual 8-device CPU mesh.

No reference counterpart (single-GPU library); correctness target is
bit-exactness vs the single-device engines and the golden model.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gpuntt import NTT4StepCPU, NTTParameters4Step, ReductionPolynomial
from gpuntt.ops.merge_ntt import from_lanes, to_lanes
from gpuntt.parallel.fourstep_dist import (
    DistFourStepPlan,
    dist_fourstep_intt,
    dist_fourstep_ntt,
)
from gpuntt.parallel.mesh import make_mesh


def _put_sharded(x, mesh, spec):
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, spec)), x
    )


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4)])
def test_dist_fourstep_matches_golden(dtype, dp, sp, rng):
    p = NTTParameters4Step(13, ReductionPolynomial.X_N_minus, dtype=dtype)
    dplan = DistFourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    mesh = make_mesh(dp=dp, sp=sp)
    batch = 4
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64).astype(dtype)

    lanes = to_lanes(x.reshape(batch, p.n1, p.n2), dplan.base.is64)
    lanes = _put_sharded(lanes, mesh, P("dp", None, "sp"))
    spec_out = jax.jit(lambda v: dist_fourstep_ntt(v, dplan, mesh))(lanes)

    got = from_lanes(spec_out, dplan.base.is64).reshape(batch, p.n).astype(dtype)
    exp = np.stack([gen.ntt(x[i]) for i in range(batch)])
    np.testing.assert_array_equal(got, exp)

    # inverse: back to the (B, n1, n2) time-domain layout
    back = jax.jit(lambda v: dist_fourstep_intt(v, dplan, mesh))(spec_out)
    got_back = from_lanes(back, dplan.base.is64).reshape(batch, p.n).astype(dtype)
    np.testing.assert_array_equal(got_back, x)


def test_dist_intt_matches_reference_intt(rng):
    """dist INTT inverts the reference spectrum layout exactly: feeding
    NTT_4STEP_CPU::ntt output returns the original input."""
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=np.uint32)
    dplan = DistFourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    mesh = make_mesh(dp=1, sp=8)
    x = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64).astype(np.uint32)
    spec = np.stack([gen.ntt(x[i]) for i in range(2)])

    lanes = to_lanes(spec.reshape(2, p.n2, p.n1), False)
    lanes = _put_sharded(lanes, mesh, P("dp", None, "sp"))
    back = dist_fourstep_intt(lanes, dplan, mesh)
    got = from_lanes(back, False).reshape(2, p.n).astype(np.uint32)
    np.testing.assert_array_equal(got, x)


def test_dist_output_sharding(rng):
    """Output carries the declared sharding (n1 over sp) — the layout
    contract downstream pointwise ops rely on."""
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=np.uint32)
    dplan = DistFourStepPlan.from_params(p)
    mesh = make_mesh(dp=1, sp=8)
    x = rng.integers(0, p.modulus.value, size=(1, p.n), dtype=np.uint64).astype(np.uint32)
    lanes = _put_sharded(to_lanes(x.reshape(1, p.n1, p.n2), False), mesh, P("dp", None, "sp"))
    out = dist_fourstep_ntt(lanes, dplan, mesh)
    shard_shapes = {s.data.shape for s in out.addressable_shards}
    assert shard_shapes == {(1, p.n2, p.n1 // 8)}


def test_dist_pipeline_chunks_bit_exact(rng):
    """pipeline_chunks > 1 (independent per-chunk collective/compute
    chains for XLA overlap, SURVEY §7(e)) changes scheduling freedom,
    never values; odd local batches fall back to one chain."""
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus,
                           dtype=np.uint64)
    dplan = DistFourStepPlan.from_params(p)
    mesh = make_mesh(dp=2, sp=4)
    batch = 8  # local batch 4 -> 2 chunks of 2
    x = rng.integers(0, p.modulus.value, size=(batch, p.n),
                     dtype=np.uint64)
    lanes = to_lanes(x.reshape(batch, p.n1, p.n2), True)
    lanes = _put_sharded(lanes, mesh, P("dp", None, "sp"))

    base = jax.jit(lambda v: dist_fourstep_ntt(v, dplan, mesh))(lanes)
    piped = jax.jit(lambda v: dist_fourstep_ntt(
        v, dplan, mesh, pipeline_chunks=2))(lanes)
    np.testing.assert_array_equal(np.asarray(base.hi), np.asarray(piped.hi))
    np.testing.assert_array_equal(np.asarray(base.lo), np.asarray(piped.lo))

    back = jax.jit(lambda v: dist_fourstep_intt(
        v, dplan, mesh, pipeline_chunks=2))(piped)
    got = from_lanes(back, True).reshape(batch, p.n)
    np.testing.assert_array_equal(got, x)

    # non-dividing chunk count: silent single-chain fallback, same values
    odd = jax.jit(lambda v: dist_fourstep_ntt(
        v, dplan, mesh, pipeline_chunks=3))(lanes)
    np.testing.assert_array_equal(np.asarray(base.hi), np.asarray(odd.hi))


def test_dist_polymul_step_takes_plan_as_argument(rng):
    """DistPolynomialMultiplier.step_lanes runs one jitted program that
    takes the plan as an ARGUMENT: the (n1, n2) W tables never enter it
    as constants (they are hundreds of MB at ring 2^24), and the cyclic
    product matches the 4-step golden model."""
    from functools import partial

    from gpuntt.models.polymul import (DistPolynomialMultiplier,
                                       _dist_polymul_jit)

    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus,
                           dtype=np.uint64)
    mesh = make_mesh(dp=2, sp=4)
    model = DistPolynomialMultiplier(p, mesh)
    batch = 2
    q = p.modulus.value
    a = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    b = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    put = lambda v: _put_sharded(to_lanes(v.reshape(batch, p.n1, p.n2), True),
                          mesh, P("dp", None, "sp"))
    la, lb = put(a), put(b)
    jaxpr = jax.make_jaxpr(partial(_dist_polymul_jit, mesh=mesh, chunks=1))(
        la, lb, model.dplan)
    assert sum(np.asarray(c).nbytes for c in jaxpr.consts
               if hasattr(c, "nbytes")) < p.n
    got = from_lanes(model.step_lanes(la, lb), True).reshape(batch, p.n)
    gen = NTT4StepCPU(p)
    for i in range(batch):
        exp = gen.intt(gen.mult(gen.ntt(a[i]), gen.ntt(b[i])))
        np.testing.assert_array_equal(got[i], exp)


def test_dist_fourstep_rejects_local_engine():
    """The device-specific local engines are gone; their selector arguments are
    not accepted any more."""
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus,
                           dtype=np.uint32)
    dplan = DistFourStepPlan.from_params(p)
    mesh = make_mesh(dp=1, sp=8)
    x = to_lanes(np.zeros((1, p.n1, p.n2), dtype=np.uint32), False)
    with pytest.raises(TypeError, match="local_engine"):
        dist_fourstep_ntt(x, dplan, mesh, local_engine="mxu")
    with pytest.raises(TypeError, match="interpret"):
        dist_fourstep_intt(x, dplan, mesh, interpret=True)
