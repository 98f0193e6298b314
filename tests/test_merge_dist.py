"""Distributed merge NTT (collective_permute butterfly exchange) parity.

Coefficient-sharded merge transforms must be bit-identical to the
single-device engine on the virtual CPU mesh, for both reduction
polynomials, both dtypes, forward and inverse — including the batch
axis riding 'dp'.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gpuntt import NTTParameters, ReductionPolynomial
from gpuntt.ops.merge_ntt import (MergePlan, from_lanes, merge_intt_lanes,
                                      merge_ntt_lanes, to_lanes)
from gpuntt.parallel.merge_dist import dist_merge_intt, dist_merge_ntt
from gpuntt.parallel.mesh import make_mesh


@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_dist_merge_parity(poly, dtype, rng):
    p = NTTParameters(10, poly, dtype=dtype)
    plan = MergePlan.from_params(p)
    mesh = make_mesh(dp=2, sp=4)
    batch = 4
    x = rng.integers(0, p.modulus.value, size=(batch, p.n),
                     dtype=np.uint64).astype(dtype)
    sh = NamedSharding(mesh, P("dp", "sp"))
    lanes = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh), to_lanes(x, plan.is64))

    got = from_lanes(jax.jit(
        lambda v: dist_merge_ntt(v, plan, mesh))(lanes), plan.is64)
    exp = from_lanes(jax.jit(
        lambda v: merge_ntt_lanes(v, plan))(to_lanes(x, plan.is64)), plan.is64)
    np.testing.assert_array_equal(got, exp)

    lanes_f = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh), to_lanes(exp.astype(dtype), plan.is64))
    got_i = from_lanes(jax.jit(
        lambda v: dist_merge_intt(v, plan, mesh))(lanes_f), plan.is64)
    np.testing.assert_array_equal(got_i.astype(dtype), x)


def test_dist_merge_sp1_degenerate(rng):
    """sp=1 runs zero collectives and equals the engine exactly."""
    p = NTTParameters(9, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    plan = MergePlan.from_params(p)
    mesh = make_mesh(dp=1, sp=1)
    x = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64)
    sh = NamedSharding(mesh, P("dp", "sp"))
    lanes = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh), to_lanes(x, True))
    got = from_lanes(jax.jit(
        lambda v: dist_merge_ntt(v, plan, mesh))(lanes), True)
    exp = from_lanes(jax.jit(
        lambda v: merge_ntt_lanes(v, plan))(to_lanes(x, True)), True)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2)])
def test_dist_merge_plan_as_jit_argument(dp, sp, rng):
    """The plan rides through the caller's jit as an ARGUMENT (its
    tables become runtime buffers, not HLO constants) on every mesh
    shape, and the result stays bit-identical to the single-device
    engine — 1, 2 and 3 cross-device butterfly stages."""
    p = NTTParameters(11, ReductionPolynomial.X_N_plus, dtype=np.uint64)
    plan = MergePlan.from_params(p)
    mesh = make_mesh(dp=dp, sp=sp)
    x = rng.integers(0, p.modulus.value, size=(2 * dp, p.n), dtype=np.uint64)
    sh = NamedSharding(mesh, P("dp", "sp"))
    lanes = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh), to_lanes(x, True))
    fwd = jax.jit(lambda v, pl: dist_merge_ntt(v, pl, mesh))
    jaxpr = jax.make_jaxpr(lambda v, pl: dist_merge_ntt(v, pl, mesh))(
        lanes, plan)
    assert sum(np.asarray(c).nbytes for c in jaxpr.consts
               if hasattr(c, "nbytes")) < (1 << 12)
    got = fwd(lanes, plan)
    exp = from_lanes(jax.jit(merge_ntt_lanes)(to_lanes(x, True), plan), True)
    np.testing.assert_array_equal(from_lanes(got, True), exp)
    back = jax.jit(lambda v, pl: dist_merge_intt(v, pl, mesh))(got, plan)
    np.testing.assert_array_equal(from_lanes(back, True), x)


def test_dist_merge_rejects_local_engine():
    """The device-specific local-tail engines are gone: the old selector
    arguments are not accepted any more."""
    p = NTTParameters(9, ReductionPolynomial.X_N_plus, dtype=np.uint64)
    plan = MergePlan.from_params(p)
    mesh = make_mesh(dp=1, sp=4)
    x = to_lanes(np.zeros((1, p.n), dtype=np.uint64), True)
    with pytest.raises(TypeError, match="local_engine"):
        dist_merge_ntt(x, plan, mesh, local_engine="mxu")
    with pytest.raises(TypeError, match="interpret"):
        dist_merge_intt(x, plan, mesh, interpret=True)
