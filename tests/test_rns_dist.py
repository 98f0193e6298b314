"""Distributed RNS 4-step NTT on a virtual 8-device CPU mesh.

No reference counterpart (single-GPU library, transforms-only RNS
surface); correctness target is bit-exactness per batch row vs the
matching member's golden model under the row's modulus schedule.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gpuntt import (Modulus64, NTT4StepCPU, NTTFactors,
                        NTTParameters4Step, ReductionPolynomial)
from gpuntt.arith.host import ntt_root_pair
from gpuntt.models.polymul import DistRNSPolynomialMultiplier
from gpuntt.ops.merge_ntt import from_lanes, to_lanes
from gpuntt.parallel.fourstep_rns_dist import (
    DistRNSFourStepPlan,
    dist_rns_fourstep_intt,
    dist_rns_fourstep_ntt,
)
from gpuntt.parallel.mesh import make_mesh
from gpuntt.reference.schoolbook import schoolbook_poly_multiplication

LOGN = 12
_QS = (576460752303415297, 576460752303439873, 576460752304439297)


def _member(q, logn, poly=ReductionPolynomial.X_N_minus):
    om, psi = ntt_root_pair(q, logn)
    return NTTParameters4Step(
        logn, poly, dtype=np.uint64,
        factors=NTTFactors(Modulus64(q), om, psi))


def _put_sharded(x, mesh, spec):
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, spec)), x)


@pytest.mark.parametrize("dp,sp", [(2, 4), (1, 8)])
def test_dist_rns_fourstep_matches_golden(dp, sp, rng):
    members = [_member(q, LOGN) for q in _QS]
    dplan = DistRNSFourStepPlan.from_members(members)
    p0 = members[0]
    gens = [NTT4StepCPU(p) for p in members]
    mesh = make_mesh(dp=dp, sp=sp)
    batch = 4
    mod_idx = np.arange(batch) % len(members)
    x = np.stack([rng.integers(0, members[m].modulus.value, p0.n,
                               dtype=np.uint64) for m in mod_idx])

    lanes = _put_sharded(to_lanes(x.reshape(batch, p0.n1, p0.n2), True),
                  mesh, P("dp", None, "sp"))
    spec = jax.jit(
        lambda v: dist_rns_fourstep_ntt(v, dplan, mesh, mod_idx))(lanes)
    got = from_lanes(spec, True).reshape(batch, p0.n)
    exp = np.stack([gens[m].ntt(x[b]) for b, m in enumerate(mod_idx)])
    np.testing.assert_array_equal(got, exp)

    back = jax.jit(
        lambda v: dist_rns_fourstep_intt(v, dplan, mesh, mod_idx))(spec)
    got_back = from_lanes(back, True).reshape(batch, p0.n)
    np.testing.assert_array_equal(got_back, x)


def test_dist_rns_polymul_model(rng):
    """Full distributed RNS polymul step: per-row residue products equal
    the per-modulus schoolbook golden."""
    members = [_member(q, LOGN) for q in _QS]
    p0 = members[0]
    mesh = make_mesh(dp=2, sp=4)
    model = DistRNSPolynomialMultiplier(members, mesh)
    batch = 6
    mod_idx = np.arange(batch) % len(members)
    a = np.stack([rng.integers(0, members[m].modulus.value, p0.n,
                               dtype=np.uint64) for m in mod_idx])
    b = np.stack([rng.integers(0, members[m].modulus.value, p0.n,
                               dtype=np.uint64) for m in mod_idx])

    la = _put_sharded(to_lanes(a.reshape(batch, p0.n1, p0.n2), True), mesh,
               P("dp", None, "sp"))
    lb = _put_sharded(to_lanes(b.reshape(batch, p0.n1, p0.n2), True), mesh,
               P("dp", None, "sp"))
    out = jax.jit(lambda u, v: model.step_lanes(u, v, mod_idx))(la, lb)
    got = from_lanes(out, True).reshape(batch, p0.n)
    for r, m in enumerate(mod_idx):
        exp = schoolbook_poly_multiplication(
            a[r], b[r], members[m].modulus, members[m].poly_reduction)
        np.testing.assert_array_equal(got[r], exp)


def test_dist_rns_rejects_local_engine():
    """The stacked device-specific local engines are gone; their selector
    arguments are not accepted any more."""
    members = [_member(q, LOGN) for q in _QS[:2]]
    dplan = DistRNSFourStepPlan.from_members(members)
    mesh = make_mesh(dp=1, sp=8)
    p0 = members[0]
    x = to_lanes(np.zeros((2, p0.n1, p0.n2), dtype=np.uint64), True)
    with pytest.raises(TypeError, match="local_engine"):
        dist_rns_fourstep_ntt(x, dplan, mesh, [0, 1], local_engine="mxu")
    with pytest.raises(TypeError, match="interpret"):
        dist_rns_fourstep_intt(x, dplan, mesh, [0, 1], interpret=True)


def test_dist_rns_rejects_xnp_members():
    bad = _member(_QS[0], LOGN, ReductionPolynomial.X_N_plus)
    with pytest.raises(ValueError):
        DistRNSPolynomialMultiplier([bad], make_mesh(dp=1, sp=8))
