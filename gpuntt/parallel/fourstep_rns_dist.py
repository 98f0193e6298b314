"""Distributed RNS 4-step NTT — prime-ladder batches over a device mesh.

No reference counterpart twice over: the reference is single-GPU and
its RNS surface is transforms only.  This composes the framework's two
extensions — the n2-sharded distributed 4-step (fourstep_dist.py) and
the stacked-table RNS 4-step (ops/fourstep_rns.py) — so an HE-style
residue batch (row b modulo q_{mod_idx[b]}) runs SPMD:

  per-row-gathered column (n1-point) NTTs are local,
  the per-row W twiddle product is local (stacked W sharded alongside),
  ONE lax.all_to_all reshards n2-sharded -> n1-sharded,
  per-row-gathered row (n2-point) NTTs are local.

The modulus schedule rides the batch axis: `mod_idx` is sharded over
'dp' exactly like the data, so each shard gathers only its own rows'
twiddles from the replicated (mod_count, ...) stacks.  Outputs are
bit-identical to routing each row through the matching member's
single-device engine, which the virtual-mesh tests assert.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import barrett as bo
from ..ops.fourstep_rns import RNSFourStepPlan, _rns_ct, _rns_gs
from ..ops.limb import u64_from_numpy


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


@dataclass(frozen=True)
class DistRNSFourStepPlan:
    """RNSFourStepPlan + the stacked chain-inverse W tables the
    distributed INTT uses (cf. DistFourStepPlan.w_chain_inv)."""

    base: RNSFourStepPlan
    w_chain_inv: Any     # (mc, n1, n2) lanes
    w_chain_inv_sh: Any

    @staticmethod
    def from_members(params) -> "DistRNSFourStepPlan":
        base = RNSFourStepPlan.from_params(params)
        word = 64 if base.is64 else 32
        rep = (lambda a: u64_from_numpy(np.asarray(a, dtype=np.uint64))) \
            if base.is64 else (lambda a: jnp.asarray(np.asarray(a, np.uint32)))
        wci = np.stack([p.W_chain_inverse_table.reshape(p.n1, p.n2)
                        for p in params])
        wcis = np.stack([bo.shoup_companion(w, p.modulus.value, word)
                         for w, p in zip(wci, params)])

        return DistRNSFourStepPlan(
            base=base, w_chain_inv=rep(wci), w_chain_inv_sh=rep(wcis))


def _swap_last2(x):
    return _tmap(lambda a: jnp.swapaxes(a, -1, -2), x)


def _q3(plan: RNSFourStepPlan, mi):
    return _tmap(lambda a: a[mi].reshape((-1, 1, 1)), plan.q_rep)


def _local_fwd(x, mi, w, ws, plan: RNSFourStepPlan):
    """Per-shard forward; x: (B/dp, n1, n2/sp), mi: (B/dp,)."""
    ops = plan.ops()
    log_n1 = plan.n1.bit_length() - 1
    log_n2 = plan.n2.bit_length() - 1
    q_flat = _tmap(lambda a: a[mi], plan.q_rep)

    v = _swap_last2(x)                                   # (B, n2/sp, n1)
    v = _rns_ct(v, plan.n1_fwd, plan.n1_fwd_sh, mi, q_flat, ops, log_n1)
    v = _swap_last2(v)                                   # (B, n1, n2/sp)
    wv = _tmap(lambda a: a[mi], w)
    wvs = _tmap(lambda a: a[mi], ws)
    v = ops["mulc"](v, wv, wvs, _q3(plan, mi))
    v = _tmap(
        lambda a: jax.lax.all_to_all(a, "sp", split_axis=1, concat_axis=2,
                                     tiled=True), v)     # (B, n1/sp, n2)
    v = _rns_ct(v, plan.n2_fwd, plan.n2_fwd_sh, mi, q_flat, ops, log_n2)
    return _tmap(lambda a: jnp.swapaxes(a, 1, 2), v)     # (B, n2, n1/sp)


def _local_inv(s, mi, wci, wcis, plan: RNSFourStepPlan):
    """Per-shard inverse; s: (B/dp, n2, n1/sp) -> (B/dp, n1, n2/sp)."""
    ops = plan.ops()
    log_n1 = plan.n1.bit_length() - 1
    log_n2 = plan.n2.bit_length() - 1
    q_flat = _tmap(lambda a: a[mi], plan.q_rep)
    q3 = _q3(plan, mi)

    v = _tmap(lambda a: jnp.swapaxes(a, 1, 2), s)        # (B, n1/sp, n2)
    v = _rns_gs(v, plan.n2_inv, plan.n2_inv_sh, mi, q_flat, ops, log_n2)
    v = _tmap(
        lambda a: jax.lax.all_to_all(a, "sp", split_axis=2, concat_axis=1,
                                     tiled=True), v)     # (B, n1, n2/sp)
    v = ops["mulc"](v, _tmap(lambda a: a[mi], wci),
                    _tmap(lambda a: a[mi], wcis), q3)
    v = _swap_last2(v)
    v = _rns_gs(v, plan.n1_inv, plan.n1_inv_sh, mi, q_flat, ops, log_n1)
    v = _swap_last2(v)
    ninv = _tmap(lambda a: a[mi].reshape((-1, 1, 1)), plan.n_inv_rep)
    ninv_s = _tmap(lambda a: a[mi].reshape((-1, 1, 1)), plan.n_inv_shoup)
    return ops["mulc"](v, ninv, ninv_s, q3)


def _mi_arr(mod_idx):
    return jnp.asarray(np.asarray(mod_idx), jnp.int32)


def dist_rns_fourstep_ntt(x, dplan: DistRNSFourStepPlan, mesh: Mesh,
                          mod_idx):
    """Forward distributed RNS 4-step NTT.

    x: lane rep of shape (B, n1, n2), sharded P('dp', None, 'sp');
    mod_idx: (B,) modulus schedule (row b modulo members[mod_idx[b]]).
    Returns the (B, n2, n1) spectrum sharded P('dp', None, 'sp'),
    row b bit-identical to the single-device RNS engine under the same
    schedule."""
    plan = dplan.base
    f = jax.shard_map(
        lambda v, m, w, ws: _local_fwd(v, m, w, ws, plan),
        mesh=mesh,
        in_specs=(P("dp", None, "sp"), P("dp"),
                  P(None, None, "sp"), P(None, None, "sp")),
        out_specs=P("dp", None, "sp"),
        check_vma=False,
    )
    return f(x, _mi_arr(mod_idx), plan.w_fwd, plan.w_fwd_sh)


def dist_rns_fourstep_intt(s, dplan: DistRNSFourStepPlan, mesh: Mesh,
                           mod_idx):
    """Inverse distributed RNS 4-step: exact inverse of
    dist_rns_fourstep_ntt under the same schedule, per-row n^-1 in the
    final stage (reference last-kernel placement)."""
    plan = dplan.base
    f = jax.shard_map(
        lambda v, m, w, ws: _local_inv(v, m, w, ws, plan),
        mesh=mesh,
        in_specs=(P("dp", None, "sp"), P("dp"),
                  P(None, None, "sp"), P(None, None, "sp")),
        out_specs=P("dp", None, "sp"),
        check_vma=False,
    )
    return f(s, _mi_arr(mod_idx), dplan.w_chain_inv, dplan.w_chain_inv_sh)
