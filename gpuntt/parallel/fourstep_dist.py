"""Distributed 4-step NTT over a device mesh.

The reference's 4-step method runs on one GPU with kernel-launch
boundaries as its only "communication rounds" (ntt_4step.cu:2293-3260).
Here the same N = n1 x n2 decomposition becomes the multi-device sharding
backbone (SURVEY.md §5): with the n2 axis sharded over mesh axis "sp",

  column (n1-point) NTTs are local,
  the W twiddle product is local (W sharded alongside),
  one lax.all_to_all reshards n2-sharded -> n1-sharded
    (the distributed transpose; replaces Transpose_Batch,
     ntt_4step.cu:36-56),
  row (n2-point) NTTs are local.

Batch parallelism rides mesh axis "dp" with zero communication.

Forward maps (B, n1, n2)[n2@sp] -> (B, n2, n1)[n1@sp]; the inverse runs
the mathematical inverse chain (GS stages + elementwise W^-1 with the
forward index pattern + single n^-1) back to (B, n1, n2)[n2@sp].
Exact integer arithmetic makes both bit-identical to the single-device
engines, which the tests assert on a virtual mesh.

Local transforms are the butterfly stage sweeps of the single-device
engines (ops/merge_ntt.py ct_stages/gs_stages).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..params.fourstep import NTTParameters4Step
from ..ops import barrett as bo
from ..ops.fourstep import FourStepPlan
from ..ops.limb import u64_from_numpy
from ..ops.merge_ntt import ct_stages, gs_stages


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


@dataclass(frozen=True)
class DistFourStepPlan:
    """FourStepPlan + the chain-inverse W table the distributed INTT
    uses."""

    base: FourStepPlan
    w_chain_inv: Any  # (n1, n2) lanes, elementwise inverse of w_fwd
    w_chain_inv_sh: Any

    @staticmethod
    def from_params(p: NTTParameters4Step) -> "DistFourStepPlan":
        base = FourStepPlan.from_params(p)
        q = p.modulus.value
        word = 64 if base.is64 else 32
        wci = p.W_chain_inverse_table.reshape(p.n1, p.n2)
        if base.is64:
            rep = lambda a: u64_from_numpy(np.asarray(a, dtype=np.uint64))
        else:
            rep = lambda a: jnp.asarray(np.asarray(a, dtype=np.uint32))

        return DistFourStepPlan(
            base=base,
            w_chain_inv=rep(wci),
            w_chain_inv_sh=rep(bo.shoup_companion(wci, q, word)),
        )


# Registered pytree: at rings 2^20-2^24 the W tables run to hundreds of
# MB, so the dist plan should enter a compiled step as a jit ARGUMENT —
# closed over, those tables inline into the HLO as constants.
jax.tree_util.register_dataclass(
    DistFourStepPlan,
    data_fields=["base", "w_chain_inv", "w_chain_inv_sh"],
    meta_fields=[],
)


def _ntt_axis1(v, table, shoup, ops_, log_size):
    """CT stages along axis -2 (columns): swap, sweep, swap back."""
    v = _tmap(lambda a: jnp.swapaxes(a, -1, -2), v)
    v = ct_stages(v, table, shoup, ops_, log_size, xnp=False)
    return _tmap(lambda a: jnp.swapaxes(a, -1, -2), v)


def _intt_axis1(v, table, shoup, ops_, log_size):
    v = _tmap(lambda a: jnp.swapaxes(a, -1, -2), v)
    v = gs_stages(v, table, shoup, ops_, log_size, xnp=False)
    return _tmap(lambda a: jnp.swapaxes(a, -1, -2), v)


def _local_fwd(x, w, ws, plan: FourStepPlan):
    """Per-shard forward: local column NTT + local W product + all_to_all
    + local row NTT.  Runs inside shard_map; x: (B/dp, n1, n2/sp)."""
    ops_ = plan.ops()
    log_n1 = plan.n1.bit_length() - 1
    log_n2 = plan.n2.bit_length() - 1
    v = _ntt_axis1(x, plan.n1_fwd, plan.n1_fwd_sh, ops_, log_n1)
    v = ops_["mulc"](v, w, ws)
    # distributed transpose: split n1 (axis 1) across sp, gather n2 (axis 2)
    v = _tmap(
        lambda a: jax.lax.all_to_all(a, "sp", split_axis=1, concat_axis=2, tiled=True),
        v,
    )
    v = ct_stages(v, plan.n2_fwd, plan.n2_fwd_sh, ops_, log_n2, xnp=False)
    # output matrix layout (n2, n1): local swap turns (B, n1/sp, n2) into
    # (B, n2, n1/sp) == global (B, n2, n1) sharded on the n1 axis.
    return _tmap(lambda a: jnp.swapaxes(a, 1, 2), v)


def _local_inv(s, wci, wcis, plan: FourStepPlan):
    """Per-shard inverse chain; s: (B/dp, n2, n1/sp) -> (B/dp, n1, n2/sp)."""
    ops_ = plan.ops()
    log_n1 = plan.n1.bit_length() - 1
    log_n2 = plan.n2.bit_length() - 1
    v = _tmap(lambda a: jnp.swapaxes(a, 1, 2), s)  # (B, n1/sp, n2)
    v = gs_stages(v, plan.n2_inv, plan.n2_inv_sh, ops_, log_n2, xnp=False)
    # reshard n1-sharded -> n2-sharded (reverse all_to_all)
    v = _tmap(
        lambda a: jax.lax.all_to_all(a, "sp", split_axis=2, concat_axis=1, tiled=True),
        v,
    )
    v = ops_["mulc"](v, wci, wcis)
    v = _intt_axis1(v, plan.n1_inv, plan.n1_inv_sh, ops_, log_n1)
    return ops_["mulc"](v, plan.n_inv_rep, plan.n_inv_shoup)


def _chunked(fn, v, chunks: int):
    """Run fn over `chunks` independent batch slices (unrolled) and
    re-concatenate.  Each slice's all_to_all then has no data dependence
    on the other slices' local NTTs, so XLA's latency-hiding scheduler
    is free to overlap one chunk's collective with another's compute —
    the interconnect/compute overlap of SURVEY.md §7 hard part (e).  Bit-exact by
    construction (pure batch split)."""
    leaves = jax.tree_util.tree_leaves(v)
    b = leaves[0].shape[0]
    if chunks <= 1 or b % chunks:
        return fn(v)
    step = b // chunks
    outs = [fn(_tmap(lambda a: a[c * step:(c + 1) * step], v))
            for c in range(chunks)]
    return _tmap(lambda *xs: jnp.concatenate(xs, axis=0), *outs)


def dist_fourstep_ntt(x, dplan: DistFourStepPlan, mesh: Mesh,
                      pipeline_chunks: int = 1):
    """Forward distributed 4-step NTT.

    x: lane rep of shape (B, n1, n2), sharded P('dp', None, 'sp').
    Returns the (B, n2, n1) spectrum (reference natural output layout,
    cf. NTT_4STEP_CPU::ntt final transpose), sharded P('dp', None, 'sp').
    pipeline_chunks > 1 splits the per-shard batch into that many
    independent column-NTT -> all_to_all -> row-NTT chains so the
    compiler can overlap collectives with compute (no-op when the local
    batch does not divide evenly).
    """
    plan = dplan.base
    f = jax.shard_map(
        lambda v, w, ws: _chunked(
            lambda u: _local_fwd(u, w, ws, plan), v, pipeline_chunks),
        mesh=mesh,
        in_specs=(P("dp", None, "sp"), P(None, "sp"), P(None, "sp")),
        out_specs=P("dp", None, "sp"),
        check_vma=False,
    )
    return f(x, plan.w_fwd, plan.w_fwd_sh)


def dist_fourstep_intt(s, dplan: DistFourStepPlan, mesh: Mesh,
                       pipeline_chunks: int = 1):
    """Inverse distributed 4-step NTT: (B, n2, n1)[P('dp',None,'sp')] ->
    (B, n1, n2)[P('dp',None,'sp')]; exact inverse of dist_fourstep_ntt.
    pipeline_chunks as in dist_fourstep_ntt."""
    plan = dplan.base
    f = jax.shard_map(
        lambda v, w, ws: _chunked(
            lambda u: _local_inv(u, w, ws, plan), v, pipeline_chunks),
        mesh=mesh,
        in_specs=(P("dp", None, "sp"), P(None, "sp"), P(None, "sp")),
        out_specs=P("dp", None, "sp"),
        check_vma=False,
    )
    return f(s, dplan.w_chain_inv, dplan.w_chain_inv_sh)
