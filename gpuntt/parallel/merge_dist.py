"""Distributed merge NTT — butterfly exchange over collective_permute.

The 4-step distribution (fourstep_dist.py) reshards once with an
all_to_all.  This module shards the MERGE transform itself, the second
strategy SURVEY.md §5 calls for: with the coefficient axis sharded over
mesh axis 'sp' (contiguous blocks), the first log2(sp) Cooley-Tukey
stages pair elements on DIFFERENT devices — each stage swaps whole shards
between butterfly partners with one lax.ppermute — and every
remaining stage is shard-local with a per-shard slice of the twiddle
table.  This is the multi-device rendition of the reference's staged
Core kernels, whose kernel-launch boundaries are single-GPU
"communication rounds" (ntt.cu:435-1553): here the rounds are real
collectives.

Key structural facts (both proved by the contiguous-block sharding):
- at cross-device stage s (< log2 sp) ALL elements of a shard share one
  butterfly group, so the twiddle is a per-shard SCALAR, and a shard is
  entirely u-side or entirely v-side;
- at local stage s (>= log2 sp) shard r owns groups
  [r*m/sp, (r+1)*m/sp), a contiguous table slice.

Outputs are bit-identical to the single-device merge engines; the suite
asserts equality on a virtual CPU mesh.

"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.merge_ntt import MergePlan
from ..params.merge import ReductionPolynomial


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


def _dyn_slice(tab, start, size: int):
    return _tmap(lambda a: jax.lax.dynamic_slice_in_dim(a, start, size), tab)


def _dyn_index(tab, idx):
    return _tmap(lambda a: jax.lax.dynamic_index_in_dim(a, idx, keepdims=False),
                 tab)


def _sel(pred, a, b):
    return _tmap(lambda x, y: jnp.where(pred, x, y), a, b)


def _cross_stage_fwd(x, w, ws, is_u, dist: int, sp: int, ops):
    """One cross-device CT stage: swap shards with the butterfly partner,
    then u' = u + w*v on u-side shards / v' = u - w*v on v-side."""
    perm = [(i, i ^ dist) for i in range(sp)]
    other = _tmap(lambda a: jax.lax.ppermute(a, "sp", perm), x)
    u = _sel(is_u, x, other)
    v = _sel(is_u, other, x)
    wv = ops["mulc"](v, w, ws)
    return _sel(is_u, ops["add"](u, wv), ops["sub"](u, wv))


def _cross_stage_inv(x, w, ws, is_u, dist: int, sp: int, ops):
    """GS mirror: u' = u + v ; v' = (u - v) * w."""
    perm = [(i, i ^ dist) for i in range(sp)]
    other = _tmap(lambda a: jax.lax.ppermute(a, "sp", perm), x)
    u = _sel(is_u, x, other)
    v = _sel(is_u, other, x)
    return _sel(is_u, ops["add"](u, v), ops["mulc"](ops["sub"](u, v), w, ws))


def _local_ct(x, table, shoup, ops, s_lo: int, logn: int, logsp: int,
              rank, xnp: bool):
    """CT stages s_lo..logn-1, shard-local, per-shard table slices."""
    n_local = 1 << (logn - logsp)
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    for s in range(s_lo, logn):
        m = 1 << s
        m_loc = m >> logsp
        t = 1 << (logn - s - 1)
        lo = m if xnp else 0
        start = lo + rank * m_loc
        tw = _dyn_slice(table, start, m_loc)
        tws = _dyn_slice(shoup, start, m_loc)
        v = _tmap(lambda a: a.reshape(lead + (m_loc, 2, t)), x)
        u_part = _tmap(lambda a: a[..., 0, :], v)
        tw_b = _tmap(lambda a: a[..., :, None], tw)
        tws_b = _tmap(lambda a: a[..., :, None], tws)
        v_part = ops["mulc"](_tmap(lambda a: a[..., 1, :], v), tw_b, tws_b)
        hi = ops["add"](u_part, v_part)
        lo_o = ops["sub"](u_part, v_part)
        x = _tmap(lambda a, b: jnp.stack([a, b], axis=-2).reshape(
            lead + (n_local,)), hi, lo_o)
    return x


def _local_gs(x, table, shoup, ops, s_lo: int, logn: int, logsp: int,
              rank, xnp: bool):
    """GS stages logn-1..s_lo (descending), shard-local."""
    n_local = 1 << (logn - logsp)
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    for s in range(logn - 1, s_lo - 1, -1):
        h = 1 << s
        h_loc = h >> logsp
        t = 1 << (logn - s - 1)
        lo = h if xnp else 0
        start = lo + rank * h_loc
        tw = _dyn_slice(table, start, h_loc)
        tws = _dyn_slice(shoup, start, h_loc)
        v = _tmap(lambda a: a.reshape(lead + (h_loc, 2, t)), x)
        u_part = _tmap(lambda a: a[..., 0, :], v)
        v_part = _tmap(lambda a: a[..., 1, :], v)
        tw_b = _tmap(lambda a: a[..., :, None], tw)
        tws_b = _tmap(lambda a: a[..., :, None], tws)
        hi = ops["add"](u_part, v_part)
        lo_o = ops["mulc"](ops["sub"](u_part, v_part), tw_b, tws_b)
        x = _tmap(lambda a, b: jnp.stack([a, b], axis=-2).reshape(
            lead + (n_local,)), hi, lo_o)
    return x


def _cross_w(plan: MergePlan, table, shoup, s: int, logsp: int, rank,
             xnp: bool):
    """Per-shard scalar twiddle for cross-device stage s: group
    g = rank >> (logsp - s), table index lo + g."""
    g = rank >> (logsp - s)
    lo = (1 << s) if xnp else 0
    w = _dyn_index(table, lo + g)
    ws = _dyn_index(shoup, lo + g)
    return w, ws


def _shard_fwd(x, plan: MergePlan, sp: int, xnp: bool):
    logsp = sp.bit_length() - 1
    rank = jax.lax.axis_index("sp")
    ops = plan.ops()
    for s in range(logsp):
        dist = sp >> (s + 1)
        is_u = (rank // dist) % 2 == 0
        w, ws = _cross_w(plan, plan.fwd_table, plan.fwd_shoup, s, logsp,
                         rank, xnp)
        x = _cross_stage_fwd(x, w, ws, is_u, dist, sp, ops)
    return _local_ct(x, plan.fwd_table, plan.fwd_shoup, ops, logsp,
                     plan.logn, logsp, rank, xnp)


def _shard_inv(x, plan: MergePlan, sp: int, xnp: bool, scale: bool):
    logsp = sp.bit_length() - 1
    rank = jax.lax.axis_index("sp")
    ops = plan.ops()
    x = _local_gs(x, plan.inv_table, plan.inv_shoup, ops, logsp,
                  plan.logn, logsp, rank, xnp)
    for s in range(logsp - 1, -1, -1):
        dist = sp >> (s + 1)
        is_u = (rank // dist) % 2 == 0
        w, ws = _cross_w(plan, plan.inv_table, plan.inv_shoup, s, logsp,
                         rank, xnp)
        x = _cross_stage_inv(x, w, ws, is_u, dist, sp, ops)
    if scale:
        x = ops["mulc"](x, plan.n_inv_rep, plan.n_inv_shoup)
    return x


def dist_merge_ntt(x, plan: MergePlan, mesh: Mesh):
    """Forward merge NTT with the coefficient axis sharded over 'sp'.

    x: lane representation of (batch, N) with N sharded P(None, 'sp')
    (and batch optionally over 'dp').  Bit-identical to merge_ntt_lanes.
    Pass the plan through your jit as an ARGUMENT at big rings."""
    sp = mesh.shape["sp"]
    xnp = plan.reduction_poly == ReductionPolynomial.X_N_plus
    spec = P("dp", "sp") if "dp" in mesh.shape else P(None, "sp")
    f = jax.shard_map(
        partial(_shard_fwd, plan=plan, sp=sp, xnp=xnp),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False,
    )
    return f(x)


def dist_merge_intt(x, plan: MergePlan, mesh: Mesh, scale: bool = True):
    """Inverse merge NTT (GS), coefficient-sharded; n^-1 fused last."""
    sp = mesh.shape["sp"]
    xnp = plan.reduction_poly == ReductionPolynomial.X_N_plus
    spec = P("dp", "sp") if "dp" in mesh.shape else P(None, "sp")
    f = jax.shard_map(
        partial(_shard_inv, plan=plan, sp=sp, xnp=xnp, scale=scale),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False,
    )
    return f(x)
