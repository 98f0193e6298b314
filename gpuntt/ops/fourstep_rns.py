"""RNS (multi-modulus) 4-step NTT — GPU_4STEP_NTT RNS-overload parity.

The reference's 4-step kernels all carry RNS variants that pick their
tables with `q_index = block_y % mod_count` (ntt_4step.cu:81-82) and
the host dispatch has a dedicated RNS overload (ntt_4step.cu:2293-2765).
Here the per-batch modulus schedule is a static `mod_idx` array and the
stacked per-modulus tables are gathered once per call (jnp take on the
leading axis); the column/row stage sweeps and the W product then run
with per-batch twiddles and per-batch q broadcast over the matrix axes.

Calling conventions mirror ops/fourstep.py exactly: `_lanes` functions
take input pre-transposed (n2, n1) flattened (forward) or pre-permuted
by intt_first_transpose (inverse) and omit the outer transposes
(pipeline doc ntt_4step.cuh:68-74); `_full` functions bundle the whole
pipeline.  Outputs are bit-identical to running each batch row through
the matching member's single-modulus engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..params.bitrev import bitrev_permute
from ..params.fourstep import NTTParameters4Step
from ..reference.fourstep_cpu import intt_input_indices
from . import barrett as bo
from .limb import u64_from_numpy


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


@dataclass(frozen=True)
class RNSFourStepPlan:
    """Stacked per-modulus 4-step tables (leading (mod_count,) axis)."""

    logn: int
    n1: int
    n2: int
    mod_count: int
    is64: bool
    qs: tuple
    q_rep: Any          # (mc,)
    n1_fwd: Any         # (mc, n1)
    n1_fwd_sh: Any
    n2_fwd: Any
    n2_fwd_sh: Any
    n1_inv: Any
    n1_inv_sh: Any
    n2_inv: Any
    n2_inv_sh: Any
    w_fwd: Any          # (mc, n1, n2)
    w_fwd_sh: Any
    w_inv: Any
    w_inv_sh: Any
    n_inv_rep: Any      # (mc,)
    n_inv_shoup: Any
    members: Any = None

    @staticmethod
    def from_params(params: Sequence[NTTParameters4Step]) -> "RNSFourStepPlan":
        p0 = params[0]
        for p in params:
            if (p.logn, p.n1, p.n2, p.dtype) != (p0.logn, p0.n1, p0.n2,
                                                 p0.dtype):
                raise ValueError(
                    "RNS 4-step members must share logn, n1 x n2, and dtype")
        is64 = p0.dtype == np.uint64
        word = 64 if is64 else 32
        rep = (lambda a: u64_from_numpy(np.asarray(a, dtype=np.uint64))) \
            if is64 else (lambda a: jnp.asarray(np.asarray(a, np.uint32)))

        def tab(get):
            ts = [bitrev_permute(get(p)) for p in params]
            sh = [bo.shoup_companion(t, p.modulus.value, word)
                  for t, p in zip(ts, params)]
            return rep(np.stack(ts)), rep(np.stack(sh))

        n1f, n1fs = tab(lambda p: p.n1_based_root_of_unity_table)
        n2f, n2fs = tab(lambda p: p.n2_based_root_of_unity_table)
        n1i, n1is = tab(lambda p: p.n1_based_inverse_root_of_unity_table)
        n2i, n2is = tab(lambda p: p.n2_based_inverse_root_of_unity_table)
        wf = np.stack([p.W_root_of_unity_table.reshape(p.n1, p.n2)
                       for p in params])
        wi = np.stack([p.W_inverse_root_of_unity_table.reshape(p.n1, p.n2)
                       for p in params])
        wfs = np.stack([bo.shoup_companion(w, p.modulus.value, word)
                        for w, p in zip(wf, params)])
        wis = np.stack([bo.shoup_companion(w, p.modulus.value, word)
                        for w, p in zip(wi, params)])
        qs = np.array([p.modulus.value for p in params], dtype=np.uint64)
        ninv = np.array([p.n_inv for p in params], dtype=np.uint64)
        ninv_sh = np.array([(p.n_inv << word) // p.modulus.value
                            for p in params], dtype=np.uint64)
        return RNSFourStepPlan(
            logn=p0.logn, n1=p0.n1, n2=p0.n2, mod_count=len(params),
            is64=is64, qs=tuple(int(q) for q in qs),
            q_rep=rep(qs),
            n1_fwd=n1f, n1_fwd_sh=n1fs, n2_fwd=n2f, n2_fwd_sh=n2fs,
            n1_inv=n1i, n1_inv_sh=n1is, n2_inv=n2i, n2_inv_sh=n2is,
            w_fwd=rep(wf), w_fwd_sh=rep(wfs),
            w_inv=rep(wi), w_inv_sh=rep(wis),
            n_inv_rep=rep(ninv), n_inv_shoup=rep(ninv_sh),
            members=tuple(params),
        )

    def ops(self):
        if self.is64:
            return dict(add=bo.modadd64, sub=bo.modsub64,
                        mulc=bo.shoup_mul64)
        return dict(add=bo.modadd32, sub=bo.modsub32, mulc=bo.shoup_mul32)


jax.tree_util.register_dataclass(
    RNSFourStepPlan,
    data_fields=["q_rep", "n1_fwd", "n1_fwd_sh", "n2_fwd", "n2_fwd_sh",
                 "n1_inv", "n1_inv_sh", "n2_inv", "n2_inv_sh",
                 "w_fwd", "w_fwd_sh", "w_inv", "w_inv_sh",
                 "n_inv_rep", "n_inv_shoup"],
    meta_fields=["logn", "n1", "n2", "mod_count", "is64", "qs", "members"],
)


def _bsel(tree, mod_idx, extra_axes: int):
    """Gather the per-batch table and append broadcast axes."""
    def f(a):
        g = a[mod_idx]
        return g.reshape(g.shape[:1] + (1,) * extra_axes + g.shape[1:])

    return _tmap(f, tree)


def _rns_ct(x, tables, shoup, mod_idx, q_flat, ops, log_size: int):
    """CT sweep along the last axis of (batch, R, n); xnp=False tables,
    per-batch twiddles gathered from the stacked (mc, n) tables."""
    n = 1 << log_size
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    q_b = _tmap(lambda a: a.reshape(a.shape[:1] + (1,) * (len(lead) + 1)),
                q_flat)
    twb = _tmap(lambda a: a[mod_idx], tables)      # (batch, n)
    twsb = _tmap(lambda a: a[mod_idx], shoup)
    for s in range(log_size):
        m = 1 << s
        t = n >> (s + 1)
        tw = _tmap(lambda a: a[:, None, :m, None], twb)   # (b, 1, m, 1)
        tws = _tmap(lambda a: a[:, None, :m, None], twsb)
        v = _tmap(lambda a: a.reshape(lead + (m, 2, t)), x)
        u_part = _tmap(lambda a: a[..., 0, :], v)
        v_part = ops["mulc"](_tmap(lambda a: a[..., 1, :], v), tw, tws, q_b)
        hi_o = ops["add"](u_part, v_part, q_b)
        lo_o = ops["sub"](u_part, v_part, q_b)
        x = _tmap(lambda a, b: jnp.stack([a, b], axis=-2).reshape(
            lead + (n,)), hi_o, lo_o)
    return x


def _rns_gs(x, tables, shoup, mod_idx, q_flat, ops, log_size: int):
    """GS sweep (inverse), per-batch tables, no scaling."""
    n = 1 << log_size
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    q_b = _tmap(lambda a: a.reshape(a.shape[:1] + (1,) * (len(lead) + 1)),
                q_flat)
    twb = _tmap(lambda a: a[mod_idx], tables)
    twsb = _tmap(lambda a: a[mod_idx], shoup)
    for s in range(log_size - 1, -1, -1):
        h = 1 << s
        t = n >> (s + 1)
        tw = _tmap(lambda a: a[:, None, :h, None], twb)
        tws = _tmap(lambda a: a[:, None, :h, None], twsb)
        v = _tmap(lambda a: a.reshape(lead + (h, 2, t)), x)
        u_part = _tmap(lambda a: a[..., 0, :], v)
        v_part = _tmap(lambda a: a[..., 1, :], v)
        hi_o = ops["add"](u_part, v_part, q_b)
        lo_o = ops["mulc"](ops["sub"](u_part, v_part, q_b), tw, tws, q_b)
        x = _tmap(lambda a, b: jnp.stack([a, b], axis=-2).reshape(
            lead + (n,)), hi_o, lo_o)
    return x


def _swap_last2(x):
    return _tmap(lambda a: jnp.swapaxes(a, -1, -2), x)


def rns_fourstep_ntt_lanes(x, plan: RNSFourStepPlan, mod_idx):
    """Forward RNS 4-step on (batch, N) lanes; row b uses modulus
    mod_idx[b].  Input pre-transposed (n2, n1) flat, output (n1, n2)
    flat (GPU_4STEP_NTT convention)."""
    ops = plan.ops()
    mod_idx = np.asarray(mod_idx)
    batch = jax.tree_util.tree_leaves(x)[0].shape[0]
    q_flat = _tmap(lambda a: a[mod_idx], plan.q_rep)
    q3 = _bsel(plan.q_rep, mod_idx, 2)            # (b, 1, 1)
    y = _tmap(lambda a: a.reshape(batch, plan.n2, plan.n1), x)
    y = _rns_ct(y, plan.n1_fwd, plan.n1_fwd_sh, mod_idx, q_flat, ops,
                plan.n1.bit_length() - 1)
    y = _swap_last2(y)                            # (b, n1, n2)
    w = _bsel(plan.w_fwd, mod_idx, 0)
    ws = _bsel(plan.w_fwd_sh, mod_idx, 0)
    y = ops["mulc"](y, w, ws, q3)
    y = _rns_ct(y, plan.n2_fwd, plan.n2_fwd_sh, mod_idx, q_flat, ops,
                plan.n2.bit_length() - 1)
    return _tmap(lambda a: a.reshape(batch, plan.n1 * plan.n2), y)


def rns_fourstep_intt_lanes(x, plan: RNSFourStepPlan, mod_idx,
                            scale: bool = True):
    """Inverse RNS 4-step; input pre-permuted by intt_first_transpose,
    per-batch n^-1 applied last (reference last-kernel placement)."""
    ops = plan.ops()
    mod_idx = np.asarray(mod_idx)
    batch = jax.tree_util.tree_leaves(x)[0].shape[0]
    q_flat = _tmap(lambda a: a[mod_idx], plan.q_rep)
    q3 = _bsel(plan.q_rep, mod_idx, 2)
    y = _tmap(lambda a: a.reshape(batch, plan.n2, plan.n1), x)
    y = _rns_gs(y, plan.n1_inv, plan.n1_inv_sh, mod_idx, q_flat, ops,
                plan.n1.bit_length() - 1)
    y = _swap_last2(y)
    w = _bsel(plan.w_inv, mod_idx, 0)
    ws = _bsel(plan.w_inv_sh, mod_idx, 0)
    y = ops["mulc"](y, w, ws, q3)
    y = _rns_gs(y, plan.n2_inv, plan.n2_inv_sh, mod_idx, q_flat, ops,
                plan.n2.bit_length() - 1)
    if scale:
        ninv = _bsel(plan.n_inv_rep, mod_idx, 2)
        ninv_s = _bsel(plan.n_inv_shoup, mod_idx, 2)
        y = ops["mulc"](y, ninv, ninv_s, q3)
    return _tmap(lambda a: a.reshape(batch, plan.n1 * plan.n2), y)


def rns_fourstep_ntt_full(x, plan: RNSFourStepPlan, mod_idx):
    """Whole forward pipeline incl. both caller-side transposes —
    row b equals NTT_4STEP_CPU::ntt under modulus mod_idx[b]."""
    from .fourstep import transpose_lanes

    x = transpose_lanes(x, plan.n1, plan.n2)
    y = rns_fourstep_ntt_lanes(x, plan, mod_idx)
    return transpose_lanes(y, plan.n1, plan.n2)


def rns_fourstep_intt_full(x, plan: RNSFourStepPlan, mod_idx):
    """Whole inverse pipeline incl. the intt_first_transpose permutation
    and final transpose — row b equals NTT_4STEP_CPU::intt."""
    from .fourstep import transpose_lanes

    idx = intt_input_indices(plan.n1, plan.n2)
    x = _tmap(lambda a: a[..., idx], x)
    y = rns_fourstep_intt_lanes(x, plan, mod_idx)
    return transpose_lanes(y, plan.n1, plan.n2)
