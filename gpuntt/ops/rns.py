"""RNS (multi-modulus) and ordered transform variants.

Rebuild of the reference's RNS kernel/host families:

- plain RNS (batch b uses modulus b % mod_count): ntt.cu:2560-3059,
  semantics doc ntt.cuh:346-401;
- GPU_NTT_Modulus_Ordered (mod index = order[b % mod_count]):
  ntt.cu:3103-3768, doc ntt.cuh:468-494;
- GPU_NTT_Poly_Ordered (poly order[b] transformed in place at position
  order[b] with modulus b % mod_count — load/store address uses
  order[b] << N_power, ntt.cu:3815/3929, while mod_index = b %
  mod_count, ntt.cu:3797): ntt.cu:3782-4459, doc ntt.cuh:554-591.

Where CUDA needs four more kernel families, this build expresses all
of these as *gathers of per-batch constants* feeding the same butterfly
stages: twiddle tables are stacked (mod_count, size) and each stage
gathers its (batch, m) twiddle block by the batch's modulus index
(a constant-index gather — XLA folds it into the twiddle operand).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..params.bitrev import bitrev_permute
from ..params.merge import NTTParameters, ReductionPolynomial
from . import barrett as bo
from .limb import u64_from_numpy


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


@dataclass(frozen=True)
class RNSMergePlan:
    """Stacked per-modulus tables (the `mod_index << N_power` offsets of
    the reference, ntt.cu:3135 etc., become a leading table axis)."""

    logn: int
    mod_count: int
    is64: bool
    reduction_poly: ReductionPolynomial
    qs: tuple  # host ints
    q_rep: Any  # (mod_count,) lanes
    fwd_tables: Any  # (mod_count, size)
    fwd_shoup: Any
    inv_tables: Any
    inv_shoup: Any
    n_inv_rep: Any  # (mod_count,)
    n_inv_shoup: Any
    members: Any = None  # originating per-modulus NTTParameters

    @staticmethod
    def from_params(params: Sequence[NTTParameters]) -> "RNSMergePlan":
        p0 = params[0]
        for p in params:
            if p.logn != p0.logn or p.poly_reduction != p0.poly_reduction:
                raise ValueError("RNS members must share logn and reduction poly")
            if p.dtype != p0.dtype:
                raise ValueError("RNS members must share dtype")
        is64 = p0.dtype == np.uint64
        word = 64 if is64 else 32

        fwd = np.stack([bitrev_permute(p.forward_root_of_unity_table) for p in params])
        inv = np.stack([bitrev_permute(p.inverse_root_of_unity_table) for p in params])
        fwd_sh = np.stack(
            [bo.shoup_companion(t, p.modulus.value, word) for t, p in zip(fwd, params)]
        )
        inv_sh = np.stack(
            [bo.shoup_companion(t, p.modulus.value, word) for t, p in zip(inv, params)]
        )
        qs = np.array([p.modulus.value for p in params], dtype=np.uint64)
        ninv = np.array([p.n_inv for p in params], dtype=np.uint64)
        ninv_sh = np.array(
            [(p.n_inv << word) // p.modulus.value for p in params], dtype=np.uint64
        )

        if is64:
            rep = lambda a: u64_from_numpy(np.asarray(a, dtype=np.uint64))
        else:
            rep = lambda a: jnp.asarray(np.asarray(a, dtype=np.uint32))
        return RNSMergePlan(
            logn=p0.logn,
            mod_count=len(params),
            is64=is64,
            reduction_poly=p0.poly_reduction,
            qs=tuple(int(q) for q in qs),
            q_rep=rep(qs),
            fwd_tables=rep(fwd),
            fwd_shoup=rep(fwd_sh),
            inv_tables=rep(inv),
            inv_shoup=rep(inv_sh),
            n_inv_rep=rep(ninv),
            n_inv_shoup=rep(ninv_sh),
            members=tuple(params),
        )

    def ops(self):
        if self.is64:
            return dict(
                add=bo.modadd64, sub=bo.modsub64, mulc=bo.shoup_mul64
            )
        return dict(
            add=bo.modadd32, sub=bo.modsub32, mulc=bo.shoup_mul32
        )


jax.tree_util.register_dataclass(
    RNSMergePlan,
    data_fields=["q_rep", "fwd_tables", "fwd_shoup", "inv_tables",
                 "inv_shoup", "n_inv_rep", "n_inv_shoup"],
    meta_fields=["logn", "mod_count", "is64", "reduction_poly", "qs",
                 "members"],
)


def _gather(x, idx):
    return _tmap(lambda a: a[idx], x)


def rns_ntt_lanes(x, plan: RNSMergePlan, mod_idx: np.ndarray):
    """Forward RNS NTT; row b of x uses modulus mod_idx[b] (static)."""
    ops = plan.ops()
    n = 1 << plan.logn
    xnp = plan.reduction_poly == ReductionPolynomial.X_N_plus
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    q_b = _tmap(lambda a: a[mod_idx][:, None, None], plan.q_rep)

    for s in range(plan.logn):
        m = 1 << s
        t = n >> (s + 1)
        lo, hi = (m, 2 * m) if xnp else (0, m)
        tw = _gather(_tmap(lambda a: a[:, lo:hi], plan.fwd_tables), mod_idx)
        tws = _gather(_tmap(lambda a: a[:, lo:hi], plan.fwd_shoup), mod_idx)
        v = _tmap(lambda a: a.reshape(lead + (m, 2, t)), x)
        u_part = _tmap(lambda a: a[..., 0, :], v)
        v_in = _tmap(lambda a: a[..., 1, :], v)
        tw_b = _tmap(lambda a: a[:, :, None], tw)
        tws_b = _tmap(lambda a: a[:, :, None], tws)
        v_part = ops["mulc"](v_in, tw_b, tws_b, q_b)
        hi_o = ops["add"](u_part, v_part, q_b)
        lo_o = ops["sub"](u_part, v_part, q_b)
        x = _tmap(
            lambda a, b2: jnp.stack([a, b2], axis=-2).reshape(lead + (n,)),
            hi_o,
            lo_o,
        )
    return x


def rns_intt_lanes(x, plan: RNSMergePlan, mod_idx: np.ndarray, scale: bool = True):
    """Inverse RNS NTT (GS butterflies, per-batch n^-1 in last stage)."""
    ops = plan.ops()
    n = 1 << plan.logn
    xnp = plan.reduction_poly == ReductionPolynomial.X_N_plus
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    q_b = _tmap(lambda a: a[mod_idx][:, None, None], plan.q_rep)

    for s in range(plan.logn - 1, -1, -1):
        h = 1 << s
        t = n >> (s + 1)
        lo, hi = (h, 2 * h) if xnp else (0, h)
        tw = _gather(_tmap(lambda a: a[:, lo:hi], plan.inv_tables), mod_idx)
        tws = _gather(_tmap(lambda a: a[:, lo:hi], plan.inv_shoup), mod_idx)
        v = _tmap(lambda a: a.reshape(lead + (h, 2, t)), x)
        u_part = _tmap(lambda a: a[..., 0, :], v)
        v_part = _tmap(lambda a: a[..., 1, :], v)
        tw_b = _tmap(lambda a: a[:, :, None], tw)
        tws_b = _tmap(lambda a: a[:, :, None], tws)
        hi_o = ops["add"](u_part, v_part, q_b)
        lo_o = ops["mulc"](ops["sub"](u_part, v_part, q_b), tw_b, tws_b, q_b)
        x = _tmap(
            lambda a, b2: jnp.stack([a, b2], axis=-2).reshape(lead + (n,)),
            hi_o,
            lo_o,
        )

    if scale:
        q_r = _tmap(lambda a: a[mod_idx][:, None], plan.q_rep)
        ninv = _tmap(lambda a: a[mod_idx][:, None], plan.n_inv_rep)
        ninv_s = _tmap(lambda a: a[mod_idx][:, None], plan.n_inv_shoup)
        x = plan.ops()["mulc"](x, ninv, ninv_s, q_r)
    return x
