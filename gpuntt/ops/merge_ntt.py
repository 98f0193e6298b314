"""Merged radix-2 NTT engine (XLA path).

Rebuild of the reference's merge-NTT kernel family + host dispatch
(ntt.cu:11-3097).  Where CUDA needs 6 kernel families
(LowRing/Core/Core_/Transpose x fwd/inv, ntt.cu:11-2075) and a static
launch-plan table (ntt.cuh:606-797), this formulation is a single
trace: logn unrolled butterfly stages over a (..., m, 2, t) reshape of
the coefficient axis, with twiddles taken as *static slices* of the
bit-reversed table (no gathers, no bit-reversal at runtime) and XLA
owning fusion and tiling.

Data never leaves uint32 lanes: 32-bit data is one uint32 array, 64-bit
data is a limb.U64 (hi, lo) pair; the butterfly ops come from
ops.barrett (Shoup constant-multiply — exact, hence bit-identical to
the reference's Barrett outputs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..params.bitrev import bitrev_permute
from ..params.merge import NTTParameters, ReductionPolynomial
from . import barrett as bo
from .limb import u64_from_numpy, u64_to_numpy


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


def _reshape(x, shape):
    return _tmap(lambda a: a.reshape(shape), x)


def _stage_slice(x, lo, hi):
    return _tmap(lambda a: a[..., lo:hi], x)


def _take_pair(x, idx):
    return _tmap(lambda a: a[..., idx, :], x)


# ------------------------------------------------------------------ plan


def _butterfly_tables(p: NTTParameters):
    """Bit-reversed twiddle tables + Shoup companions in lane
    representation, built once and cached on the parameter object (they
    are 4 x N words — 100s of MB at the big-ring sizes)."""
    tabs = getattr(p, "_merge_tables_cache", None)
    if tabs is not None:
        return tabs
    q = p.modulus.value
    fwd = bitrev_permute(p.forward_root_of_unity_table)
    inv = bitrev_permute(p.inverse_root_of_unity_table)
    is64 = p.dtype == np.uint64
    word = 64 if is64 else 32
    fwd_sh = bo.shoup_companion(fwd, q, word)
    inv_sh = bo.shoup_companion(inv, q, word)
    if is64:
        rep = lambda a: u64_from_numpy(np.asarray(a, dtype=np.uint64))
    else:
        rep = lambda a: jnp.asarray(np.asarray(a, dtype=np.uint32))
    tabs = (rep(fwd), rep(fwd_sh), rep(inv), rep(inv_sh))
    p._merge_tables_cache = tabs
    return tabs


@dataclass(frozen=True)
class MergePlan:
    """Device-side transform plan: bit-reversed twiddles (+ Shoup
    companions) and modulus constants.

    Equivalent of the caller-side table copies in the reference examples
    (test_merge_ntt.cu:107-134) plus the kernel-plan table role of
    CreateForward/InverseNTTKernel (ntt.cuh:606-797) — except the
    "plan" degenerates to static stage slices.
    """

    logn: int
    q: int
    bit: int
    mu: int
    n_inv: int
    reduction_poly: ReductionPolynomial
    is64: bool
    fwd_table: Any  # uint32 array or U64 pair, bit-reversed order
    fwd_shoup: Any
    inv_table: Any
    inv_shoup: Any
    n_inv_rep: Any  # scalar lane rep of n_inv
    n_inv_shoup: Any
    params: Any = None  # originating NTTParameters

    @staticmethod
    def from_params(p: NTTParameters) -> "MergePlan":
        """Build the transform plan (tables cached on `p`)."""
        q = p.modulus.value
        is64 = p.dtype == np.uint64
        fwd_t, fwd_s, inv_t, inv_s = _butterfly_tables(p)
        word = 64 if is64 else 32
        ninv_sh = (p.n_inv << word) // q
        if is64:
            scal = lambda v: bo.u64_const(int(v))
        else:
            scal = lambda v: jnp.uint32(int(v))
        return MergePlan(
            logn=p.logn,
            q=q,
            bit=p.modulus.bit,
            mu=p.modulus.mu,
            n_inv=p.n_inv,
            reduction_poly=p.poly_reduction,
            is64=is64,
            fwd_table=fwd_t,
            fwd_shoup=fwd_s,
            inv_table=inv_t,
            inv_shoup=inv_s,
            n_inv_rep=scal(p.n_inv),
            n_inv_shoup=scal(ninv_sh),
            params=p,
        )

    # butterfly op bundle (reads only meta fields — safe under tracing)
    def ops(self):
        if self.is64:
            qc = bo.u64_const(self.q)
            return dict(
                add=lambda a, b: bo.modadd64(a, b, qc),
                sub=lambda a, b: bo.modsub64(a, b, qc),
                mulc=lambda x, w, ws: bo.shoup_mul64(x, w, ws, qc),
            )
        q = self.q
        return dict(
            add=lambda a, b: bo.modadd32(a, b, q),
            sub=lambda a, b: bo.modsub32(a, b, q),
            mulc=lambda x, w, ws: bo.shoup_mul32(x, w, ws, q),
        )


# Registered as a pytree (tables = data, plan scalars = static meta) so
# plans can be passed as jit ARGUMENTS: closed-over tables enter HLO as
# inline constants, which XLA constant-folds per-op (minutes at logn >=
# 24).  As arguments they become runtime buffers.
jax.tree_util.register_dataclass(
    MergePlan,
    data_fields=["fwd_table", "fwd_shoup", "inv_table", "inv_shoup",
                 "n_inv_rep", "n_inv_shoup"],
    meta_fields=["logn", "q", "bit", "mu", "n_inv", "reduction_poly",
                 "is64", "params"],
)


# ------------------------------------------------------------- transforms


def ct_stages(x, table, shoup, ops, log_size: int, xnp: bool):
    """Cooley-Tukey butterfly stage sweep along the last axis.

    Stage s (m = 2^s groups, t = N >> (s+1)) pairs j and j+t; with the
    bit-reversed table the group twiddles are table[0:m] (X_N_minus,
    cf. ntt_cpu.cu:102-104) or table[m:2m] (X_N_plus, :107-109).
    Shared by the merge NTT and the 4-step column/row NTTs
    (core_ntt, ntt_4step_cpu.cu:117-154, is the xnp=False case).
    """
    n = 1 << log_size
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]

    for s in range(log_size):
        m = 1 << s
        t = n >> (s + 1)
        lo, hi = (m, 2 * m) if xnp else (0, m)
        tw = _stage_slice(table, lo, hi)
        tws = _stage_slice(shoup, lo, hi)
        v = _reshape(x, lead + (m, 2, t))
        u_part = _take_pair(v, 0)
        tw_b = _tmap(lambda a: a[..., :, None], tw)
        tws_b = _tmap(lambda a: a[..., :, None], tws)
        v_part = ops["mulc"](_take_pair(v, 1), tw_b, tws_b)
        hi_o = ops["add"](u_part, v_part)
        lo_o = ops["sub"](u_part, v_part)
        x = _reshape(_tmap(lambda a, b: jnp.stack([a, b], axis=-2), hi_o, lo_o),
                     lead + (n,))
    return x


def gs_stages(x, table, shoup, ops, log_size: int, xnp: bool):
    """Gentleman-Sande (inverse) butterfly stage sweep, no scaling."""
    n = 1 << log_size
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]

    for s in range(log_size - 1, -1, -1):
        h = 1 << s
        t = n >> (s + 1)
        lo, hi = (h, 2 * h) if xnp else (0, h)
        tw = _stage_slice(table, lo, hi)
        tws = _stage_slice(shoup, lo, hi)
        v = _reshape(x, lead + (h, 2, t))
        u_part = _take_pair(v, 0)
        v_part = _take_pair(v, 1)
        tw_b = _tmap(lambda a: a[..., :, None], tw)
        tws_b = _tmap(lambda a: a[..., :, None], tws)
        hi_o = ops["add"](u_part, v_part)
        lo_o = ops["mulc"](ops["sub"](u_part, v_part), tw_b, tws_b)
        x = _reshape(_tmap(lambda a, b: jnp.stack([a, b], axis=-2), hi_o, lo_o),
                     lead + (n,))
    return x


def merge_ntt_lanes(x, plan: MergePlan):
    """Forward merged NTT along the last axis of the lane representation.

    Matches GPU_NTT output element-for-element (ntt.cu:2076-2256).
    """
    xnp = plan.reduction_poly == ReductionPolynomial.X_N_plus
    return ct_stages(x, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn, xnp)


def merge_intt_lanes(x, plan: MergePlan, scale: bool = True):
    """Inverse merged NTT (Gentleman-Sande) along the last axis.

    n^-1 scaling happens once at the end, matching the reference's
    last-kernel placement (ntt.cu:1170-1192); `scale=False` gives the
    unscaled variant used when the caller owns cfg.mod_inverse.
    """
    ops = plan.ops()
    xnp = plan.reduction_poly == ReductionPolynomial.X_N_plus
    x = gs_stages(x, plan.inv_table, plan.inv_shoup, ops, plan.logn, xnp)
    if scale:
        x = ops["mulc"](x, plan.n_inv_rep, plan.n_inv_shoup)
    return x


# ------------------------------------------------- lane <-> numpy boundary


def to_lanes(x, is64: bool):
    if is64:
        return u64_from_numpy(np.asarray(x, dtype=np.uint64))
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


def from_lanes(x, is64: bool):
    if is64:
        return u64_to_numpy(x)
    return np.asarray(x)
