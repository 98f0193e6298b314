"""4-step (matrix) NTT engine — single-device XLA path.

Rebuild of the reference's 4-step GPU pipeline (ntt_4step.cu:36-3260):

  [Transpose]   caller-side  (GPU_Transpose, ntt_4step.cu:58-66)
  [n1-NTT on columns]        (FourStepForwardCoreT1..T4 :68-745)
  [Transpose + W mult]       (fused into row-NTT load, :1049-1058)
  [n2-NTT on rows]           (FourStepPartialForwardCore{,1,2} :746-1171)
  [Transpose]   caller-side

`fourstep_ntt_lanes` keeps the reference's calling convention —
first/last transpose are the caller's job (pipeline doc
ntt_4step.cuh:68-74) — so a GPU-NTT user can port call sites 1:1.
`fourstep_ntt_full` bundles the whole thing as one jittable function.

Here the column/row NTTs are the same ct/gs stage sweeps as the merge
engine applied along the last axis of (n2, n1) / (n1, n2) views, the
transposes are XLA relayouts, and the W product is one fused
elementwise Shoup multiply.  The n2-axis split of this formulation is
also the multi-device sharding seam (parallel/fourstep_dist.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..params.bitrev import bitrev_permute
from ..params.fourstep import NTTParameters4Step
from ..reference.fourstep_cpu import intt_input_indices
from . import barrett as bo
from .limb import u64_from_numpy
from .merge_ntt import ct_stages, gs_stages


def _tmap(f, *xs):
    return jax.tree_util.tree_map(f, *xs)


@dataclass(frozen=True)
class FourStepPlan:
    """Device tables for the 4-step transform (built from
    NTTParameters4Step, nttparameters.cu:191-225)."""

    logn: int
    n1: int
    n2: int
    q: int
    is64: bool
    bit: int
    mu: int
    n1_fwd: Any
    n1_fwd_sh: Any
    n2_fwd: Any
    n2_fwd_sh: Any
    n1_inv: Any
    n1_inv_sh: Any
    n2_inv: Any
    n2_inv_sh: Any
    w_fwd: Any  # (n1, n2) lanes
    w_fwd_sh: Any
    w_inv: Any
    w_inv_sh: Any
    n_inv_rep: Any
    n_inv_shoup: Any

    @staticmethod
    def from_params(p: NTTParameters4Step) -> "FourStepPlan":
        q = p.modulus.value
        is64 = p.dtype == np.uint64
        word = 64 if is64 else 32
        if is64:
            rep = lambda a: u64_from_numpy(np.asarray(a, dtype=np.uint64))
            scal = lambda v: bo.u64_const(int(v))
        else:
            rep = lambda a: jnp.asarray(np.asarray(a, dtype=np.uint32))
            scal = lambda v: jnp.uint32(int(v))

        def tab(t):
            bt = bitrev_permute(t)
            return rep(bt), rep(bo.shoup_companion(bt, q, word))

        n1f, n1fs = tab(p.n1_based_root_of_unity_table)
        n2f, n2fs = tab(p.n2_based_root_of_unity_table)
        n1i, n1is = tab(p.n1_based_inverse_root_of_unity_table)
        n2i, n2is = tab(p.n2_based_inverse_root_of_unity_table)
        wf = p.W_root_of_unity_table.reshape(p.n1, p.n2)
        wi = p.W_inverse_root_of_unity_table.reshape(p.n1, p.n2)
        return FourStepPlan(
            logn=p.logn,
            n1=p.n1,
            n2=p.n2,
            q=q,
            is64=is64,
            bit=p.modulus.bit,
            mu=p.modulus.mu,
            n1_fwd=n1f,
            n1_fwd_sh=n1fs,
            n2_fwd=n2f,
            n2_fwd_sh=n2fs,
            n1_inv=n1i,
            n1_inv_sh=n1is,
            n2_inv=n2i,
            n2_inv_sh=n2is,
            w_fwd=rep(wf),
            w_fwd_sh=rep(bo.shoup_companion(wf, q, word)),
            w_inv=rep(wi),
            w_inv_sh=rep(bo.shoup_companion(wi, q, word)),
            n_inv_rep=scal(p.n_inv),
            n_inv_shoup=scal((p.n_inv << word) // q),
        )

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


jax.tree_util.register_dataclass(
    FourStepPlan,
    data_fields=["n1_fwd", "n1_fwd_sh", "n2_fwd", "n2_fwd_sh",
                 "n1_inv", "n1_inv_sh", "n2_inv", "n2_inv_sh",
                 "w_fwd", "w_fwd_sh", "w_inv", "w_inv_sh",
                 "n_inv_rep", "n_inv_shoup"],
    meta_fields=["logn", "n1", "n2", "q", "is64", "bit", "mu"],
)


def _swap_last2(x):
    return _tmap(lambda a: jnp.swapaxes(a, -1, -2), x)


def transpose_lanes(x, row: int, col: int):
    """GPU_Transpose equivalent (ntt_4step.cu:36-66): interpret the last
    axis as a (row, col) matrix and emit its transpose, flattened."""
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    v = _tmap(lambda a: a.reshape(lead + (row, col)), x)
    return _tmap(lambda a: jnp.swapaxes(a, -1, -2).reshape(lead + (row * col,)), v)


def fourstep_ntt_lanes(x, plan: FourStepPlan):
    """GPU_4STEP_NTT(FORWARD) parity: input pre-transposed (n2, n1)
    flattened, output (n1, n2) flattened pre-final-transpose
    (ntt_4step.cu:2303-2533)."""
    ops = plan.ops()
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    y = _tmap(lambda a: a.reshape(lead + (plan.n2, plan.n1)), x)
    y = ct_stages(y, plan.n1_fwd, plan.n1_fwd_sh, ops,
                  plan.n1.bit_length() - 1, xnp=False)
    y = _swap_last2(y)  # (n1, n2)
    y = ops["mulc"](y, plan.w_fwd, plan.w_fwd_sh)
    y = ct_stages(y, plan.n2_fwd, plan.n2_fwd_sh, ops,
                  plan.n2.bit_length() - 1, xnp=False)
    return _tmap(lambda a: a.reshape(lead + (plan.n1 * plan.n2,)), y)


def fourstep_intt_lanes(x, plan: FourStepPlan, scale: bool = True):
    """GPU_4STEP_NTT(INVERSE) parity: input pre-permuted by
    intt_first_transpose (test_4step_intt.cu:83-88), output (n1, n2)
    flattened pre-final-transpose; n^-1 fused into the last stage
    (FourStepPartialInverseCore, ntt_4step.cu:1875-2015)."""
    ops = plan.ops()
    lead = jax.tree_util.tree_leaves(x)[0].shape[:-1]
    y = _tmap(lambda a: a.reshape(lead + (plan.n2, plan.n1)), x)
    y = gs_stages(y, plan.n1_inv, plan.n1_inv_sh, ops,
                  plan.n1.bit_length() - 1, xnp=False)
    y = _swap_last2(y)  # (n1, n2)
    y = ops["mulc"](y, plan.w_inv, plan.w_inv_sh)
    y = gs_stages(y, plan.n2_inv, plan.n2_inv_sh, ops,
                  plan.n2.bit_length() - 1, xnp=False)
    if scale:
        y = ops["mulc"](y, plan.n_inv_rep, plan.n_inv_shoup)
    return _tmap(lambda a: a.reshape(lead + (plan.n1 * plan.n2,)), y)


def fourstep_ntt_full(x, plan: FourStepPlan):
    """Whole forward pipeline incl. both caller-side transposes — equals
    NTT_4STEP_CPU::ntt output (ntt_4step_cpu.cu:33-68).  Jittable."""
    x = transpose_lanes(x, plan.n1, plan.n2)
    y = fourstep_ntt_lanes(x, plan)
    return transpose_lanes(y, plan.n1, plan.n2)


def fourstep_intt_full(x, plan: FourStepPlan):
    """Whole inverse pipeline incl. the intt_first_transpose permutation
    and final transpose — equals NTT_4STEP_CPU::intt."""
    idx = intt_input_indices(plan.n1, plan.n2)
    x = _tmap(lambda a: a[..., idx], x)
    y = fourstep_intt_lanes(x, plan)
    return transpose_lanes(y, plan.n1, plan.n2)
