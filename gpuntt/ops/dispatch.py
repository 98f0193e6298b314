"""Public transform API — the GPU_NTT / GPU_INTT equivalent surface.

Rebuild of the reference's host dispatch layer (ntt.cu:2076-3097 and
the ordered variants :3600-4459) as functional, jittable entry points:

  ntt / intt                      <- GPU_NTT / GPU_INTT (+ *_Inplace,
                                     which is meaningless under XLA's
                                     functional semantics — the jitted
                                     computation is in-place where the
                                     compiler proves it safe)
  ntt_rns / intt_rns              <- RNS overloads (ntt.cu:2560-3059)
  ntt_modulus_ordered / intt_...  <- GPU_NTT_Modulus_Ordered (:3600-3768)
  ntt_poly_ordered / intt_...     <- GPU_NTT_Poly_Ordered (:4281-4459)

Layout semantics (NTTLayout, ntt.cuh doc :360-394): PerPolynomial
transforms the last axis of a (batch, N) buffer; PerCoefficient
transforms axis 0 of an (N, batch) buffer — same memory, different
interpretation; here this is an axis choice, not a kernel family
(the reference needs a dedicated transpose kernel family for it,
ntt.cu:1554-2075).

Signed variants (Data32s/Data64s instantiations, ntt.cu:4508-5244):
`ntt(..., signed_input=True)` reduces on load; `intt(...,
signed_output=True)` applies centered reduction in the last stage.

`zero_padding` is accepted for parity and ignored — the reference
threads it through but no kernel body reads it (SURVEY.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..params.merge import NTTLayout, NTTType, ReductionPolynomial
from . import barrett as bo
from .merge_ntt import MergePlan, from_lanes, merge_intt_lanes, merge_ntt_lanes, to_lanes


@dataclass(frozen=True)
class NTTConfig:
    """Parity stand-in for ntt_configuration (ntt.cuh:31-51)."""

    n_power: int
    ntt_type: NTTType = NTTType.FORWARD
    ntt_layout: NTTLayout = NTTLayout.PerPolynomial
    reduction_poly: ReductionPolynomial = ReductionPolynomial.X_N_minus
    zero_padding: bool = False  # accepted, never read (parity)
    mod_inverse: int | None = None


def select_engine(plan: MergePlan) -> str:
    """The one engine decision for merge transforms.

    Every backend XLA targets runs the butterfly engine (merge_ntt.py):
    u32 lanes, static twiddle slices, XLA's own fusion.  The candidate
    it was measured against, the int8 digit-matmul factorization as
    plain JAX (its int8 dots became cuBLAS GEMMs), lost on one H100 by
    2.1-2.3x at u64 2^16 x 128 forward, inverse and polymul
    (docs/DESIGN.md, "Engine choice"), so it is not offered.  The
    butterfly engine runs any caller-supplied table, including factors
    that are not roots of unity, with the reference's
    garbage-in/garbage-out semantics; an engine added here must either
    do the same or leave such plans to it."""
    del plan  # one engine today; the seam for a kernel that beats it
    return "butterfly"


def _signed_view(x):
    """numpy int32/int64 -> same-width unsigned bit pattern."""
    x = np.asarray(x)
    if x.dtype == np.int32:
        return x.view(np.uint32), 32
    if x.dtype == np.int64:
        return x.view(np.uint64), 64
    raise TypeError(f"signed input must be int32/int64, got {x.dtype}")


def _apply_layout_in(x_lanes, layout: NTTLayout):
    if layout == NTTLayout.PerCoefficient:
        return jax.tree_util.tree_map(lambda a: jnp.moveaxis(a, 0, -1), x_lanes)
    return x_lanes


def _apply_layout_out(x_lanes, layout: NTTLayout):
    if layout == NTTLayout.PerCoefficient:
        return jax.tree_util.tree_map(lambda a: jnp.moveaxis(a, -1, 0), x_lanes)
    return x_lanes


# select_engine's answers -> (forward, inverse) on the last axis
_ENGINES = {"butterfly": (merge_ntt_lanes, merge_intt_lanes)}


def _merge_lanes(x, plan: MergePlan, inverse: bool):
    """Transform along the last axis on the engine select_engine picks."""
    return _ENGINES[select_engine(plan)][inverse](x, plan)


def ntt_lanes(
    x,
    plan: MergePlan,
    layout: NTTLayout = NTTLayout.PerPolynomial,
    signed_input: bool = False,
):
    """Forward NTT on the lane representation (jittable building block).

    PerCoefficient is an axis relayout applied before the transform
    (the reference needs a dedicated transpose-fused kernel family for
    this, ntt.cu:1554-2075; here it is one XLA transpose).  Pass the
    plan through your jit as an ARGUMENT: a closure-captured plan
    inlines its 4 x N-word tables into the compiled program."""
    if signed_input:
        if plan.is64:
            x = bo.reduce_signed64(x, bo.u64_const(plan.q))
        else:
            x = bo.reduce_signed32(x, plan.q)
    x = _apply_layout_in(x, layout)
    return _apply_layout_out(_merge_lanes(x, plan, inverse=False), layout)


def intt_lanes(
    x,
    plan: MergePlan,
    layout: NTTLayout = NTTLayout.PerPolynomial,
    signed_output: bool = False,
):
    """Inverse NTT on the lane representation (jittable building block).
    Layout semantics and plan passing as ntt_lanes."""
    x = _apply_layout_in(x, layout)
    y = _apply_layout_out(_merge_lanes(x, plan, inverse=True), layout)
    if signed_output:
        if plan.is64:
            return bo.centered64(y, bo.u64_const(plan.q))
        return bo.centered32(y, plan.q)
    return y


# ------------------------------------------------------ numpy convenience


def _cached_jit(plan: MergePlan, key, maker):
    """Jitted-transform cache keyed on the plan's params object, so the
    numpy convenience wrappers (and the per-modulus RNS routing built on
    them) don't retrace on every call."""
    host = plan.params
    if host is None:
        return jax.jit(maker())
    cache = getattr(host, "_jit_cache", None)
    if cache is None:
        cache = {}
        host._jit_cache = cache
    if key not in cache:
        cache[key] = jax.jit(maker())
    return cache[key]


def ntt(x, plan: MergePlan, cfg: NTTConfig | None = None, **kw):
    """GPU_NTT equivalent over numpy arrays (device round-trip included).

    Accepts uint32/uint64 (or int32/int64 with signed_input semantics,
    matching the Data32s/Data64s instantiations).  To compose the
    transform inside your own jit use ntt_lanes with the plan passed as
    a jit ARGUMENT (see its docstring).
    """
    layout = kw.pop("layout", cfg.ntt_layout if cfg else NTTLayout.PerPolynomial)
    signed_input = kw.pop("signed_input", False)
    x = np.asarray(x)
    if x.dtype in (np.dtype(np.int32), np.dtype(np.int64)):
        xv, _ = _signed_view(x)
        signed_input = True
    else:
        xv = x
    lanes = to_lanes(xv, plan.is64)
    fn = _cached_jit(
        plan, ("ntt", layout, signed_input),
        lambda: lambda v, pl: ntt_lanes(v, pl, layout=layout,
                                        signed_input=signed_input))
    return from_lanes(fn(lanes, plan), plan.is64)


def intt(x, plan: MergePlan, cfg: NTTConfig | None = None, **kw):
    """GPU_INTT equivalent over numpy arrays."""
    layout = kw.pop("layout", cfg.ntt_layout if cfg else NTTLayout.PerPolynomial)
    signed_output = kw.pop("signed_output", False)
    lanes = to_lanes(np.asarray(x), plan.is64)
    fn = _cached_jit(
        plan, ("intt", layout, signed_output),
        lambda: lambda v, pl: intt_lanes(v, pl, layout=layout,
                                         signed_output=signed_output))
    res = from_lanes(fn(lanes, plan), plan.is64)
    if signed_output:
        return res.view(np.int64) if plan.is64 else res.view(np.int32)
    return res


# --------------------------------------------------------- RNS + ordered

def _rns_mod_idx(batch: int, mod_count: int) -> np.ndarray:
    """Default cyclic modulus schedule: batch b -> modulus b % mod_count
    (ntt.cu RNS kernels, q_index = block_y % mod_count)."""
    return np.arange(batch, dtype=np.int64) % mod_count


def _merge_plan_cached(params):
    mp = getattr(params, "_merge_plan_cache", None)
    if mp is None:
        mp = MergePlan.from_params(params)
        params._merge_plan_cache = mp
    return mp


def _rns_cached_jit(plan, key, maker):
    """Cached jit for RNS entry points, hosted on members[0] (the plan
    dataclasses are frozen) — same role as _cached_jit for MergePlan:
    without it every ntt_rns/intt_rns call would rebuild a fresh
    jax.jit closure and pay a full retrace+recompile (the advertised
    HE workload calls these per evaluation step)."""
    host = plan.members[0] if getattr(plan, "members", None) else None
    if host is None:
        return jax.jit(maker())
    cache = getattr(host, "_rns_jit_cache", None)
    if cache is None:
        cache = {}
        host._rns_jit_cache = cache
    full = (plan.logn, plan.qs, getattr(plan, "reduction_poly", None),
            tuple((m.root_of_unity, m.poly_reduction)
                  for m in plan.members)) + key
    if full not in cache:
        cache[full] = jax.jit(maker())
    return cache[full]


def ntt_rns(x, plan, cfg: NTTConfig | None = None):
    """GPU_NTT RNS overload (ntt.cu:2560-2800)."""
    from .rns import rns_ntt_lanes

    x = np.asarray(x)
    mod_idx = _rns_mod_idx(x.shape[0], plan.mod_count)
    lanes = to_lanes(x, plan.is64)
    fn = _rns_cached_jit(plan, ("ntt_rns", tuple(mod_idx.tolist())),
                         lambda: lambda v, pl: rns_ntt_lanes(v, pl, mod_idx))
    return from_lanes(fn(lanes, plan), plan.is64)


def intt_rns(x, plan, cfg: NTTConfig | None = None):
    """GPU_INTT RNS overload (ntt.cu:2800-3059)."""
    from .rns import rns_intt_lanes

    x = np.asarray(x)
    mod_idx = _rns_mod_idx(x.shape[0], plan.mod_count)
    lanes = to_lanes(x, plan.is64)
    fn = _rns_cached_jit(plan, ("intt_rns", tuple(mod_idx.tolist())),
                         lambda: lambda v, pl: rns_intt_lanes(v, pl, mod_idx))
    return from_lanes(fn(lanes, plan), plan.is64)


def ntt_modulus_ordered(x, plan, order, cfg: NTTConfig | None = None):
    """GPU_NTT_Modulus_Ordered (ntt.cu:3600-3768): modulus index =
    order[b % mod_count]."""
    from .rns import rns_ntt_lanes

    x = np.asarray(x)
    order = np.asarray(order, dtype=np.int64)
    mod_idx = order[np.arange(x.shape[0]) % len(order)]
    lanes = to_lanes(x, plan.is64)
    fn = _rns_cached_jit(plan, ("ntt_rns", tuple(mod_idx.tolist())),
                         lambda: lambda v, pl: rns_ntt_lanes(v, pl, mod_idx))
    return from_lanes(fn(lanes, plan), plan.is64)


def intt_modulus_ordered(x, plan, order, cfg: NTTConfig | None = None):
    from .rns import rns_intt_lanes

    x = np.asarray(x)
    order = np.asarray(order, dtype=np.int64)
    mod_idx = order[np.arange(x.shape[0]) % len(order)]
    lanes = to_lanes(x, plan.is64)
    fn = _rns_cached_jit(plan, ("intt_rns", tuple(mod_idx.tolist())),
                         lambda: lambda v, pl: rns_intt_lanes(v, pl, mod_idx))
    return from_lanes(fn(lanes, plan), plan.is64)


def ntt_poly_ordered(x, plan, order, batch_size: int | None = None,
                     cfg: NTTConfig | None = None):
    """GPU_NTT_Poly_Ordered (ntt.cu:3782-4459): for b < batch_size, poly
    order[b] is transformed in place at position order[b] with modulus
    b % mod_count; other rows pass through untouched."""
    from .rns import rns_ntt_lanes

    x = np.asarray(x)
    order = np.asarray(order, dtype=np.int64)
    b = batch_size if batch_size is not None else len(order)
    sel = order[:b]
    mod_idx = np.arange(b, dtype=np.int64) % plan.mod_count
    lanes = to_lanes(x[sel], plan.is64)
    fn = _rns_cached_jit(
        plan, ("ntt_rns", tuple(mod_idx.tolist())),
        lambda: lambda v, pl: rns_ntt_lanes(v, pl, mod_idx))
    out = from_lanes(fn(lanes, plan), plan.is64)
    res = x.copy()
    res[sel] = out.astype(x.dtype)
    return res


def intt_poly_ordered(x, plan, order, batch_size: int | None = None,
                      cfg: NTTConfig | None = None):
    from .rns import rns_intt_lanes

    x = np.asarray(x)
    order = np.asarray(order, dtype=np.int64)
    b = batch_size if batch_size is not None else len(order)
    sel = order[:b]
    mod_idx = np.arange(b, dtype=np.int64) % plan.mod_count
    lanes = to_lanes(x[sel], plan.is64)
    fn = _rns_cached_jit(
        plan, ("intt_rns", tuple(mod_idx.tolist())),
        lambda: lambda v, pl: rns_intt_lanes(v, pl, mod_idx))
    out = from_lanes(fn(lanes, plan), plan.is64)
    res = x.copy()
    res[sel] = out.astype(x.dtype)
    return res


# ---------------------------------------------- pointwise mult / polymul


def pointwise_mult_lanes(a, b, plan):
    """Elementwise a*b mod q on the lane representation (jittable).

    Device-side rendition of NTTCPU::mult (ntt_cpu.cu:67-79), which the
    reference offers host-side only — exact Barrett, reference schedule
    (modular_arith.cuh:316-338).  `plan` is any plan carrying
    q/bit/mu/is64 (MergePlan or FourStepPlan)."""
    if plan.is64:
        return bo.barrett_mul64(a, b, plan.q, plan.bit, plan.mu)
    return bo.barrett_mul32(a, b, plan.q, plan.bit, plan.mu)


def pointwise_mult(x, y, plan: MergePlan):
    """NTT-domain pointwise product over numpy arrays."""
    xl = to_lanes(np.asarray(x), plan.is64)
    yl = to_lanes(np.asarray(y), plan.is64)
    fn = _cached_jit(plan, ("pmult",),
                     lambda: lambda a, b, pl: pointwise_mult_lanes(a, b, pl))
    return from_lanes(fn(xl, yl, plan), plan.is64)


def polymul_lanes(a, b, plan: MergePlan):
    """Fused polynomial multiplication modulo (q, X^N +- 1) on lanes
    (jittable): INTT(NTT(a) o NTT(b)), cyclic for X_N_minus and
    negacyclic for X_N_plus — one compiled computation."""
    fa = ntt_lanes(a, plan)
    fb = ntt_lanes(b, plan)
    return intt_lanes(pointwise_mult_lanes(fa, fb, plan), plan)


def polymul(x, y, plan: MergePlan):
    """Polynomial multiplication over numpy (batch, N) arrays — the
    reference example flow (test_cpu_merge_ntt.cu:70-77: ntt, mult,
    intt) as one fused jitted computation; bit-exact vs
    schoolbook_poly_multiplication for the plan's reduction polynomial."""
    xl = to_lanes(np.asarray(x), plan.is64)
    yl = to_lanes(np.asarray(y), plan.is64)
    fn = _cached_jit(plan, ("polymul",),
                     lambda: lambda a, b, pl: polymul_lanes(a, b, pl))
    return from_lanes(fn(xl, yl, plan), plan.is64)


def rns_pointwise_mult_lanes(a, b, plan, mod_idx):
    """Jittable RNS spectrum product: row r uses modulus mod_idx[r].

    A data x data product needs full Barrett with each modulus' exact
    (q, bit, mu) — the reference shift schedule is static per modulus —
    so each member's constants run over the whole batch and rows are
    mask-selected.  mod_count is small (an HE prime ladder) and the
    pointwise stage is bandwidth-bound next to the transforms, so the
    mod_count x ALU overhead is noise; the numpy entry
    (rns_pointwise_mult) slices per modulus instead and pays nothing."""
    mod_idx = jnp.asarray(np.asarray(mod_idx))
    out = None
    for m, member in enumerate(plan.members):
        mm = member.modulus
        if plan.is64:
            r = bo.barrett_mul64(a, b, mm.value, mm.bit, mm.mu)
        else:
            r = bo.barrett_mul32(a, b, mm.value, mm.bit, mm.mu)
        if out is None:
            out = r
        else:
            sel = mod_idx == m

            def pick(rr, oo):
                mask = sel.reshape((-1,) + (1,) * (rr.ndim - 1))
                return jnp.where(mask, rr, oo)

            out = jax.tree_util.tree_map(pick, r, out)
    return out


def _order_mod_idx(batch: int, plan, order):
    if order is None:
        return _rns_mod_idx(batch, plan.mod_count)
    order = np.asarray(order, dtype=np.int64)
    if order.size and (order.min() < 0 or order.max() >= plan.mod_count):
        raise ValueError(
            f"order entries must be in [0, {plan.mod_count}), got {order}")
    return order[np.arange(batch) % len(order)]


def rns_pointwise_mult(x, y, plan, order=None):
    """NTT-domain RNS product over numpy arrays (cyclic modulus
    schedule by default; `order` as in GPU_NTT_Modulus_Ordered).

    Device-side rendition of the per-modulus NTTCPU::mult loop HE
    callers must otherwise write by hand (the reference offers no RNS
    pointwise at all)."""
    x = np.asarray(x)
    y = np.asarray(y)
    mod_idx = _order_mod_idx(x.shape[0], plan, order)
    out = np.empty_like(x)
    for m in range(plan.mod_count):
        sel = np.nonzero(mod_idx == m)[0]
        if sel.size:
            out[sel] = pointwise_mult(x[sel], y[sel],
                                      _merge_plan_cached(plan.members[m]))
    return out


def rns_polymul(x, y, plan, order=None):
    """RNS polynomial multiplication — the HE evaluation workload:
    forward RNS NTT of both operands, per-modulus spectrum product,
    inverse.  Row r of the batch is
    a residue polynomial modulo (q_{mod_idx[r]}, X^N +/- 1)."""
    if order is None:
        prod = rns_pointwise_mult(ntt_rns(x, plan), ntt_rns(y, plan), plan)
        return intt_rns(prod, plan)
    fx = ntt_modulus_ordered(x, plan, order)
    fy = ntt_modulus_ordered(y, plan, order)
    prod = rns_pointwise_mult(fx, fy, plan, order=order)
    return intt_modulus_ordered(prod, plan, order)
