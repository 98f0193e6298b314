"""Vectorized exact modular arithmetic on uint32 lanes.

Rebuild of OPERATOR_GPU<T> (modular_arith.cuh:174-460) on uint32 lanes:

- `barrett_mul32/64` replicate the reference's Barrett with the exact
  `bit-2` / `bit+3` shift schedule (modular_arith.cuh:312-339), used for
  data x data products (pointwise polymul).
- `shoup_mul32/64` multiply by a *constant* (twiddle) using a
  precomputed companion w' = floor(w * 2^word / q).  Both forms compute
  the exact canonical residue, so outputs stay bit-identical to the
  reference; Shoup needs ~1/3 the lane multiplies, which is what the
  transform hot loop uses.
- signed load conversion and centered store reduction mirror
  modular_arith.cuh:371-405.

All functions are shape-polymorphic jnp on uint32 (64-bit data as
limb.U64 pairs) and trace identically under jit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .limb import (
    U64,
    U128,
    mul32x32_64,
    mul32x32_lo,
    mul64x64_128,
    mul64x64_hi,
    mul64x64_lo,
    u128_shr_lo64,
    u64_add,
    u64_gte,
    u64_shl,
    u64_shr,
    u64_sub,
)


def u64_select(pred, a: U64, b: U64) -> U64:
    """where(pred, a, b) on (hi, lo) pairs."""
    return U64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


def u64_const(value: int, like=None) -> U64:
    """Broadcastable U64 scalar constant."""
    hi = jnp.uint32((value >> 32) & 0xFFFFFFFF)
    lo = jnp.uint32(value & 0xFFFFFFFF)
    return U64(hi, lo)


# ---------------------------------------------------------------- 32-bit

def modadd32(a, b, q):
    """(a + b) mod q; q <= 2^30 so no lane overflow (cuh:270-276)."""
    s = a + b
    return jnp.where(s >= q, s - q, s)


def modsub32(a, b, q):
    """(a - b) mod q via +q (cuh:280-287); q may be scalar or array."""
    d = a + jnp.asarray(q, jnp.uint32) - b
    return jnp.where(d >= q, d - q, d)


def barrett_mul32(a, b, q: int, bit: int, mu: int):
    """Exact (a*b) mod q, reference schedule (modular_arith.cuh:316-326)."""
    z = mul32x32_64(a, b)
    w = u64_shr(z, bit - 2).lo
    t = mul32x32_64(w, jnp.uint32(mu))
    w2 = u64_shr(t, bit + 3).lo
    res = z.lo - mul32x32_lo(w2, jnp.uint32(q))
    return jnp.where(res >= q, res - q, res)


def barrett_reduce32(x, q: int, bit: int, mu: int):
    """x mod q for x < 2^32 (modular_arith.cuh:346-355)."""
    z = U64(jnp.zeros_like(x), x)
    w = u64_shr(z, bit - 2).lo
    t = mul32x32_64(w, jnp.uint32(mu))
    w2 = u64_shr(t, bit + 3).lo
    res = x - mul32x32_lo(w2, jnp.uint32(q))
    return jnp.where(res >= q, res - q, res)


def shoup_mul32(x, w, w_shoup, q):
    """x * w mod q with precomputed w' = floor(w << 32 / q); w < q, x < q."""
    hi = mul32x32_64(x, w_shoup).hi
    r = mul32x32_lo(x, w) - mul32x32_lo(hi, jnp.asarray(q, jnp.uint32))
    return jnp.where(r >= q, r - q, r)


def reduce_signed32(x, q):
    """int32 -> [0, q) (modular_arith.cuh:372-385): q + x for x < 0.

    Wrapping uint32 add of q reproduces q - |x| exactly for |x| <= q.
    """
    xu = x.astype(jnp.uint32) if x.dtype != jnp.uint32 else x
    neg = (xu >> 31).astype(jnp.bool_)
    return jnp.where(neg, xu + jnp.asarray(q, jnp.uint32), xu)


def centered32(x, q):
    """[0, q) -> [-q/2, q/2) as int32 (modular_arith.cuh:389-405)."""
    q = jnp.asarray(q, jnp.uint32)
    half = q >> 1
    wrapped = jnp.where(x > half, x - q, x)
    return wrapped.astype(jnp.int32)


# ---------------------------------------------------------------- 64-bit

def modadd64(a: U64, b: U64, q: U64) -> U64:
    s = u64_add(a, b)  # a, b < q <= 2^62: no 64-bit overflow
    d = u64_sub(s, q)
    return u64_select(u64_gte(s, q), d, s)


def modsub64(a: U64, b: U64, q: U64) -> U64:
    d = u64_sub(u64_add(a, q), b)
    d2 = u64_sub(d, q)
    return u64_select(u64_gte(d, q), d2, d)


def barrett_mul64(a: U64, b: U64, q: int, bit: int, mu: int) -> U64:
    """Exact (a*b) mod q, reference schedule (modular_arith.cuh:328-338)."""
    qc = u64_const(q)
    z = mul64x64_128(a, b)
    w = u128_shr_lo64(z, bit - 2)
    t = mul64x64_128(w, u64_const(mu))
    w2 = u128_shr_lo64(t, bit + 3)
    r = mul64x64_lo(w2, qc)
    res = u64_sub(z.lo64, r)
    resq = u64_sub(res, qc)
    return u64_select(u64_gte(res, qc), resq, res)


def barrett_reduce64(x: U64, q: int, bit: int, mu: int) -> U64:
    qc = u64_const(q)
    w = u64_shr(x, bit - 2)
    t = mul64x64_128(w, u64_const(mu))
    w2 = u128_shr_lo64(t, bit + 3)
    r = mul64x64_lo(w2, qc)
    res = u64_sub(x, r)
    resq = u64_sub(res, qc)
    return u64_select(u64_gte(res, qc), resq, res)


def shoup_mul64(x: U64, w: U64, w_shoup: U64, q: U64) -> U64:
    """x * w mod q with w' = floor(w << 64 / q); w < q <= 2^62, x < q."""
    hi = mul64x64_hi(x, w_shoup)
    r = u64_sub(mul64x64_lo(x, w), mul64x64_lo(hi, q))
    rq = u64_sub(r, q)
    return u64_select(u64_gte(r, q), rq, r)


def reduce_signed64(x: U64, q: U64) -> U64:
    """int64 (as pair bit-pattern) -> [0, q): q + x for x < 0."""
    neg = (x.hi >> 31).astype(jnp.bool_)
    wrapped = u64_add(x, q)
    return u64_select(neg, wrapped, x)


def centered64(x: U64, q: U64) -> U64:
    """[0, q) -> [-q/2, q/2) as int64 bit-pattern pair."""
    half = u64_shr(q, 1)
    gt_half = u64_lt_strict(half, x)
    wrapped = u64_sub(x, q)
    return u64_select(gt_half, wrapped, x)


def u64_lt_strict(a: U64, b: U64):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


# ------------------------------------------ forced / wide reductions

def reduce_forced32(x, q: int, bit: int, mu: int):
    """x mod q for ANY uint32 x and any q >= 2 (modular_arith.cuh:407-418).

    Barrett-by-one with c = floor(2^32 / q): the quotient estimate
    floor(x*c / 2^32) undershoots floor(x/q) by at most 1, so two
    conditional subtracts canonicalise — no domain restriction, unlike
    a bare `bit`-parameterised Barrett pass (which is only valid for
    x < 2^(2 bit + 1))."""
    c = (1 << 32) // q
    hi = mul32x32_64(x, jnp.uint32(c)).hi
    r = x - mul32x32_lo(hi, jnp.uint32(q))
    # undershoot of the quotient estimate is <= 1 (c > 2^32/q - 1 gives
    # hi >= floor(x/q) - 1), so r < 2q and ONE conditional subtract
    # canonicalises; r itself always fits the word (r <= x).  A second
    # `r >= 2q` subtract would be dead — and its 2q constant overflows
    # the word for q >= 2^31, which is why it is absent.
    return jnp.where(r >= q, r - jnp.uint32(q), r)


def reduce_forced64(x: U64, q: int, bit: int, mu: int) -> U64:
    """x mod q for ANY u64 pair and any q >= 2 (modular_arith.cuh:407-418)."""
    qc = u64_const(q)
    c = u64_const((1 << 64) // q)
    hi = mul64x64_hi(x, c)  # quotient undershoot <= 1 -> r < 2q
    r = u64_sub(x, mul64x64_lo(hi, qc))
    return u64_select(u64_gte(r, qc), u64_sub(r, qc), r)


def barrett_reduce_wide32(z: U64, q: int, bit: int, mu: int):
    """Two-limb reduce: 64-bit z mod 32-bit-class q
    (modular_arith.cuh:420-436, the T1* overload).  Valid for z < q^2,
    the domain of every product of canonical residues."""
    w = u64_shr(z, bit - 2).lo
    t = mul32x32_64(w, jnp.uint32(mu))
    w2 = u64_shr(t, bit + 3).lo
    r = u64_sub(z, mul32x32_64(w2, jnp.uint32(q)))
    res = r.lo
    return jnp.where(res >= q, res - q, res)


def barrett_reduce_wide64(z: U128, q: int, bit: int, mu: int) -> U64:
    """Four-limb reduce: 128-bit z mod 62-bit-class q
    (modular_arith.cuh:438-451).  Valid for z < q^2."""
    qc = u64_const(q)
    w = u128_shr_lo64(z, bit - 2)
    t = mul64x64_128(w, u64_const(mu))
    w2 = u128_shr_lo64(t, bit + 3)
    r = mul64x64_lo(w2, qc)
    res = u64_sub(z.lo64, r)
    resq = u64_sub(res, qc)
    return u64_select(u64_gte(res, qc), resq, res)


# ----------------------------------------------- lazy (Harvey) variants
#
# For transform-internal stages values may live in [0, 4q) (u32: q<2^30,
# u64: q<2^62 — exactly the reference's documented modulus bounds,
# modular_arith.cuh:66-67).  shoup_mul*_lazy returns [0, 2q) for ANY
# input < 2^word (proof: r = wx - q*floor(w'x/2^word) <= q*x/2^word + q
# < 2q), so a stage is: normalize to [0,2q) once, multiply lazily, and
# add/sub without conditionals.  Outputs only become canonical residues
# after the final normalization, which is where bit-exactness is defined.


def shoup_mul32_lazy(x, w, w_shoup, q):
    """x*w mod q + e*q with e in {0,1}; result < 2q for any uint32 x."""
    hi = mul32x32_64(x, w_shoup).hi
    return mul32x32_lo(x, w) - mul32x32_lo(hi, jnp.asarray(q, jnp.uint32))


def cond_sub32(x, c):
    """x - c if x >= c else x (one normalization step)."""
    c = jnp.asarray(c, jnp.uint32)
    return jnp.where(x >= c, x - c, x)


def mul64x64_hi_approx(a: U64, b: U64) -> U64:
    """High 64 bits of a*b, possibly UNDERestimated by 1 (drops the
    lo*lo partial product: 12 lane muls instead of 16)."""
    p1 = mul32x32_64(a.lo, b.hi)
    p2 = mul32x32_64(a.hi, b.lo)
    p3 = mul32x32_64(a.hi, b.hi)
    w1 = p1.lo + p2.lo
    c1 = (w1 < p1.lo).astype(jnp.uint32)
    s2 = p1.hi + p2.hi
    c3 = (s2 < p1.hi).astype(jnp.uint32)
    s2b = s2 + p3.lo
    c4 = (s2b < s2).astype(jnp.uint32)
    w2 = s2b + c1
    c5 = (w2 < s2b).astype(jnp.uint32)
    return U64(p3.hi + c3 + c4 + c5, w2)


def shoup_mul64_lazy(x: U64, w: U64, w_shoup: U64, q: U64) -> U64:
    """x*w mod q + e*q with e in {0,1,2}; result < 3q for any x < 2^64
    (Shoup bound 2q plus <=1q from the approximate hi)."""
    hi = mul64x64_hi_approx(x, w_shoup)
    return u64_sub(mul64x64_lo(x, w), mul64x64_lo(hi, q))


def shoup_pow2_lazy(x: U64, s: int, w_shoup: U64, q: U64) -> U64:
    """shoup_mul64_lazy specialized to w = 2^s (requires 2^s < q so that
    2^s mod q IS 2^s): lo64(x * 2^s) is a static shift, saving the
    16-lane-mul mul64x64_lo.  Same lazy bound (< 3q for any x)."""
    hi = mul64x64_hi_approx(x, w_shoup)
    return u64_sub(u64_shl(x, s), mul64x64_lo(hi, q))


def cond_sub64(x: U64, c: U64) -> U64:
    d = u64_sub(x, c)
    return u64_select(u64_gte(x, c), d, x)


# ------------------------------------------------- host-side table prep

def shoup_companion(values, q: int, word: int) -> np.ndarray:
    """floor(v << word / q) for each v, exact (host side)."""
    values = np.asarray(values)
    if word == 32:
        # q < 2^30: exact in uint64
        v = values.astype(np.uint64)
        return ((v << np.uint64(32)) // np.uint64(q)).astype(np.uint32)
    from .. import _native

    if values.size >= 1 << 10 and _native.available():
        return _native.shoup_table(values, q)
    vals = [(int(v) << word) // q for v in values.ravel()]
    return np.array(vals, dtype=np.uint64).reshape(values.shape)
