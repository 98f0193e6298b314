"""Exact wide-integer arithmetic on uint32 lanes.

Replacement for the reference's device wide math
(modular_arith.cuh:174-460): CUDA gets 32x32->64 (`mult64`,
modular_arith.cuh:290-294) and 64x64->128 via PTX `mul.lo/hi.u64`
(:296-308); without jax x64 every lane is 32-bit, so we rebuild those products
from 16-bit limb partials with carry-free recombination.  64-bit data
rides as struct-of-arrays (hi, lo) uint32 pairs — no jax x64, no
emulated u64 ops.

Everything here is plain jnp on uint32, so it traces identically in
any jitted program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

MASK16 = 0xFFFF
MSB = 0x80000000


class U64(NamedTuple):
    """A 64-bit unsigned integer as (hi, lo) uint32 lanes."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def u64_from_numpy(x) -> U64:
    """Split a numpy uint64 array into (hi, lo) uint32 parts."""
    import numpy as np

    x = np.asarray(x, dtype=np.uint64)
    return U64(
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def u64_to_numpy(x: U64):
    import numpy as np

    hi = np.asarray(x.hi, dtype=np.uint64)
    lo = np.asarray(x.lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def ult(a, b):
    """Unsigned a < b on uint32 lanes."""
    return a < b


def ugte(a, b):
    """Unsigned a >= b on uint32 lanes."""
    return a >= b


def u64_lt(a: U64, b: U64):
    """Unsigned 64-bit a < b (lexicographic on limbs)."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def u64_gte(a: U64, b: U64):
    return ~u64_lt(a, b)


def mul32x32_64(a, b) -> U64:
    """Full 32x32 -> 64 product from four 16-bit partials.

    Carry-free recombination: mid = (ll >> 16) + lh16 + hl16 < 3 * 2^16,
    so every intermediate fits a uint32 exactly.  Replaces the CUDA
    `mult64` (modular_arith.cuh:290-294).
    """
    a = jnp.asarray(a, jnp.uint32)
    b = jnp.asarray(b, jnp.uint32)
    a_lo = a & MASK16
    a_hi = a >> 16
    b_lo = b & MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & MASK16) + (hl & MASK16)
    lo = (mid << 16) | (ll & MASK16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return U64(hi, lo)


def mul32x32_lo(a, b):
    """Low 32 bits of a*b — native wrap-around lane multiply."""
    return jnp.asarray(a, jnp.uint32) * jnp.asarray(b, jnp.uint32)


def u64_add(a: U64, b: U64) -> U64:
    """64-bit add (mod 2^64) with carry via unsigned compare."""
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(jnp.uint32)
    return U64(a.hi + b.hi + carry, lo)


def u64_add_u32(a: U64, b) -> U64:
    lo = a.lo + b
    carry = (lo < a.lo).astype(jnp.uint32)
    return U64(a.hi + carry, lo)


def u64_sub(a: U64, b: U64) -> U64:
    """64-bit subtract (mod 2^64) with borrow via unsigned compare.

    Mirrors the PTX sub.cc/subc pair (modular_arith.cuh:236-264).
    """
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(jnp.uint32)
    return U64(a.hi - b.hi - borrow, lo)


def u64_shr(a: U64, s: int) -> U64:
    """Logical right shift by a STATIC amount (modular_arith.cuh:224-234)."""
    s = int(s)
    if s == 0:
        return a
    if s < 32:
        return U64(a.hi >> s, (a.lo >> s) | (a.hi << (32 - s)))
    if s == 32:
        return U64(jnp.zeros_like(a.hi), a.hi)
    if s < 64:
        return U64(jnp.zeros_like(a.hi), a.hi >> (s - 32))
    return U64(jnp.zeros_like(a.hi), jnp.zeros_like(a.lo))


def u64_shl(a: U64, s: int) -> U64:
    s = int(s)
    if s == 0:
        return a
    if s < 32:
        return U64((a.hi << s) | (a.lo >> (32 - s)), a.lo << s)
    if s == 32:
        return U64(a.lo, jnp.zeros_like(a.lo))
    if s < 64:
        return U64(a.lo << (s - 32), jnp.zeros_like(a.lo))
    return U64(jnp.zeros_like(a.hi), jnp.zeros_like(a.lo))


class U128(NamedTuple):
    """128-bit unsigned as four uint32 limbs, w3 most significant."""

    w3: jnp.ndarray
    w2: jnp.ndarray
    w1: jnp.ndarray
    w0: jnp.ndarray

    @property
    def lo64(self) -> U64:
        return U64(self.w1, self.w0)

    @property
    def hi64(self) -> U64:
        return U64(self.w3, self.w2)


def mul64x64_128(a: U64, b: U64) -> U128:
    """Full 64x64 -> 128 product (replaces PTX mul.lo/hi.u64,
    modular_arith.cuh:296-308) from four 32x32->64 partials with an
    add-with-carry chain.
    """
    p0 = mul32x32_64(a.lo, b.lo)
    p1 = mul32x32_64(a.lo, b.hi)
    p2 = mul32x32_64(a.hi, b.lo)
    p3 = mul32x32_64(a.hi, b.hi)

    w0 = p0.lo

    s1 = p0.hi + p1.lo
    c1 = (s1 < p0.hi).astype(jnp.uint32)
    w1 = s1 + p2.lo
    c2 = (w1 < s1).astype(jnp.uint32)

    s2 = p1.hi + p2.hi
    c3 = (s2 < p1.hi).astype(jnp.uint32)
    s2b = s2 + p3.lo
    c4 = (s2b < s2).astype(jnp.uint32)
    w2 = s2b + c1 + c2
    c5 = (w2 < s2b).astype(jnp.uint32)

    w3 = p3.hi + c3 + c4 + c5
    return U128(w3, w2, w1, w0)


def mul64x64_lo(a: U64, b: U64) -> U64:
    """Low 64 bits of a*b — three partials instead of four."""
    p0 = mul32x32_64(a.lo, b.lo)
    hi = p0.hi + a.lo * b.hi + a.hi * b.lo
    return U64(hi, p0.lo)


def mul64x64_hi(a: U64, b: U64) -> U64:
    """High 64 bits of a*b (full product, discard low)."""
    return mul64x64_128(a, b).hi64


def u128_shr_lo64(z: U128, s: int) -> U64:
    """(z >> s) truncated to 64 bits, STATIC s in [0, 96]."""
    s = int(s)
    limbs = [z.w0, z.w1, z.w2, z.w3, jnp.zeros_like(z.w0)]
    k, r = divmod(s, 32)
    l0 = limbs[k] if k < 4 else jnp.zeros_like(z.w0)
    l1 = limbs[k + 1] if k + 1 < 4 else jnp.zeros_like(z.w0)
    l2 = limbs[k + 2] if k + 2 < 4 else jnp.zeros_like(z.w0)
    if r == 0:
        return U64(l1, l0)
    lo = (l0 >> r) | (l1 << (32 - r))
    hi = (l1 >> r) | (l2 << (32 - r))
    return U64(hi, lo)
