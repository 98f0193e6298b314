"""Property tests: uint32-lane wide arithmetic vs exact Python ints.

This is the correctness bedrock of the whole device path — every transform
reduces to these primitives (SURVEY.md §7 step 1).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpuntt.ops import limb
from gpuntt.ops import barrett as bo
from gpuntt import Modulus32, Modulus64

RNG = np.random.default_rng(123)
N = 4096


def _rand_u32(n=N, high=1 << 32):
    return RNG.integers(0, high, size=n, dtype=np.uint64).astype(np.uint32)


def _rand_u64(n=N, high=1 << 64):
    return RNG.integers(0, high, size=n, dtype=np.uint64)


def test_mul32x32_64():
    a, b = _rand_u32(), _rand_u32()
    hi, lo = limb.mul32x32_64(jnp.asarray(a), jnp.asarray(b))
    prod = a.astype(np.uint64) * b.astype(np.uint64)
    np.testing.assert_array_equal(np.asarray(lo), (prod & 0xFFFFFFFF).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(hi), (prod >> 32).astype(np.uint32))


def test_u64_add_sub():
    a, b = _rand_u64(), _rand_u64()
    ap, bp = limb.u64_from_numpy(a), limb.u64_from_numpy(b)
    np.testing.assert_array_equal(limb.u64_to_numpy(limb.u64_add(ap, bp)), a + b)
    np.testing.assert_array_equal(limb.u64_to_numpy(limb.u64_sub(ap, bp)), a - b)


@pytest.mark.parametrize("s", [0, 1, 5, 31, 32, 33, 57, 63])
def test_u64_shifts(s):
    a = _rand_u64()
    ap = limb.u64_from_numpy(a)
    np.testing.assert_array_equal(limb.u64_to_numpy(limb.u64_shr(ap, s)), a >> np.uint64(s))
    np.testing.assert_array_equal(limb.u64_to_numpy(limb.u64_shl(ap, s)), a << np.uint64(s))


def test_mul64x64_128():
    a, b = _rand_u64(512), _rand_u64(512)
    ap, bp = limb.u64_from_numpy(a), limb.u64_from_numpy(b)
    z = limb.mul64x64_128(ap, bp)
    lo = limb.u64_to_numpy(z.lo64)
    hi = limb.u64_to_numpy(z.hi64)
    for i in range(512):
        prod = int(a[i]) * int(b[i])
        assert int(lo[i]) == prod & ((1 << 64) - 1), i
        assert int(hi[i]) == prod >> 64, i
    # low-only and hi-only fast paths
    np.testing.assert_array_equal(limb.u64_to_numpy(limb.mul64x64_lo(ap, bp)), lo)
    np.testing.assert_array_equal(limb.u64_to_numpy(limb.mul64x64_hi(ap, bp)), hi)


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 55, 58, 63, 64, 65, 95])
def test_u128_shr_lo64(s):
    a, b = _rand_u64(512), _rand_u64(512)
    ap, bp = limb.u64_from_numpy(a), limb.u64_from_numpy(b)
    z = limb.mul64x64_128(ap, bp)
    got = limb.u64_to_numpy(limb.u128_shr_lo64(z, s))
    for i in range(512):
        prod = int(a[i]) * int(b[i])
        assert int(got[i]) == (prod >> s) & ((1 << 64) - 1), (s, i)


@pytest.mark.parametrize("q", [469762049, 268460033, 10000, 7681])
def test_barrett_mul32(q):
    m = Modulus32(q)
    a = _rand_u32(high=q)
    b = _rand_u32(high=q)
    got = np.asarray(bo.barrett_mul32(jnp.asarray(a), jnp.asarray(b), m.value, m.bit, m.mu))
    exp = ((a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(q)).astype(np.uint32)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("q", [469762049, 268460033])
def test_shoup_mul32(q):
    m = Modulus32(q)
    x = _rand_u32(high=q)
    w = _rand_u32(high=q)
    ws = bo.shoup_companion(w, q, 32)
    got = np.asarray(bo.shoup_mul32(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws), q))
    exp = ((x.astype(np.uint64) * w.astype(np.uint64)) % np.uint64(q)).astype(np.uint32)
    np.testing.assert_array_equal(got, exp)


def test_modadd_sub32():
    q = 469762049
    a = _rand_u32(high=q)
    b = _rand_u32(high=q)
    np.testing.assert_array_equal(
        np.asarray(bo.modadd32(jnp.asarray(a), jnp.asarray(b), q)),
        ((a.astype(np.uint64) + b) % np.uint64(q)).astype(np.uint32),
    )
    np.testing.assert_array_equal(
        np.asarray(bo.modsub32(jnp.asarray(a), jnp.asarray(b), q)),
        ((a.astype(np.int64) - b.astype(np.int64)) % q).astype(np.uint32),
    )


@pytest.mark.parametrize("q", [576460756061519873, 288230385815388161])
def test_barrett_mul64(q):
    m = Modulus64(q)
    a = _rand_u64(1024, high=q)
    b = _rand_u64(1024, high=q)
    got = limb.u64_to_numpy(
        bo.barrett_mul64(limb.u64_from_numpy(a), limb.u64_from_numpy(b), m.value, m.bit, m.mu)
    )
    for i in range(1024):
        assert int(got[i]) == (int(a[i]) * int(b[i])) % q, i


@pytest.mark.parametrize("q", [576460756061519873, 288230385815388161])
def test_shoup_mul64(q):
    x = _rand_u64(1024, high=q)
    w = _rand_u64(1024, high=q)
    ws = bo.shoup_companion(w, q, 64)
    got = limb.u64_to_numpy(
        bo.shoup_mul64(
            limb.u64_from_numpy(x),
            limb.u64_from_numpy(w),
            limb.u64_from_numpy(ws),
            bo.u64_const(q),
        )
    )
    for i in range(1024):
        assert int(got[i]) == (int(x[i]) * int(w[i])) % q, i


def test_modadd_sub64():
    q = 576460756061519873
    qc = bo.u64_const(q)
    a = _rand_u64(high=q)
    b = _rand_u64(high=q)
    ap, bp = limb.u64_from_numpy(a), limb.u64_from_numpy(b)
    np.testing.assert_array_equal(
        limb.u64_to_numpy(bo.modadd64(ap, bp, qc)), (a + b) % np.uint64(q)
    )
    exp_sub = (a.astype(object) - b.astype(object)) % q
    np.testing.assert_array_equal(
        limb.u64_to_numpy(bo.modsub64(ap, bp, qc)).astype(object), exp_sub
    )


def test_signed_and_centered_lanes():
    q = 469762049
    x = RNG.integers(-q, q, size=N).astype(np.int32)
    got = np.asarray(bo.reduce_signed32(jnp.asarray(x), q))
    exp = np.where(x < 0, q + x.astype(np.int64), x.astype(np.int64)).astype(np.uint32)
    np.testing.assert_array_equal(got, exp)

    u = _rand_u32(high=q)
    got_c = np.asarray(bo.centered32(jnp.asarray(u), q))
    half = q >> 1
    exp_c = np.where(u > half, u.astype(np.int64) - q, u.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(got_c, exp_c)

    q64 = 576460756061519873
    qc = bo.u64_const(q64)
    xs = RNG.integers(-(1 << 59), 1 << 59, size=N).astype(np.int64)
    xs_pair = limb.u64_from_numpy(xs.view(np.uint64))
    got64 = limb.u64_to_numpy(bo.reduce_signed64(xs_pair, qc))
    exp64 = np.where(xs < 0, q64 + xs.astype(object), xs.astype(object)) % (1 << 64)
    np.testing.assert_array_equal(got64.astype(object), exp64)

    u64v = _rand_u64(high=q64)
    got_c64 = limb.u64_to_numpy(bo.centered64(limb.u64_from_numpy(u64v), qc)).view(np.int64)
    half64 = q64 >> 1
    exp_c64 = np.where(u64v > half64, u64v.astype(np.int64) - q64, u64v.astype(np.int64))
    np.testing.assert_array_equal(got_c64, exp_c64)
