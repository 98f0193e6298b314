"""Field-layer tests: Modulus constants and host Barrett semantics.

Mirrors the implicit invariants of modular_arith.cuh:28-156.
"""

import random

import numpy as np
import pytest

from gpuntt import Modulus32, Modulus64, OPERATOR
from gpuntt.arith.host import barrett_mult


def test_modulus_constants_u32():
    m = Modulus32(469762049)
    assert m.bit == 29
    assert m.mu == (1 << (2 * 29 + 1)) // 469762049


def test_modulus_constants_u64():
    m = Modulus64(576460756061519873)
    assert m.bit == 60
    assert m.mu == (1 << (2 * 60 + 1)) // 576460756061519873


@pytest.mark.parametrize(
    "mod",
    [
        Modulus32(469762049),
        Modulus32(268460033),
        Modulus64(576460756061519873),
        Modulus64(288230385815388161),
    ],
)
def test_barrett_mult_exact(mod):
    """The reference's bit-2/bit+3 Barrett schedule is an exact modmul."""
    rnd = random.Random(0)
    for _ in range(2000):
        a = rnd.randrange(mod.value)
        b = rnd.randrange(mod.value)
        assert barrett_mult(a, b, mod) == (a * b) % mod.value


def test_host_ops():
    m = Modulus32(469762049)
    q = m.value
    rnd = random.Random(1)
    for _ in range(200):
        a = rnd.randrange(q)
        b = rnd.randrange(q)
        assert OPERATOR.add(a, b, m) == (a + b) % q
        assert OPERATOR.sub(a, b, m) == (a - b) % q
        assert OPERATOR.mult(a, b, m) == (a * b) % q
    assert OPERATOR.modinv(12345, m) == pow(12345, q - 2, q)
    assert OPERATOR.exp(3, 1000, m) == pow(3, 1000, q)


def test_signed_and_centered():
    m = Modulus32(469762049)
    assert OPERATOR.reduce_signed(-5, m) == m.value - 5
    assert OPERATOR.reduce_signed(7, m) == 7
    assert OPERATOR.centered_reduction(m.value - 3, m) == -3
    assert OPERATOR.centered_reduction(5, m) == 5
    half = m.value >> 1
    assert OPERATOR.centered_reduction(half, m) == half  # input > half only
    assert OPERATOR.centered_reduction(half + 1, m) == half + 1 - m.value


def test_wide_and_forced_reductions():
    """reduce_forced + two-limb Barrett reduce (modular_arith.cuh:407-451)
    against Python ints on the vector path."""
    import jax.numpy as jnp
    import numpy as np

    from gpuntt.arith.modulus import Modulus32, Modulus64
    from gpuntt.ops import barrett as bo
    from gpuntt.ops.limb import U128, U64, u64_to_numpy

    rnd = random.Random(2)

    m32 = Modulus32(469762049)
    xs = np.array([rnd.randrange(1 << 32) for _ in range(512)], dtype=np.uint32)
    got = np.asarray(bo.reduce_forced32(jnp.asarray(xs), m32.value, m32.bit, m32.mu))
    np.testing.assert_array_equal(got, xs.astype(np.uint64) % m32.value)

    zs = np.array([rnd.randrange(m32.value ** 2) for _ in range(512)], dtype=np.uint64)
    z = U64(jnp.asarray((zs >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((zs & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    got = np.asarray(bo.barrett_reduce_wide32(z, m32.value, m32.bit, m32.mu))
    np.testing.assert_array_equal(got, zs % m32.value)

    m64 = Modulus64(576460756061519873)
    q = m64.value
    zs128 = [rnd.randrange(q * q) for _ in range(256)]
    limbs = np.array([[(v >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]
                      for v in zs128], dtype=np.uint64).astype(np.uint32)
    z128 = U128(*(jnp.asarray(limbs[:, i]) for i in range(4)))
    got = u64_to_numpy(bo.barrett_reduce_wide64(z128, q, m64.bit, m64.mu))
    exp = np.array([v % q for v in zs128], dtype=np.uint64)
    np.testing.assert_array_equal(got, exp)
