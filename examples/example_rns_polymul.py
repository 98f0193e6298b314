"""HE-style RNS polynomial multiplication example — no reference
counterpart (the reference leaves the per-modulus pointwise loop and
the CRT lift entirely to the caller; its RNS surface is transforms
only, ntt.cu:2560-3059).

A polynomial over Z_Q (Q = product of a prime ladder) is held as
residue rows; one RNSPolynomialMultiplier call computes the cyclic
convolution residue-wise — and crt_reconstruct lifts the result back
to Z_Q, where it is checked against an exact big-integer schoolbook
product.

Usage: python example_rns_polymul.py [RING_SIZE_IN_LOG2] [MOD_COUNT]
Prints "All Correct." on success (check_result, common.cu:24-42).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np

from gpuntt import (Modulus64, NTTFactors, NTTParameters,
                        ReductionPolynomial, crt_reconstruct,
                        find_ntt_primes, ntt_root_pair)
from gpuntt.models.polymul import RNSPolynomialMultiplier


def rns_members(logn, count):
    """`count` distinct ~2^59 NTT-friendly primes with their 2N-th roots.

    X_N_minus: the 4-step/HE-style cyclic convolution basis."""
    out = []
    for q in find_ntt_primes(59, logn, count):
        om, psi = ntt_root_pair(q, logn)
        out.append(NTTParameters(
            logn, ReductionPolynomial.X_N_minus, dtype=np.uint64,
            factors=NTTFactors(Modulus64(q), om, psi)))
    return out


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    mod_count = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    members = rns_members(logn, mod_count)
    qs = [m.modulus.value for m in members]
    big_q = 1
    for q in qs:
        big_q *= q
    n = 1 << logn
    model = RNSPolynomialMultiplier(members)
    rng = np.random.default_rng(0)

    # operands over Z_Q, held as residue stacks
    a_int = [int.from_bytes(rng.bytes(16), "little") % big_q
             for _ in range(n)]
    b_int = [int.from_bytes(rng.bytes(16), "little") % big_q
             for _ in range(n)]
    a = np.stack([np.array([x % q for x in a_int], dtype=np.uint64)
                  for q in qs])
    b = np.stack([np.array([x % q for x in b_int], dtype=np.uint64)
                  for q in qs])

    got = crt_reconstruct(model(a, b), qs)

    # exact big-integer cyclic schoolbook mod Q (X^N - 1)
    exp = [0] * n
    for i in range(n):
        ai = a_int[i]
        for j in range(n):
            exp[(i + j) % n] = (exp[(i + j) % n] + ai * b_int[j]) % big_q

    ok = got == exp
    print("All Correct." if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
