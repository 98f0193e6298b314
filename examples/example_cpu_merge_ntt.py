"""CPU merge-NTT example — `cpu_merge_ntt_examples` parity.

Validates the golden model itself: NTT -> pointwise mult -> INTT equals
schoolbook polynomial multiplication mod X^N - 1
(test_cpu_merge_ntt.cu:69-101).

Usage: python example_cpu_merge_ntt.py [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--platform=cpu|gpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np

from gpuntt import (
    NTTCPU,
    NTTParameters,
    ReductionPolynomial,
    check_result,
    schoolbook_poly_multiplication,
)


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 11
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 1

    p = NTTParameters(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    gen = NTTCPU(p)
    q = p.modulus.value
    rng = np.random.default_rng(0)

    ok = True
    for _ in range(batch):
        a = rng.integers(0, q, size=p.n, dtype=np.uint64)
        b = rng.integers(0, q, size=p.n, dtype=np.uint64)
        got = gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))
        exp = schoolbook_poly_multiplication(
            a, b, p.modulus, ReductionPolynomial.X_N_minus
        )
        ok &= check_result(got, exp)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
