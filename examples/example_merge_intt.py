"""Device merge-INTT example — `gpu_merge_intt_examples` parity.

Three sections, mirroring test_merge_intt.cu:
  1. device inverse NTT bit-exact vs NTTCPU::intt (:46-200)
  2. signed-output INTT via centered reduction (:205-370)
  3. PerCoefficient layout check (:475-506)

Usage: python example_merge_intt.py [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--platform=cpu|gpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np

from gpuntt import NTTCPU, NTTLayout, NTTParameters, ReductionPolynomial, check_result
from gpuntt.ops.dispatch import intt
from gpuntt.ops.merge_ntt import MergePlan


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    p = NTTParameters(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    q = p.modulus.value
    rng = np.random.default_rng(0)

    ok = True

    # 1. unsigned inverse parity
    x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    got = intt(x, plan)
    exp = np.stack([gen.intt(x[i]) for i in range(batch)])
    ok &= check_result(got, exp)

    # 2. signed output: centered representatives in [-q/2, q/2)
    got_s = intt(x, plan, signed_output=True)
    half = q >> 1
    exp_s = np.where(exp > half, exp.astype(np.int64) - q,
                     exp.astype(np.int64))
    ok &= check_result(got_s, exp_s)

    # 3. PerCoefficient layout on an (N, batch) buffer
    xc = np.ascontiguousarray(x.T)
    got_c = intt(xc, plan, layout=NTTLayout.PerCoefficient)
    ok &= check_result(got_c, exp.T)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
