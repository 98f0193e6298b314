"""Device merge-NTT example — `gpu_merge_ntt_examples` parity.

Three sections, mirroring test_merge_ntt.cu:
  1. device forward NTT bit-exact vs NTTCPU::ntt (:70-175)
  2. signed (centered) input -> unsigned spectrum (:184-341)
  3. PerCoefficient layout == transpose . PerPolynomial . transpose
     (:343-474)

Runs on whatever device JAX sees (the GPU if available, CPU otherwise).

Usage: python example_merge_ntt.py [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--platform=cpu|gpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np

from gpuntt import NTTCPU, NTTLayout, NTTParameters, ReductionPolynomial, check_result
from gpuntt.ops.dispatch import ntt
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

    # 1. unsigned forward parity
    x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    got = ntt(x, plan)
    exp = np.stack([gen.ntt(x[i]) for i in range(batch)])
    ok &= check_result(got, exp)

    # 2. signed input (values centered around 0)
    mag = rng.integers(0, q // 2, size=(batch, p.n), dtype=np.uint64)
    sign = rng.integers(0, 2, size=(batch, p.n)) * 2 - 1
    x_signed = (mag.astype(np.int64) * sign).astype(np.int64)
    got_s = ntt(x_signed, plan)
    unsigned = np.where(x_signed < 0, x_signed.astype(np.int64) + q,
                        x_signed).astype(np.uint64)
    exp_s = np.stack([gen.ntt(unsigned[i]) for i in range(batch)])
    ok &= check_result(got_s, exp_s)

    # 3. PerCoefficient layout on an (N, batch) buffer
    xc = np.ascontiguousarray(x.T)
    got_c = ntt(xc, plan, layout=NTTLayout.PerCoefficient)
    ok &= check_result(got_c, exp.T)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
