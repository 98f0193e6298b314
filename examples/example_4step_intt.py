"""Device 4-step INTT example — `gpu_4step_intt_examples` parity.

intt_first_transpose pre-permute -> 4-step inverse core -> transpose,
bit-exact vs NTT_4STEP_CPU::intt (test_4step_intt.cu:83-88, :151-179).

Usage: python example_4step_intt.py [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--platform=cpu|gpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np

import jax

from gpuntt import NTT4StepCPU, NTTParameters4Step, ReductionPolynomial, check_result
from gpuntt.ops.fourstep import fourstep_intt_full, FourStepPlan
from gpuntt.ops.merge_ntt import from_lanes, to_lanes


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    plan = FourStepPlan.from_params(p)
    gen = NTT4StepCPU(p)
    q = p.modulus.value
    rng = np.random.default_rng(0)

    x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)

    # fourstep_intt_full bundles the intt_first_transpose input permute,
    # the inverse core with fused n^-1, and the final transpose.
    got = from_lanes(jax.jit(fourstep_intt_full)(to_lanes(x, plan.is64), plan),
                     plan.is64)
    exp = np.stack([gen.intt(x[i]) for i in range(batch)])
    ok = check_result(got, exp)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
