"""Device 4-step NTT example — `gpu_4step_ntt_examples` parity.

transpose -> 4-step core -> transpose, bit-exact vs NTT_4STEP_CPU::ntt
(test_4step_ntt.cu:147-178).  The core keeps the reference's calling
convention: the first/last transposes are the caller's job
(ntt_4step.cuh:68-74), shown here explicitly with transpose_lanes.

Usage: python example_4step_ntt.py [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--platform=cpu|gpu]
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
from gpuntt.ops.fourstep import FourStepPlan, fourstep_ntt_lanes, transpose_lanes
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

    def pipeline(v):
        v = transpose_lanes(v, plan.n1, plan.n2)   # caller-side step 0
        v = fourstep_ntt_lanes(v, plan)            # GPU_4STEP_NTT core
        return transpose_lanes(v, plan.n1, plan.n2)  # caller-side step 4

    pipeline = jax.jit(pipeline)

    got = from_lanes(pipeline(to_lanes(x, plan.is64)), plan.is64)
    exp = np.stack([gen.ntt(x[i]) for i in range(batch)])
    ok = check_result(got, exp)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
