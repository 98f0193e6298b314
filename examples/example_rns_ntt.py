"""RNS (multi-modulus) NTT example — no reference counterpart.

The reference's RNS overloads exist but its examples only exercise
mod_count = 1 (test_merge_ntt.cu:143-144); this script demonstrates the
real thing: a batch cycling through three 59-bit NTT primes, forward
and inverse, plus an explicit GPU_NTT_Modulus_Ordered-style schedule.
The whole schedule runs as one jitted program over stacked per-modulus
tables (ops/rns.py).

Usage: python example_rns_ntt.py [RING_SIZE_IN_LOG2] [BATCH]
Prints "All Correct." on success (check_result, common.cu:24-42).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np

from gpuntt import (Modulus64, find_ntt_primes, ntt_root_pair, NTTFactors, NTTParameters,
                        ReductionPolynomial, check_result, intt_rns,
                        ntt_modulus_ordered, intt_modulus_ordered, ntt_rns)
from gpuntt.ops.merge_ntt import from_lanes, to_lanes
from gpuntt.ops.rns import RNSMergePlan, rns_ntt_lanes


def rns_members(logn, count):
    """`count` distinct 59-bit NTT-friendly primes with their 2N-th roots."""
    out = []
    for q in find_ntt_primes(59, logn, count):
        om, psi = ntt_root_pair(q, logn)
        out.append(NTTParameters(
            logn, ReductionPolynomial.X_N_plus, dtype=np.uint64,
            factors=NTTFactors(Modulus64(q), om, psi)))
    return out


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 6

    members = rns_members(logn, 3)
    plan = RNSMergePlan.from_params(members)
    qs = np.array(plan.qs, dtype=np.uint64)
    rng = np.random.default_rng(0)

    # cyclic schedule (GPU_NTT RNS overload semantics)
    mod_idx = np.arange(batch) % plan.mod_count
    x = np.stack([rng.integers(0, qs[mod_idx[b]], plan_n := 1 << logn,
                               dtype=np.uint64) for b in range(batch)])
    spectrum = ntt_rns(x, plan)
    expected = from_lanes(rns_ntt_lanes(to_lanes(x, True), plan, mod_idx),
                          True)
    ok = check_result(spectrum, expected)
    ok &= check_result(intt_rns(spectrum, plan), x)

    # explicit modulus schedule (GPU_NTT_Modulus_Ordered semantics)
    order = np.array([2, 0, 1], dtype=np.int64)
    sched = order[np.arange(batch) % len(order)]
    y = np.stack([rng.integers(0, qs[sched[b]], 1 << logn, dtype=np.uint64)
                  for b in range(batch)])
    spec_o = ntt_modulus_ordered(y, plan, order)
    exp_o = from_lanes(rns_ntt_lanes(to_lanes(y, True), plan, sched), True)
    ok &= check_result(spec_o, exp_o)
    ok &= check_result(intt_modulus_ordered(spec_o, plan, order), y)

    print("All Correct." if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
