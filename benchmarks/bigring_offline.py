"""Offline golden parity at logn 27/28 (butterfly engine vs native oracle).

The reference's merge dispatch tops out at 2^28 (ntt.cuh:677-698).
The suite tests full-size parity to 2^26 (tests/test_bigring.py);
27/28 are too heavy for every run (minutes of CPU compile and run each
plus the oracle), so this script runs them on demand.  Forces the CPU:
the golden comparison needs no GPU."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))
import time, numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')
from gpuntt import NTTParameters, ReductionPolynomial, _native
from gpuntt.ops.merge_ntt import MergePlan, from_lanes, merge_ntt_lanes, to_lanes

for logn, poly in [(27, ReductionPolynomial.X_N_plus),
                   (28, ReductionPolynomial.X_N_minus)]:
    t0 = time.time()
    p = NTTParameters(logn, poly, dtype=np.uint64)
    q = p.modulus.value
    rng = np.random.default_rng(logn)
    x = rng.integers(0, q, size=(1, p.n), dtype=np.uint64)
    exp = _native.ntt_merge(x, p.logn, p.forward_root_of_unity_table, q,
                            poly == ReductionPolynomial.X_N_plus)
    t_nat = time.time() - t0
    plan = MergePlan.from_params(p)
    t0 = time.time()
    got = from_lanes(jax.jit(merge_ntt_lanes)(to_lanes(x, True), plan), True)
    t_xla = time.time() - t0
    ok = np.array_equal(got, exp)
    print(f"logn {logn} {poly.name}: parity={'OK' if ok else 'FAIL'} "
          f"native={t_nat:.0f}s xla_compile+run={t_xla:.0f}s", flush=True)
    del x, exp, got, plan
print("done")
