"""Golden parity of the merge engine through the public API, at every
ring size from 2^8 to 2^17 (the range the per-size device kernels of
earlier versions owned), both word widths, both reduction polynomials,
forward and inverse.

`ntt` / `intt` go through dispatch's engine choice and the cached jit
with the plan as an argument; the forward is compared with NTTCPU (the
native C++ core for u64), the inverse with NTTCPU.intt on arbitrary
residues (not only on spectra)."""

import numpy as np
import pytest

from gpuntt import NTTCPU, MergePlan, NTTParameters, ReductionPolynomial
from gpuntt.ops.dispatch import intt, ntt

BATCH = 3


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus],
    ids=["cyclic", "negacyclic"])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=["u32", "u64"])
@pytest.mark.parametrize("logn", range(8, 18))
def test_merge_engine_cell(logn, dtype, poly, direction):
    p = NTTParameters(logn, poly, dtype=dtype)
    plan = MergePlan.from_params(p)
    gen = NTTCPU(p)
    rng = np.random.default_rng(1000 * logn + 10 * poly.value
                                + (dtype == np.uint64))
    x = rng.integers(0, p.modulus.value, size=(BATCH, p.n),
                     dtype=np.uint64).astype(dtype)
    if direction == "fwd":
        got, ref = ntt(x, plan), gen.ntt
    else:
        got, ref = intt(x, plan), gen.intt
    exp = np.stack([ref(r) for r in x])
    np.testing.assert_array_equal(got.astype(dtype), exp)
