"""Golden-model self-validation.

Rebuilds the reference's cpu_*_examples (test_cpu_merge_ntt.cu:69-101,
test_cpu_4step_ntt.cu:64-78): NTT -> pointwise mult -> INTT must equal
schoolbook polynomial multiplication, and forward/inverse must be an
identity — for both dtypes and both reduction polynomials.
"""

import numpy as np
import pytest

from gpuntt import (
    NTTCPU,
    NTT4StepCPU,
    NTTParameters,
    NTTParameters4Step,
    ReductionPolynomial,
    schoolbook_poly_multiplication,
)


def _random_poly(rng, n, q, dtype):
    return rng.integers(0, q, size=n, dtype=np.uint64).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
@pytest.mark.parametrize("logn", [3, 6, 11])
def test_merge_golden_polymul(dtype, poly, logn, rng):
    p = NTTParameters(logn, poly, dtype=dtype)
    gen = NTTCPU(p)
    q = p.modulus.value
    a = _random_poly(rng, p.n, q, dtype)
    b = _random_poly(rng, p.n, q, dtype)

    expected = schoolbook_poly_multiplication(a, b, p.modulus, poly)
    got = gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
def test_merge_golden_roundtrip(dtype, poly, rng):
    p = NTTParameters(9, poly, dtype=dtype)
    gen = NTTCPU(p)
    a = _random_poly(rng, p.n, p.modulus.value, dtype)
    np.testing.assert_array_equal(gen.intt(gen.ntt(a)), a)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_fourstep_golden_roundtrip(dtype, rng):
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=dtype)
    gen = NTT4StepCPU(p)
    a = _random_poly(rng, p.n, p.modulus.value, dtype)
    np.testing.assert_array_equal(gen.intt(gen.ntt(a)), a)


@pytest.mark.parametrize("dtype", [np.uint32])
def test_fourstep_golden_polymul(dtype, rng):
    # X_N_minus: 4-step NTT diagonalises cyclic convolution
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=dtype)
    gen = NTT4StepCPU(p)
    q = p.modulus.value
    a = _random_poly(rng, p.n, q, dtype)
    b = _random_poly(rng, p.n, q, dtype)
    expected = schoolbook_poly_multiplication(
        a, b, p.modulus, ReductionPolynomial.X_N_minus
    )
    got = gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))
    np.testing.assert_array_equal(got, expected)


def test_fourstep_matches_merge_spectrum(rng):
    """4-step and merge NTT over the same (modulus, omega) agree up to
    ordering: both evaluate the polynomial at every N-th root power, so
    the sorted spectra are identical multisets."""
    from gpuntt import NTTFactors

    p4 = NTTParameters4Step(12, ReductionPolynomial.X_N_minus,
                            dtype=np.uint32)
    pm = NTTParameters(12, ReductionPolynomial.X_N_minus, dtype=np.uint32,
                       factors=NTTFactors(p4.modulus, p4.omega, p4.psi))
    x = _random_poly(rng, p4.n, p4.modulus.value, np.uint32)
    s4 = NTT4StepCPU(p4).ntt(x)
    sm = NTTCPU(pm).ntt(x)
    np.testing.assert_array_equal(np.sort(s4), np.sort(sm))


def test_intt_first_transpose_is_reference_loop():
    """intt_first_transpose is the exact vector_to_matrix_intt
    permutation (ntt_4step_cpu.cu:230-247, :289-299)."""
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=np.uint32)
    gen = NTT4StepCPU(p)
    x = np.arange(p.n, dtype=np.uint32)
    got = gen.intt_first_transpose(x)
    # literal port of the reference loop
    n1, n2 = p.n1, p.n2
    matrix = [[] for _ in range(n2)]
    for i in range(n1):
        for j in range(n2):
            matrix[((i * n2) + j) // n1].append(x[i + (j * n1)])
    expected = np.array([v for row in matrix for v in row], dtype=np.uint32)
    np.testing.assert_array_equal(got, expected)
