"""Parameter/table generation tests (vs nttparameters.cu semantics)."""

import numpy as np
import pytest

from gpuntt import (
    NTTParameters,
    NTTParameters4Step,
    ReductionPolynomial,
    bitreverse,
    bitrev_permute,
)
from gpuntt.arith import host


def test_bitreverse():
    # nttparameters.cu:10-20
    assert bitreverse(0b001, 3) == 0b100
    assert bitreverse(0b110, 3) == 0b011
    assert bitreverse(5, 4) == 0b1010
    idx = [bitreverse(i, 4) for i in range(16)]
    assert sorted(idx) == list(range(16))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize(
    "poly", [ReductionPolynomial.X_N_minus, ReductionPolynomial.X_N_plus]
)
def test_merge_params_roots(dtype, poly):
    logn = 10
    p = NTTParameters(logn, poly, dtype=dtype)
    q = p.modulus.value
    n = p.n
    # omega is a primitive n-th root; psi a primitive 2n-th root with psi^2=omega
    assert pow(p.omega, n, q) == 1
    assert pow(p.omega, n // 2, q) != 1
    assert pow(p.psi, 2 * n, q) == 1
    assert pow(p.psi, 2, q) == p.omega % q or pow(p.psi, 2, q) == pow(
        p.omega, 1, q
    )
    # table sizes (nttparameters.cu:40-43)
    expected = n // 2 if poly == ReductionPolynomial.X_N_minus else n
    assert len(p.forward_root_of_unity_table) == expected
    # table contents are successive powers
    r = p.root_of_unity
    assert int(p.forward_root_of_unity_table[0]) == 1
    assert int(p.forward_root_of_unity_table[1]) == r % q
    assert int(p.forward_root_of_unity_table[5]) == pow(r, 5, q)
    # inverse table really is the inverse powers
    assert (
        int(p.forward_root_of_unity_table[3]) * int(p.inverse_root_of_unity_table[3])
    ) % q == 1
    # n_inv
    assert (p.n_inv * n) % q == 1


def test_gpu_table_is_bitreversed():
    p = NTTParameters(8, ReductionPolynomial.X_N_minus, dtype=np.uint32)
    gt = p.gpu_root_of_unity_table()
    lg = 7  # table size 128
    for i in [0, 1, 2, 3, 77, 127]:
        assert gt[i] == p.forward_root_of_unity_table[bitreverse(i, lg)]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_fourstep_params(dtype):
    p = NTTParameters4Step(12, ReductionPolynomial.X_N_minus, dtype=dtype)
    q = p.modulus.value
    assert (p.n1, p.n2) == (32, 128)
    assert pow(p.omega, p.n, q) == 1
    # small tables: powers of root^(n/n1), root^(n/n2)
    r1 = pow(p.root_of_unity, p.n // p.n1, q)
    assert int(p.n1_based_root_of_unity_table[1]) == r1
    assert len(p.n1_based_root_of_unity_table) == p.n1 // 2
    assert len(p.n2_based_root_of_unity_table) == p.n2 // 2
    # W table: W[i*n2+j] = root^(bitrev(i, log n1) * j)  (nttparameters.cu:382-396)
    W = p.W_root_of_unity_table
    lg1 = 5
    for i, j in [(0, 0), (1, 1), (3, 7), (31, 127), (17, 100)]:
        assert int(W[i * p.n2 + j]) == pow(
            p.root_of_unity, bitreverse(i, lg1) * j, q
        )
    # inverse W: W[i*n2+j] = invroot^(bitrev(j, log n2) * i)  (:430-444)
    Wi = p.W_inverse_root_of_unity_table
    lg2 = 7
    for i, j in [(0, 0), (1, 1), (3, 7), (31, 127), (17, 100)]:
        assert int(Wi[i * p.n2 + j]) == pow(
            p.inverse_root_of_unity, bitreverse(j, lg2) * i, q
        )


def test_fourstep_logn_range():
    from gpuntt import NTTParameterError

    with pytest.raises(NTTParameterError):
        NTTParameters4Step(11)
    with pytest.raises(NTTParameterError):
        NTTParameters4Step(25)
