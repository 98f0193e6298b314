"""NTT parameters for the 4-step (matrix) NTT.

Rebuild of the reference's `NTTParameters4Step<T>`
(nttparameters.cuh:106-170, nttparameters.cu:191-471): per-logn prime /
omega / psi pools (verbatim constants), the N = n1 x n2 factorisation
table, half-length small twiddle tables, and the W twiddle matrix with
its load-bearing bit-reversed exponents.

The W matrix W[i*n2+j] = root^(bitrev(i, log n1) * j) is generated as
per-row geometric series (base_i = root^bitrev(i, log n1)) instead of
n1*n2 modular exponentiations (nttparameters.cu:382-396) — identical
values, O(N) multiplications.
"""

from __future__ import annotations

import numpy as np

from ..arith import host
from ..arith.modulus import Modulus, Modulus32, Modulus64
from ..common.errors import custom_assert
from .bitrev import bitrev_permute, bitreverse
from .merge import ReductionPolynomial, _dtype_bits, _power_table

# Ring size -> matrix size (nttparameters.cu:305-354, doc ntt_4step.cuh:51-64)
MATRIX_DIMENSIONS: dict[int, tuple[int, int]] = {
    12: (32, 128),
    13: (32, 256),
    14: (32, 512),
    15: (64, 512),
    16: (128, 512),
    17: (32, 4096),
    18: (32, 8192),
    19: (32, 16384),
    20: (32, 32768),
    21: (64, 32768),
    22: (128, 32768),
    23: (128, 65536),
    24: (256, 65536),
}

# Prime pools (nttparameters.cu:229-255) — indexed by logn-12, verbatim.
_PRIMES_32 = [
    268460033, 268582913, 268664833, 268369921, 269221889,
    269221889, 270532609, 270532609, 270532609, 377487361,
    377487361, 469762049, 469762049,
]
_PRIMES_64 = [
    576460752303415297, 576460752303439873, 576460752304439297,
    576460752308273153, 576460752308273153, 576460752315482113,
    576460752315482113, 576460752340123649, 576460752364240897,
    576460752475389953, 576460752597024769, 576460753024843777,
    576460753175838721, 288230377292562433, 288230383802122241,
    288230385815388161, 288230385815388161,
]

# Omega pools (nttparameters.cu:256-280)
_W_32 = [
    36747374, 249229369, 4092529, 175218169, 10653696, 238764304,
    240100, 23104, 179776, 19321, 38809, 1600, 169,
]
_W_64 = [
    288482366111684746, 37048445140799662, 459782973201979845,
    64800917766465203, 425015386842055933, 18734847765732801,
    119109113519742895, 227584740857897520, 477282059544659462,
    570131728462077067, 433594414095420776, 219263994987749328,
    189790554094222112, 96649110792683523, 250648942594717784,
    279172744045218282, 225865349704673648,
]

# Psi pools (nttparameters.cu:282-303)
_PSI_32 = [
    77090, 15787, 2023, 13237, 3264, 15452, 490,
    152, 424, 139, 197, 40, 13,
]
_PSI_64 = [
    238394956950829, 54612008597396, 8242615629351, 16141297350887,
    3760097055997, 11571974431275, 328867687796, 2298846063117,
    731868219707, 409596963254, 189266227206, 31864818375,
    92067739764, 5214432335, 734084005, 3351406780, 717004697,
]


class NTTParameters4Step:
    """Parameters + tables for the 4-step NTT (nttparameters.cu:191-225)."""

    def __init__(
        self,
        logn: int,
        poly_reduction: ReductionPolynomial = ReductionPolynomial.X_N_minus,
        dtype=np.uint64,
        factors=None,
        dims: tuple[int, int] | None = None,
    ):
        """`dims` (extension, no reference counterpart): explicit
        (n1, n2) factorization overriding MATRIX_DIMENSIONS — lets the
        distributed 4-step choose row sizes beyond the reference table's
        n2 <= 65536 (e.g. 2^24 = 128 x 2^17).  Both must be powers of
        two with n1 * n2 == 2^logn.

        Spectrum-order caveat: the 4-step output ORDER depends on the
        factorization (each split is its own output convention, exactly
        as the reference's convention is its table's).  A custom-dims
        forward pairs with the same-dims inverse bit-exactly and
        pointwise products in the spectrum domain are order-independent
        (tests/test_fourstep.py::test_custom_dims_factorization), but
        spectra from DIFFERENT splits are permutations of each other —
        do not mix them elementwise."""
        self.logn = int(logn)
        self.n = 1 << self.logn
        self.poly_reduction = poly_reduction
        self.dtype = np.dtype(dtype)
        bits = _dtype_bits(dtype)

        custom_assert(12 <= self.logn <= 24, "LOGN should be in range 12 to 24.")
        if factors is not None:
            # caller-supplied NTTFactors{modulus, omega, psi}
            # (nttparameters.cuh:38-54) — the RNS 4-step members use this
            self.modulus = factors.modulus
            self.omega = factors.omega
            self.psi = factors.psi
        elif bits == 32:
            self.modulus: Modulus = Modulus32(_PRIMES_32[self.logn - 12])
            self.omega = _W_32[self.logn - 12]
            self.psi = _PSI_32[self.logn - 12]
        else:
            self.modulus = Modulus64(_PRIMES_64[self.logn - 12])
            self.omega = _W_64[self.logn - 12]
            self.psi = _PSI_64[self.logn - 12]

        self.root_of_unity = (
            self.omega
            if poly_reduction == ReductionPolynomial.X_N_minus
            else self.psi
        )
        self.inverse_root_of_unity = host.modinv(self.root_of_unity, self.modulus)
        self.root_of_unity_size = (
            1 << (self.logn - 1)
            if poly_reduction == ReductionPolynomial.X_N_minus
            else 1 << self.logn
        )

        if dims is not None:
            n1, n2 = int(dims[0]), int(dims[1])
            custom_assert(
                n1 >= 2 and n2 >= 2 and n1 & (n1 - 1) == 0
                and n2 & (n2 - 1) == 0 and n1 * n2 == self.n,
                "dims must be powers of two with n1 * n2 == 2^logn")
            self.n1, self.n2 = n1, n2
        else:
            self.n1, self.n2 = MATRIX_DIMENSIONS[self.logn]
        q = self.modulus.value

        # Small half-length tables (nttparameters.cu:356-380, :398-428):
        # base roots are root_of_unity^(n/n1) and ^(n/n2).
        r_n1 = host.exp(self.root_of_unity, self.n // self.n1, self.modulus)
        r_n2 = host.exp(self.root_of_unity, self.n // self.n2, self.modulus)
        self.n1_based_root_of_unity_table = np.array(
            _power_table(r_n1, q, self.n1 >> 1), dtype=self.dtype
        )
        self.n2_based_root_of_unity_table = np.array(
            _power_table(r_n2, q, self.n2 >> 1), dtype=self.dtype
        )
        self.n1_based_inverse_root_of_unity_table = np.array(
            _power_table(host.modinv(r_n1, self.modulus), q, self.n1 >> 1),
            dtype=self.dtype,
        )
        self.n2_based_inverse_root_of_unity_table = np.array(
            _power_table(host.modinv(r_n2, self.modulus), q, self.n2 >> 1),
            dtype=self.dtype,
        )

        self.n_inv = host.modinv(self.n, self.modulus)

        self._w_forward: np.ndarray | None = None
        self._w_inverse: np.ndarray | None = None
        self._w_chain_inverse: np.ndarray | None = None

    # --- W twiddle matrices (lazy: O(N) ints, large for logn 24) ---

    @property
    def W_root_of_unity_table(self) -> np.ndarray:
        """Forward W: W[i, j] = root^(bitrev(i, log n1) * j)
        (nttparameters.cu:382-396), flattened row-major like the reference.
        """
        if self._w_forward is None:
            self._w_forward = self._w_table(
                self.root_of_unity, self.n1, self.n2, bitrev_rows=True
            )
        return self._w_forward

    @property
    def W_inverse_root_of_unity_table(self) -> np.ndarray:
        """Inverse W: W[i, j] = invroot^(bitrev(j, log n2) * i)
        (nttparameters.cu:430-444).
        """
        if self._w_inverse is None:
            self._w_inverse = self._w_table(
                self.inverse_root_of_unity, self.n1, self.n2, bitrev_rows=False
            )
        return self._w_inverse

    @property
    def W_chain_inverse_table(self) -> np.ndarray:
        """Elementwise inverse of the FORWARD W: invroot^(bitrev(i, log n1)*j).

        No reference counterpart: the reference's inverse pipeline uses a
        differently-indexed W_inverse (nttparameters.cu:430-444) because
        its INTT runs through the vector_to_matrix_intt permutation; the
        distributed inverse (parallel/fourstep_dist.py) instead
        inverts the forward chain directly, which needs W^-1 with the
        forward's index pattern.  Exact integers: both routes produce
        bit-identical transforms.
        """
        if self._w_chain_inverse is None:
            self._w_chain_inverse = self._w_table(
                self.inverse_root_of_unity, self.n1, self.n2, bitrev_rows=True
            )
        return self._w_chain_inverse

    def _w_table(self, root: int, n1: int, n2: int, bitrev_rows: bool) -> np.ndarray:
        q = self.modulus.value
        from .. import _native

        if n1 * n2 >= 1 << 14 and _native.available():
            w = (
                _native.w_table_forward(root, q, n1, n2)
                if bitrev_rows
                else _native.w_table_inverse(root, q, n1, n2)
            )
            return w.astype(self.dtype)
        out = np.empty((n1, n2), dtype=self.dtype)
        if bitrev_rows:
            lg = n1.bit_length() - 1
            for i in range(n1):
                base = pow(root, bitreverse(i, lg), q)
                out[i, :] = _power_table(base, q, n2)
        else:
            # rows indexed by i, exponent = bitrev(j, log n2) * i:
            # row i is (root^i)^bitrev(j); build row from the bitrev-permuted
            # power table of root^i.
            brev = _bitrev_idx(n2)
            for i in range(n1):
                base = pow(root, i, q)
                row = np.array(_power_table(base, q, n2), dtype=self.dtype)
                out[i, :] = row[brev]
        return out.reshape(-1)

    def gpu_root_of_unity_table(self, table: np.ndarray) -> np.ndarray:
        """Bit-reversed permutation of a small table (nttparameters.cu:456-471)."""
        return bitrev_permute(np.asarray(table))


def _bitrev_idx(n: int) -> np.ndarray:
    from .bitrev import bitreverse_indices

    return bitreverse_indices(n.bit_length() - 1)
