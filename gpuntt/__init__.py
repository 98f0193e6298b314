"""gpuntt — a Number Theoretic Transform framework in JAX for NVIDIA GPUs.

A from-scratch JAX rebuild of the capabilities of
Alisah-Ozcan/GPU-NTT (merged radix-2 NTT + 4-step NTT over word-sized
prime fields, 32/64-bit moduli, batching, RNS, signed variants, forward
and inverse transforms):

- exact Barrett arithmetic on uint32 lanes (16-bit limb products; 64-bit
  data as (hi, lo) uint32 pairs) — no 64-bit hardware integers needed;
- per-stage twiddles as static slices of the bit-reversed tables — no
  gathers inside the transform;
- the 4-step N = n1 x n2 decomposition doubles as the multi-device
  sharding backbone (one all_to_all via shard_map).
"""

from .arith.modulus import Modulus, Modulus32, Modulus64
from .arith import host as OPERATOR
from .common.check import check_result
from .common.device import available_devices, default_device, device_summary
from .common.errors import (
    NTTError,
    NTTParameterError,
    NTTDeviceError,
    NTTDispatchError,
)
from .params.bitrev import bitreverse, bitrev_permute
from .params.merge import (
    NTTFactors,
    NTTLayout,
    NTTParameters,
    NTTType,
    ReductionPolynomial,
)
from .params.fourstep import MATRIX_DIMENSIONS, NTTParameters4Step
from .reference.merge_cpu import NTTCPU
from .reference.fourstep_cpu import NTT4StepCPU
from .reference.schoolbook import schoolbook_poly_multiplication
from .ops.merge_ntt import MergePlan
from .ops.fourstep import (
    FourStepPlan,
    fourstep_intt_full,
    fourstep_intt_lanes,
    fourstep_ntt_full,
    fourstep_ntt_lanes,
    transpose_lanes,
)
from .ops.dispatch import (
    NTTConfig,
    intt,
    intt_lanes,
    intt_modulus_ordered,
    intt_poly_ordered,
    intt_rns,
    ntt,
    ntt_lanes,
    ntt_modulus_ordered,
    ntt_poly_ordered,
    ntt_rns,
    pointwise_mult,
    pointwise_mult_lanes,
    polymul,
    polymul_lanes,
    rns_pointwise_mult,
    rns_pointwise_mult_lanes,
    rns_polymul,
)
from .ops.rns import RNSMergePlan
from .arith.host import (crt_reconstruct, find_ntt_primes,
                         is_prime_u64, ntt_root_pair)
from .ops.fourstep_rns import (
    RNSFourStepPlan,
    rns_fourstep_intt_full,
    rns_fourstep_intt_lanes,
    rns_fourstep_ntt_full,
    rns_fourstep_ntt_lanes,
)

__version__ = "0.1.0"

__all__ = [
    "Modulus",
    "Modulus32",
    "Modulus64",
    "OPERATOR",
    "check_result",
    "available_devices",
    "default_device",
    "device_summary",
    "NTTError",
    "NTTParameterError",
    "NTTDeviceError",
    "NTTDispatchError",
    "bitreverse",
    "bitrev_permute",
    "NTTFactors",
    "NTTLayout",
    "NTTParameters",
    "NTTType",
    "ReductionPolynomial",
    "MATRIX_DIMENSIONS",
    "NTTParameters4Step",
    "NTTCPU",
    "NTT4StepCPU",
    "schoolbook_poly_multiplication",
    "MergePlan",
    "FourStepPlan",
    "fourstep_intt_full",
    "fourstep_intt_lanes",
    "fourstep_ntt_full",
    "fourstep_ntt_lanes",
    "transpose_lanes",
    "NTTConfig",
    "intt",
    "intt_lanes",
    "intt_modulus_ordered",
    "intt_poly_ordered",
    "intt_rns",
    "ntt",
    "ntt_lanes",
    "ntt_modulus_ordered",
    "ntt_poly_ordered",
    "ntt_rns",
    "pointwise_mult",
    "pointwise_mult_lanes",
    "polymul",
    "polymul_lanes",
    "rns_pointwise_mult",
    "rns_pointwise_mult_lanes",
    "rns_polymul",
    "crt_reconstruct",
    "find_ntt_primes",
    "is_prime_u64",
    "ntt_root_pair",
    "RNSMergePlan",
    "RNSFourStepPlan",
    "rns_fourstep_ntt_lanes",
    "rns_fourstep_intt_lanes",
    "rns_fourstep_ntt_full",
    "rns_fourstep_intt_full",
]
