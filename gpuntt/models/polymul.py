"""Polynomial multiplication engines — the framework's flagship models.

The reference ships this pipeline only as example code
(test_cpu_merge_ntt.cu:69-101: NTT -> pointwise mult -> INTT ==
schoolbook); here it is a first-class, jittable model:

- `PolynomialMultiplier`: single-device negacyclic/cyclic polynomial
  product over the merged NTT (any logn the merge pools support).
- `DistPolynomialMultiplier`: multi-device product over the distributed
  4-step NTT — forward both operands (one all_to_all each), pointwise
  Barrett product in the spectrum layout, inverse back.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax

from ..params.merge import NTTParameters, ReductionPolynomial
from ..params.fourstep import NTTParameters4Step
from ..ops.merge_ntt import MergePlan, from_lanes, to_lanes
from ..parallel.fourstep_dist import (
    DistFourStepPlan,
    dist_fourstep_intt,
    dist_fourstep_ntt,
)


@jax.jit
def _polymul_jit(a, b, plan):
    from ..ops.dispatch import polymul_lanes

    return polymul_lanes(a, b, plan)


@partial(jax.jit, static_argnames=("mesh", "chunks"))
def _dist_polymul_jit(a, b, dplan, mesh, chunks):
    from ..ops.dispatch import pointwise_mult_lanes

    fa = dist_fourstep_ntt(a, dplan, mesh, pipeline_chunks=chunks)
    fb = dist_fourstep_ntt(b, dplan, mesh, pipeline_chunks=chunks)
    fc = pointwise_mult_lanes(fa, fb, dplan.base)
    return dist_fourstep_intt(fc, dplan, mesh, pipeline_chunks=chunks)


class PolynomialMultiplier:
    """c = a * b mod (q, X^N +/- 1) via merge NTT (single device)."""

    def __init__(self, params: NTTParameters):
        self.params = params
        self.plan = MergePlan.from_params(params)
        self.bit = params.modulus.bit
        self.mu = params.modulus.mu

    def step_lanes(self, a, b):
        """Lane-representation product: the dispatch-level fused
        polymul_lanes as one jitted computation, with the plan passed
        as a jit argument (its tables stay runtime buffers, and repeat
        calls hit the same executable).  Composes into user jits."""
        return _polymul_jit(a, b, self.plan)

    def __call__(self, a, b) -> np.ndarray:
        lanes_a = to_lanes(np.asarray(a), self.plan.is64)
        lanes_b = to_lanes(np.asarray(b), self.plan.is64)
        return from_lanes(self.step_lanes(lanes_a, lanes_b), self.plan.is64)


class RNSPolynomialMultiplier:
    """Residue-wise products over an RNS prime ladder — the HE
    evaluation workload the RNS engines exist for.

    Operands are (mod_count, N) residue stacks (row i modulo the i-th
    member's q_i) or (k, mod_count, N) batches of them; the cyclic
    modulus schedule of the RNS dispatch (ntt.cu RNS kernels,
    q_index = b % mod_count) matches that row order exactly.
    `gpuntt.arith.host.crt_reconstruct` lifts results back to
    Z_{prod q_i} for host-side checks.
    """

    def __init__(self, members):
        from ..ops.rns import RNSMergePlan

        self.plan = RNSMergePlan.from_params(members)
        self.mod_count = self.plan.mod_count
        self.qs = self.plan.qs

    def __call__(self, a, b) -> np.ndarray:
        from ..ops.dispatch import rns_polymul

        a = np.asarray(a)
        b = np.asarray(b)
        if a.ndim < 2 or a.shape != b.shape or a.shape[-2] != self.mod_count:
            raise ValueError(
                f"operands must be (..., {self.mod_count}, N) residue "
                f"stacks, got {a.shape} and {b.shape}")
        n = a.shape[-1]
        out = rns_polymul(a.reshape(-1, n), b.reshape(-1, n), self.plan)
        return out.reshape(a.shape)


class DistPolynomialMultiplier:
    """c = a * b mod (q, X^N - 1) via distributed 4-step NTT.

    Operands live as (B, n1, n2) blocks sharded P('dp', None, 'sp');
    the product comes back in the same layout.  All cross-device traffic
    is the two all_to_alls inside each transform.
    """

    def __init__(self, params: NTTParameters4Step, mesh,
                 pipeline_chunks: int = 1):
        if params.poly_reduction != ReductionPolynomial.X_N_minus:
            raise ValueError("4-step polymul diagonalises cyclic convolution "
                             "(X_N_minus) only")
        self.params = params
        self.dplan = DistFourStepPlan.from_params(params)
        self.mesh = mesh
        self.bit = params.modulus.bit
        self.mu = params.modulus.mu
        self.pipeline_chunks = pipeline_chunks

    def step_lanes(self, a, b):
        """Full step: 2 forwards + pointwise + inverse, one jitted
        computation with the plan passed as a jit argument (its W tables
        run to hundreds of MB at ring 2^24).  Composes into user jits."""
        return _dist_polymul_jit(a, b, self.dplan, self.mesh,
                                 self.pipeline_chunks)


class DistRNSPolynomialMultiplier:
    """Residue-ladder products over a device mesh — the distributed
    rendition of RNSPolynomialMultiplier (no reference counterpart
    twice over: single-GPU reference, transforms-only RNS surface).

    Operands are (B, n1, n2) lane blocks sharded P('dp', None, 'sp')
    whose batch rows cycle through the prime ladder (row b modulo
    q_{b % mod_count}); all cross-device traffic is the two all_to_alls
    inside each transform, and the per-row Barrett spectrum product is
    local to every shard.
    """

    def __init__(self, members, mesh):
        from ..parallel.fourstep_rns_dist import DistRNSFourStepPlan

        for p in members:
            if p.poly_reduction != ReductionPolynomial.X_N_minus:
                raise ValueError(
                    "4-step polymul diagonalises cyclic convolution "
                    "(X_N_minus) only")
        self.dplan = DistRNSFourStepPlan.from_members(members)
        self.mesh = mesh
        self.mod_count = self.dplan.base.mod_count

    def step_lanes(self, a, b, mod_idx):
        from ..ops.dispatch import rns_pointwise_mult_lanes
        from ..parallel.fourstep_rns_dist import (dist_rns_fourstep_intt,
                                                  dist_rns_fourstep_ntt)

        d = self.dplan
        fa = dist_rns_fourstep_ntt(a, d, self.mesh, mod_idx)
        fb = dist_rns_fourstep_ntt(b, d, self.mesh, mod_idx)
        fc = rns_pointwise_mult_lanes(fa, fb, d.base, mod_idx)
        return dist_rns_fourstep_intt(fc, d, self.mesh, mod_idx)
