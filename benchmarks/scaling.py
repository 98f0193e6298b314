"""Multi-device scaling-efficiency harness for the distributed 4-step NTT.

No reference counterpart (GPU-NTT is single-device).  Measures the
throughput of the sharded 4-step
transform (column NTTs local -> all_to_all transpose -> row
NTTs local) as the 'sp' axis widens, reported as scaling efficiency
vs the 1-device run (median of warm calls, utils.timing.time_calls):

    eff(sp) = throughput(sp) / (sp * throughput(1))

On several GPUs of one host this measures the all_to_all over NVLink
and its overlap with compute; on the virtual CPU mesh it validates the
harness and the sharded program, not the interconnect — the report
labels which one it ran on.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/scaling.py [--logn 20] [--batch 4]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--logn", type=int, default=18)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpuntt import NTTParameters4Step, ReductionPolynomial
    from gpuntt.ops.merge_ntt import to_lanes
    from gpuntt.parallel.fourstep_dist import (DistFourStepPlan,
                                                   dist_fourstep_ntt)
    from gpuntt.parallel.mesh import make_mesh
    from gpuntt.utils.timing import time_calls

    n_dev = len(jax.devices())
    platform = jax.devices()[0].platform
    p = NTTParameters4Step(args.logn, ReductionPolynomial.X_N_minus,
                           dtype=np.uint64)
    dplan = DistFourStepPlan.from_params(p)
    rng = np.random.default_rng(0)
    q = p.modulus.value

    results = []
    base_tp = None
    sp = 1
    while sp <= n_dev:
        mesh = make_mesh(dp=1, sp=sp)
        sh = NamedSharding(mesh, P("dp", None, "sp"))
        x = rng.integers(0, q, size=(args.batch, p.n), dtype=np.uint64)
        lanes = jax.tree_util.tree_map(
            lambda v: jax.device_put(v, sh),
            to_lanes(x.reshape(args.batch, p.n1, p.n2), True),
        )
        fwd = jax.jit(lambda v, d: dist_fourstep_ntt(v, d, mesh))
        dt = float(np.median(time_calls(fwd, lanes, dplan)))
        tp = args.batch / dt
        if base_tp is None:
            base_tp = tp
        eff = tp / (sp * base_tp)
        rec = {"sp": sp, "ntts_per_sec": round(tp, 1),
               "scaling_efficiency": round(eff, 4),
               "ms_per_batch": round(dt * 1e3, 3),
               "platform": platform, "devices": n_dev}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        sp *= 2

    note = ("all_to_all measured across GPUs" if platform == "gpu"
            and n_dev > 1 else
            "virtual mesh: validates the sharded program, not the interconnect")
    print(json.dumps({"note": note}))


if __name__ == "__main__":
    main()
