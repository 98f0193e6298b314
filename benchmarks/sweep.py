"""Latency sweep harness — the nvbench-equivalent measurement surface.

Mirrors the reference's benchmark binaries (bench_merge_ntt.cu:71-75,
:137-141; bench_4step_ntt.cu:96-100, :185-189): forward/inverse merge
NTT and 4-step NTT latency over logN sweeps, for 32- and 64-bit data.

Each cell is the median of `--calls` warm calls of the jitted
lane-level entry point with the plan as a jit argument, host clock
around each call ending in block_until_ready (utils.timing.time_calls).
A cell that fails to compile or run stops the sweep.  Each line is one
JSON record; a summary table prints at the end.

Usage:
  python benchmarks/sweep.py [--engine merge|4step|all]
                             [--sizes 12,14,16,...] [--batch-mb 64]
                             [--batch 1] [--layout poly|coeff]
                             [--platform cpu|gpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "examples"))
import _platform  # noqa: E402

_platform.apply()

import numpy as np  # noqa: E402


def _cell(fwd, inv, plan, lanes, calls):
    """(fwd seconds, inv seconds): medians of warm calls."""
    import jax

    from gpuntt.utils.timing import time_calls

    return (float(np.median(time_calls(jax.jit(fwd), lanes, plan, n=calls))),
            float(np.median(time_calls(jax.jit(inv), lanes, plan, n=calls))))


def bench_merge(logn: int, dtype, batch: int, rng, layout: str, calls: int):
    import jax
    import jax.numpy as jnp

    from gpuntt import NTTLayout, NTTParameters, ReductionPolynomial
    from gpuntt.ops.dispatch import intt_lanes, ntt_lanes
    from gpuntt.ops.merge_ntt import MergePlan, to_lanes

    p = NTTParameters(logn, ReductionPolynomial.X_N_plus, dtype=dtype)
    plan = MergePlan.from_params(p)
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    lanes = to_lanes(x.astype(dtype), plan.is64)
    lo = NTTLayout.PerPolynomial
    if layout == "coeff":
        # PerCoefficient: (N, batch) buffer, transform along axis 0 —
        # measures the relayout cost on top of the same engine
        lanes = jax.tree_util.tree_map(lambda a: jnp.moveaxis(a, 0, -1),
                                       lanes)
        lo = NTTLayout.PerCoefficient
    return _cell(lambda v, pl: ntt_lanes(v, pl, layout=lo),
                 lambda v, pl: intt_lanes(v, pl, layout=lo),
                 plan, lanes, calls)


def bench_4step(logn: int, dtype, batch: int, rng, calls: int):
    from gpuntt import NTTParameters4Step, ReductionPolynomial
    from gpuntt.ops.fourstep import (FourStepPlan, fourstep_intt_lanes,
                                     fourstep_ntt_lanes)
    from gpuntt.ops.merge_ntt import to_lanes

    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=dtype)
    plan = FourStepPlan.from_params(p)
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    lanes = to_lanes(x.astype(dtype), plan.is64)
    # core only, caller-side transposes excluded — matching the
    # reference bench, which times GPU_4STEP_NTT alone
    return _cell(fourstep_ntt_lanes, fourstep_intt_lanes, plan, lanes, calls)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="all", choices=["merge", "4step", "all"])
    ap.add_argument("--sizes", default="12,14,16,18,20,22,24")
    ap.add_argument("--dtypes", default="u32,u64")
    ap.add_argument("--batch-mb", type=int, default=64,
                    help="total data footprint per run (fixes work per size)")
    ap.add_argument("--batch", type=int, default=None,
                    help="fixed batch size (e.g. 1 for the reference's "
                         "nvbench latency scope); overrides --batch-mb")
    ap.add_argument("--layout", default="poly", choices=["poly", "coeff"],
                    help="merge-engine batch layout (coeff = "
                         "PerCoefficient, ntt.cu:1554-2075 equivalent)")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()

    import jax

    sizes = [int(s) for s in args.sizes.split(",")]
    dtypes = [np.uint32 if d == "u32" else np.uint64
              for d in args.dtypes.split(",")]
    rng = np.random.default_rng(0)
    dev = jax.devices()[0]
    rows = []

    for dtype in dtypes:
        dname = "u32" if dtype == np.uint32 else "u64"
        for logn in sizes:
            n = 1 << logn
            itemsize = np.dtype(dtype).itemsize
            batch = args.batch or max(1, (args.batch_mb << 20) // (n * itemsize))
            for engine in (["merge", "4step"] if args.engine == "all"
                           else [args.engine]):
                if engine == "4step" and not 12 <= logn <= 24:
                    continue
                if engine == "merge":
                    fwd, inv = bench_merge(logn, dtype, batch, rng,
                                           args.layout, args.calls)
                else:
                    fwd, inv = bench_4step(logn, dtype, batch, rng,
                                           args.calls)
                rec = {
                    "engine": engine, "logn": logn, "dtype": dname,
                    "batch": batch, "layout": args.layout,
                    "fwd_ms_per_batch": fwd * 1e3,
                    "inv_ms_per_batch": inv * 1e3,
                    "fwd_ntts_per_sec": batch / fwd,
                    "inv_ntts_per_sec": batch / inv,
                    "timing": f"median of {args.calls} warm calls",
                    "device": f"{dev.platform} {dev.device_kind}",
                }
                rows.append(rec)
                print(json.dumps(rec), flush=True)

    if rows:
        print(f"\n{'engine':7s} {'dtype':5s} {'logN':4s} {'batch':6s} "
              f"{'fwd NTTs/s':>12s} {'inv NTTs/s':>12s}")
        for r in rows:
            print(f"{r['engine']:7s} {r['dtype']:5s} {r['logn']:<4d} "
                  f"{r['batch']:<6d} {r['fwd_ntts_per_sec']:>12.0f} "
                  f"{r['inv_ntts_per_sec']:>12.0f}")


if __name__ == "__main__":
    main()
