"""Benchmark harness: headline merge-NTT cells on one NVIDIA GPU.

    python bench.py [--logn 16] [--batch 128] [--calls 20]

Times u64 forward / inverse / fused polymul at 2^logn x batch (X^N+1)
and u32 forward at 2^logn x batch and 2^20 x 16, each the median of
`--calls` warm calls of the jitted lane-level entry point (plan passed
as a jit argument), host clock around each call ending in
block_until_ready.  Prints the card's name and power limit, then one
JSON line.  Runs in one process and fails on any backend but the GPU.
Correctness is chip_smoke.py's job.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--logn", type=int, default=16)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    import jax

    from gpuntt import (MergePlan, NTTParameters, ReductionPolynomial,
                        intt_lanes, ntt_lanes, polymul_lanes)
    from gpuntt.ops.merge_ntt import to_lanes
    from gpuntt.utils.cache import enable_compile_cache
    from gpuntt.utils.timing import time_calls

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {dev.platform}",
              file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(0)

    def cell(logn, batch, dtype, *fns):
        p = NTTParameters(logn, ReductionPolynomial.X_N_plus, dtype=dtype)
        plan = MergePlan.from_params(p)
        is64 = np.dtype(dtype) == np.uint64

        def rand():
            x = rng.integers(0, p.modulus.value, size=(batch, p.n),
                             dtype=np.uint64)
            return to_lanes(x.astype(dtype), is64)

        out = {}
        for name, fn, nargs in fns:
            ins = [rand() for _ in range(nargs)]
            t = time_calls(jax.jit(fn), *ins, plan, n=args.calls)
            out[name] = float(np.median(t)) * 1e3
        return out

    u64 = cell(args.logn, args.batch, np.uint64,
               ("fwd_ms", ntt_lanes, 1), ("inv_ms", intt_lanes, 1),
               ("polymul_ms", polymul_lanes, 2))
    u32 = cell(args.logn, args.batch, np.uint32, ("fwd_ms", ntt_lanes, 1))
    u32l = cell(20, 16, np.uint32, ("fwd_ms", ntt_lanes, 1))
    print(json.dumps({
        "metric": f"fwd merge NTT 2^{args.logn} u64 batch {args.batch}, "
                  "NTTs/sec",
        "value": args.batch / (u64["fwd_ms"] * 1e-3),
        "unit": "NTTs/sec",
        "detail": {"u64": u64, f"u32_2^{args.logn}x{args.batch}": u32,
                   "u32_2^20x16": u32l,
                   "timing": f"median of {args.calls} warm calls, host "
                             "clock, block_until_ready",
                   "card": card},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
