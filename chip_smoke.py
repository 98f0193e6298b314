"""Smoke run of the NTT main path on one GPU, through the public API.

    python chip_smoke.py               # full widths, one GPU
    python chip_smoke.py --four-cards  # distributed 4-step on four GPUs only
    python chip_smoke.py --rehearse    # tiny widths on the CPU; no result line

Every phase runs the library's jitted entry points with the plan passed
as a jit argument, times the first call (compilation included) and one
warm call on the host clock (ending in block_until_ready), and checks the
result bit-exact against an independent reference: the native C++ oracle
(gpuntt/_native) where it builds, else the numpy golden models
(NTTCPU / NTT4StepCPU) on sampled rows plus a full-batch round trip.
All arithmetic is exact integer, so every comparison is equality.

The whole run is one process.  Any failed phase makes the exit code 1
and suppresses the last line, which on success is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FULL = dict(he_logn=16, he_batch=128, u64_logn=16, u64_batch=128,
            u32_cells=((16, 128), (20, 16)), rns_logn=16, rns_primes=8,
            rns_stacks=8, fs_logn=20, fs_batch=4, big_logn=24,
            dist_logn=24, dist_batch=8)
REHEARSE = dict(he_logn=10, he_batch=4, u64_logn=11, u64_batch=4,
                u32_cells=((10, 4), (12, 2)), rns_logn=10, rns_primes=3,
                rns_stacks=2, fs_logn=12, fs_batch=2, big_logn=14,
                dist_logn=16, dist_batch=4)


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines, read in a child
    process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def _ready(out):
    import jax

    return jax.block_until_ready(out)


def timed(fn, *args):
    """(output, first-call seconds incl. compilation, warm seconds)."""
    t0 = time.perf_counter()
    out = _ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _ready(fn(*args))
    return out, first, time.perf_counter() - t0


class Oracle:
    """Reference transforms for the comparisons.  u64 goes to the native
    C++ core when it builds (NTTCPU/NTT4StepCPU route there themselves);
    otherwise the numpy models, which are slow at 64 bits, check
    `rows` sampled rows.  u32 always uses the numpy model on every row."""

    def __init__(self):
        from gpuntt import _native

        self.native = _native.available()

    def name(self, is64: bool) -> str:
        if not is64:
            return "NTTCPU/NTT4StepCPU numpy, all rows"
        if self.native:
            return "native C++ oracle, all rows"
        return "NTTCPU/NTT4StepCPU numpy, 4 sampled rows"

    def rows(self, batch: int, is64: bool) -> np.ndarray:
        if not is64 or self.native:
            return np.arange(batch)
        return np.unique(np.linspace(0, batch - 1, 4).astype(int))

    def apply(self, fn, *xs, is64: bool = True, per_row: bool = False):
        """(rows checked, fn over those rows of xs)."""
        rows = self.rows(xs[0].shape[0], is64)
        if per_row or (is64 and not self.native):
            return rows, np.stack([fn(*(x[r] for x in xs)) for r in rows])
        return rows, fn(*(x[rows] for x in xs))


class Smoke:
    def __init__(self, sizes: dict, seed: int = 0):
        self.sizes = sizes
        self.rng = np.random.default_rng(seed)
        self.oracle = Oracle()
        self.failures: list[str] = []

    def rand(self, q: int, shape, dtype=np.uint64) -> np.ndarray:
        return self.rng.integers(0, q, size=shape, dtype=np.uint64).astype(dtype)

    def report(self, phase: str, shape: str, first: float, warm: float,
               oracle: str, checks: dict):
        ok = all(checks.values())
        if not ok:
            self.failures.append(phase)
        detail = ", ".join(f"{k}={'ok' if v else 'MISMATCH'}"
                           for k, v in checks.items())
        print(f"phase {phase} [{shape}]: first call {first:.2f} s "
              f"(compile + run), warm {warm * 1e3:.3f} ms, oracle: "
              f"{oracle}; {detail} -> {'PASS' if ok else 'FAIL'}",
              flush=True)

    def run(self, name: str, fn):
        try:
            fn()
        except Exception as e:  # recorded: any failure fails the run
            self.failures.append(name)
            print(f"phase {name}: ERROR {type(e).__name__}: {e}", flush=True)

    # ------------------------------------------------------------- phases

    def he_polymul_u64(self):
        from gpuntt import (NTTCPU, NTTParameters, ReductionPolynomial,
                           polymul)
        from gpuntt.models.polymul import PolynomialMultiplier
        from gpuntt.ops.merge_ntt import from_lanes, to_lanes

        logn, batch = self.sizes["he_logn"], self.sizes["he_batch"]
        p = NTTParameters(logn, ReductionPolynomial.X_N_plus, dtype=np.uint64)
        model = PolynomialMultiplier(p)
        q = p.modulus.value
        a, b = self.rand(q, (batch, p.n)), self.rand(q, (batch, p.n))
        la, lb = to_lanes(a, True), to_lanes(b, True)
        out, first, warm = timed(model.step_lanes, la, lb)
        got = from_lanes(out, True)
        gen = NTTCPU(p)
        rows, exp = self.oracle.apply(
            lambda u, v: gen.intt(gen.mult(gen.ntt(u), gen.ntt(v))), a, b)
        checks = {"oracle": np.array_equal(got[rows], exp),
                  "PolynomialMultiplier": np.array_equal(model(a, b), got),
                  "polymul": np.array_equal(polymul(a, b, model.plan), got)}
        self.report("he_polymul_u64", f"N=2^{logn} X^N+1 batch {batch}",
                    first, warm, self.oracle.name(True), checks)

    def _merge(self, phase: str, logn: int, batch: int, dtype, poly):
        import jax

        from gpuntt import (NTTCPU, MergePlan, NTTParameters, intt,
                           intt_lanes, ntt, ntt_lanes)
        from gpuntt.ops.merge_ntt import from_lanes, to_lanes

        is64 = np.dtype(dtype) == np.uint64
        p = NTTParameters(logn, poly, dtype=dtype)
        plan = MergePlan.from_params(p)
        x = self.rand(p.modulus.value, (batch, p.n), dtype)
        lx = to_lanes(x, is64)
        jf, ji = jax.jit(ntt_lanes), jax.jit(intt_lanes)
        fwd, first_f, warm_f = timed(jf, lx, plan)
        inv, first_i, warm_i = timed(ji, fwd, plan)
        spec = from_lanes(fwd, is64)
        gen = NTTCPU(p)
        rows, exp = self.oracle.apply(gen.ntt, x, is64=is64)
        _, exp_inv = self.oracle.apply(gen.intt, x, is64=is64)
        inv_x = from_lanes(ji(lx, plan), is64)
        checks = {"fwd_oracle": np.array_equal(spec[rows], exp),
                  "inv_oracle": np.array_equal(inv_x[rows], exp_inv),
                  "roundtrip": np.array_equal(from_lanes(inv, is64), x),
                  "ntt_api": np.array_equal(ntt(x, plan), spec),
                  "intt_api": np.array_equal(intt(spec, plan), x)}
        self.report(phase, f"2^{logn} x {batch} {np.dtype(dtype).name} "
                    f"{poly.name} fwd", first_f, warm_f,
                    self.oracle.name(is64), checks)
        self.report(phase, f"2^{logn} x {batch} {np.dtype(dtype).name} "
                    f"{poly.name} inv", first_i, warm_i,
                    self.oracle.name(is64), {"see fwd line": all(checks.values())})

    def merge_u64(self):
        from gpuntt import ReductionPolynomial

        self._merge("merge_u64", self.sizes["u64_logn"],
                    self.sizes["u64_batch"], np.uint64,
                    ReductionPolynomial.X_N_minus)

    def merge_u32(self):
        from gpuntt import ReductionPolynomial

        for logn, batch in self.sizes["u32_cells"]:
            self._merge("merge_u32", logn, batch, np.uint32,
                        ReductionPolynomial.X_N_plus)

    def rns_polymul_u64(self):
        import jax

        from gpuntt import (NTTCPU, Modulus64, NTTFactors, NTTParameters,
                           ReductionPolynomial, RNSMergePlan,
                           rns_pointwise_mult_lanes, rns_polymul)
        from gpuntt.arith.host import find_ntt_primes, ntt_root_pair
        from gpuntt.models.polymul import RNSPolynomialMultiplier
        from gpuntt.ops.merge_ntt import from_lanes, to_lanes
        from gpuntt.ops.rns import rns_intt_lanes, rns_ntt_lanes

        logn = self.sizes["rns_logn"]
        mc, stacks = self.sizes["rns_primes"], self.sizes["rns_stacks"]
        members = []
        for q in find_ntt_primes(59, logn, mc):
            om, psi = ntt_root_pair(q, logn)
            members.append(NTTParameters(
                logn, ReductionPolynomial.X_N_plus, dtype=np.uint64,
                factors=NTTFactors(Modulus64(q), om, psi)))
        plan = RNSMergePlan.from_params(members)
        n = 1 << logn
        batch = mc * stacks
        mod_idx = np.arange(batch) % mc
        a = np.stack([self.rand(members[m].modulus.value, n) for m in mod_idx])
        b = np.stack([self.rand(members[m].modulus.value, n) for m in mod_idx])

        def step(u, v, pl):
            fu = rns_ntt_lanes(u, pl, mod_idx)
            fv = rns_ntt_lanes(v, pl, mod_idx)
            return rns_intt_lanes(rns_pointwise_mult_lanes(fu, fv, pl, mod_idx),
                                  pl, mod_idx)

        out, first, warm = timed(jax.jit(step), to_lanes(a, True),
                                 to_lanes(b, True), plan)
        got = from_lanes(out, True)
        rows, exp = [], []
        for m, mem in enumerate(members):
            gen = NTTCPU(mem)
            sel = np.nonzero(mod_idx == m)[0]
            r, e = self.oracle.apply(
                lambda u, v: gen.intt(gen.mult(gen.ntt(u), gen.ntt(v))),
                a[sel], b[sel])
            rows.append(sel[r])
            exp.append(e)
        rows, exp = np.concatenate(rows), np.concatenate(exp)
        model = RNSPolynomialMultiplier(members)
        stacked = model(a.reshape(stacks, mc, n), b.reshape(stacks, mc, n))
        checks = {"oracle": np.array_equal(got[rows], exp),
                  "rns_polymul": np.array_equal(rns_polymul(a, b, plan), got),
                  "RNSPolynomialMultiplier": np.array_equal(
                      stacked.reshape(batch, n), got)}
        self.report("rns_polymul_u64", f"N=2^{logn} X^N+1, {mc} primes x "
                    f"{stacks} stacks = {batch} rows", first, warm,
                    self.oracle.name(True), checks)

    def fourstep_u64(self):
        import jax

        from gpuntt import (NTT4StepCPU, FourStepPlan, NTTParameters4Step,
                           ReductionPolynomial, fourstep_intt_full,
                           fourstep_ntt_full)
        from gpuntt.ops.merge_ntt import from_lanes, to_lanes

        logn, batch = self.sizes["fs_logn"], self.sizes["fs_batch"]
        p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus,
                               dtype=np.uint64)
        plan = FourStepPlan.from_params(p)
        x = self.rand(p.modulus.value, (batch, p.n))
        fwd, first_f, warm_f = timed(jax.jit(fourstep_ntt_full),
                                     to_lanes(x, True), plan)
        inv, first_i, warm_i = timed(jax.jit(fourstep_intt_full), fwd, plan)
        gen = NTT4StepCPU(p)
        rows, exp = self.oracle.apply(gen.ntt, x, per_row=True)
        spec = from_lanes(fwd, True)
        checks = {"fwd_oracle": np.array_equal(spec[rows], exp),
                  "roundtrip": np.array_equal(from_lanes(inv, True), x)}
        shape = f"2^{logn} = {p.n1} x {p.n2}, batch {batch}"
        self.report("fourstep_u64", shape + " fwd", first_f, warm_f,
                    self.oracle.name(True), checks)
        self.report("fourstep_u64", shape + " inv", first_i, warm_i,
                    self.oracle.name(True), {"see fwd line": all(checks.values())})

    def bigring_u64(self):
        from gpuntt import ReductionPolynomial

        self._merge("bigring_u64", self.sizes["big_logn"], 1, np.uint64,
                    ReductionPolynomial.X_N_plus)

    # --------------------------------------------------------- four cards

    def dist_fourstep(self):
        """Distributed 4-step on (dp, sp) = (1, 4) and (2, 2), each
        transform compared with the single-device 4-step on card 0."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from gpuntt import (NTT4StepCPU, FourStepPlan, NTTParameters4Step,
                           ReductionPolynomial, fourstep_intt_full,
                           fourstep_ntt_full, pointwise_mult_lanes)
        from gpuntt.models.polymul import DistPolynomialMultiplier
        from gpuntt.ops.merge_ntt import from_lanes, to_lanes
        from gpuntt.parallel.fourstep_dist import (DistFourStepPlan,
                                                   dist_fourstep_intt,
                                                   dist_fourstep_ntt)
        from gpuntt.parallel.mesh import make_mesh

        logn, batch = self.sizes["dist_logn"], self.sizes["dist_batch"]
        p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus,
                               dtype=np.uint64)
        q, n = p.modulus.value, p.n
        a, b = self.rand(q, (batch, n)), self.rand(q, (batch, n))
        dev0 = jax.devices()[0]
        plan0 = jax.device_put(FourStepPlan.from_params(p), dev0)
        la0 = jax.device_put(to_lanes(a, True), dev0)
        lb0 = jax.device_put(to_lanes(b, True), dev0)
        fwd1 = jax.jit(fourstep_ntt_full)
        inv1 = jax.jit(fourstep_intt_full)
        ref_spec, ref_first, ref_warm = timed(fwd1, la0, plan0)
        ref_back = from_lanes(inv1(ref_spec, plan0), True)
        ref_pm = from_lanes(inv1(pointwise_mult_lanes(
            ref_spec, fwd1(lb0, plan0), plan0), plan0), True)
        ref_spec = from_lanes(ref_spec, True)
        gen = NTT4StepCPU(p)
        oracle_ok = np.array_equal(ref_spec[0], gen.ntt(a[0]))
        self.report("fourstep_card0", f"2^{logn} = {p.n1} x {p.n2}, batch "
                    f"{batch}, {dev0}", ref_first, ref_warm,
                    self.oracle.name(True) + ", row 0",
                    {"fwd_oracle": oracle_ok,
                     "roundtrip": np.array_equal(ref_back, a)})
        dplan = DistFourStepPlan.from_params(p)
        for dp, sp in ((1, 4), (2, 2)):
            mesh = make_mesh(dp=dp, sp=sp)
            sh = NamedSharding(mesh, P("dp", None, "sp"))
            put = lambda v: jax.device_put(
                to_lanes(v.reshape(batch, p.n1, p.n2), True), sh)
            la, lb = put(a), put(b)
            fwd = jax.jit(lambda v, d: dist_fourstep_ntt(v, d, mesh))
            inv = jax.jit(lambda v, d: dist_fourstep_intt(v, d, mesh))
            spec, first_f, warm_f = timed(fwd, la, dplan)
            back, first_i, warm_i = timed(inv, spec, dplan)
            model = DistPolynomialMultiplier(p, mesh)
            # step_lanes is itself jitted with the plan as an argument;
            # an outer jit would capture the plan's tables as constants
            pm, first_p, warm_p = timed(model.step_lanes, la, lb)
            devices = sorted({str(s.device) for s in spec.hi.addressable_shards})
            for s in spec.hi.addressable_shards:
                print(f"  mesh {dp}x{sp} spectrum shard {s.index} on {s.device}")
            checks = {
                "fwd_vs_card0": np.array_equal(
                    from_lanes(spec, True).reshape(batch, n), ref_spec),
                "inv_vs_card0": np.array_equal(
                    from_lanes(back, True).reshape(batch, n), ref_back),
                "polymul_vs_card0": np.array_equal(
                    from_lanes(pm, True).reshape(batch, n), ref_pm),
                "four_devices": len(devices) == 4}
            tag = f"2^{logn}, batch {batch}, mesh dp={dp} x sp={sp}"
            self.report("dist_fourstep", tag + " fwd", first_f, warm_f,
                        "single-device 4-step on card 0", checks)
            self.report("dist_fourstep", tag + " inv", first_i, warm_i,
                        "single-device 4-step on card 0",
                        {"see fwd line": all(checks.values())})
            self.report("dist_polymul", tag + " step_lanes", first_p, warm_p,
                        "single-device 4-step on card 0",
                        {"see fwd line": all(checks.values())})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; never prints the result line")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed 4-step on four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.rehearse:
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_device_count=4")
        import jax

        jax.config.update("jax_platforms", "cpu")
        print("REHEARSAL on the CPU at tiny sizes: no device numbers, "
              "no result line", flush=True)
    else:
        lines = card_lines()   # raises when nvidia-smi is missing
        print("card (name, power.limit):", flush=True)
        for ln in lines:
            print(ln, flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from gpuntt.utils.cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    devs = jax.devices()
    print(f"jax {jax.__version__} devices: {devs}", flush=True)
    want = "cpu" if args.rehearse else "gpu"
    if devs[0].platform != want:
        print(f"FAIL: JAX runs on {devs[0].platform}, not {want}", flush=True)
        return 1
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"FAIL: {need} devices needed, JAX sees {len(devs)}", flush=True)
        return 1

    smoke = Smoke(REHEARSE if args.rehearse else FULL, seed=args.seed)
    print(f"oracle: {'native C++ core' if smoke.oracle.native else 'numpy models'}",
          flush=True)
    if args.four_cards:
        phases = [smoke.dist_fourstep]
    else:
        phases = [smoke.he_polymul_u64, smoke.merge_u64, smoke.merge_u32,
                  smoke.rns_polymul_u64, smoke.fourstep_u64,
                  smoke.bigring_u64]
    t0 = time.perf_counter()
    for ph in phases:
        smoke.run(ph.__name__, ph)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failures:
        print(f"FAILED phases: {sorted(set(smoke.failures))}", flush=True)
        return 1
    if args.rehearse:
        print("rehearsal passed", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
