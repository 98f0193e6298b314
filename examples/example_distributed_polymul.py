"""Multi-device polynomial multiplication over the sharded 4-step NTT.

No reference counterpart: GPU-NTT is single-device (SURVEY.md §2,
"parallelism strategies").  Here the N = n1 x n2 decomposition shards
the n2 axis over mesh axis "sp" (column NTTs local, one all_to_all
as the distributed transpose, row NTTs local) while the batch rides
"dp" — and the result stays bit-exact vs the single-device golden.

Runs anywhere via a virtual device mesh:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/example_distributed_polymul.py [LOG2_RING] [BATCH]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _platform  # noqa: E402

_platform.apply()

import numpy as np


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    import jax

    # honour a JAX_PLATFORMS=cpu request through the config too: the
    # update must land before backend init
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpuntt import NTT4StepCPU, NTTParameters4Step, ReductionPolynomial, check_result
    from gpuntt.models.polymul import DistPolynomialMultiplier
    from gpuntt.ops.merge_ntt import from_lanes, to_lanes
    from gpuntt.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    dp = 2 if (n_dev % 2 == 0 and n_dev > 1) else 1
    sp = n_dev // dp
    mesh = make_mesh(dp=dp, sp=sp)
    print(f"mesh: dp={dp} x sp={sp} on {jax.devices()[0].platform}")

    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    model = DistPolynomialMultiplier(p, mesh)
    q = p.modulus.value
    rng = np.random.default_rng(0)
    a = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    b = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)

    sh = NamedSharding(mesh, P("dp", None, "sp"))
    put = lambda x: jax.tree_util.tree_map(
        lambda v: jax.device_put(v, sh),
        to_lanes(x.reshape(batch, p.n1, p.n2), True),
    )
    out = jax.jit(model.step_lanes)(put(a), put(b))
    got = from_lanes(out, True).reshape(batch, p.n)

    gen = NTT4StepCPU(p)
    exp = np.stack(
        [gen.intt(gen.mult(gen.ntt(a[i]), gen.ntt(b[i]))) for i in range(batch)]
    )
    ok = check_result(got, exp)
    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
