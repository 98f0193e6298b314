"""Device mesh helpers.

No reference counterpart: GPU-NTT is single-device (SURVEY.md §2,
"Parallelism strategies" note).  This framework scales over a
jax.sharding.Mesh — by convention axis "dp" shards the batch
(independent polynomials) and axis "sp" shards the coefficient axis of
one transform (the 4-step n1/n2 seam, resharded by all_to_all).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int = 1, sp: int | None = None, devices=None) -> Mesh:
    """Build a (dp, sp) mesh.  sp defaults to all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    if sp is None:
        sp = len(devices) // dp
    if dp * sp > len(devices):
        raise ValueError(f"mesh {dp}x{sp} needs {dp*sp} devices, have {len(devices)}")
    arr = np.array(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(batch, ...) arrays: batch over dp, replicated over sp."""
    return NamedSharding(mesh, P("dp"))


def matrix_sharding(mesh: Mesh, axis: int, ndim: int = 3) -> NamedSharding:
    """(batch, n1, n2)-style arrays: batch over dp, `axis` over sp."""
    spec = [None] * ndim
    spec[0] = "dp"
    spec[axis] = "sp"
    return NamedSharding(mesh, P(*spec))
