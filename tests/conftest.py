"""Test configuration: JAX on a virtual 8-device CPU mesh.

Sharding correctness is validated on
`--xla_force_host_platform_device_count=8` CPU devices, which exercises
the same jit/shard_map/collective paths as a multi-GPU host (the
reference had no distributed tests at all — SURVEY.md §4).

Tests marked `gpu` need an NVIDIA GPU.  They skip here; on a machine
with a card run them with

    GPUNTT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/

which leaves JAX on its default backend.  Whether a card is present is
decided inside the `gpu_device` fixture, never at import or collection.
"""

import os

if os.environ.get("GPUNTT_TEST_PLATFORM") != "gpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # The config update covers a pytest plugin that imported jax before
    # this conftest ran (backends initialise lazily).
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev
