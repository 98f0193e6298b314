"""The example scripts (reference binary parity) stay runnable.

Each script must print `All Correct.` and exit 0 — the reference's own
pass criterion (check_result, common.cu:24-42).  Run at small sizes in
subprocesses (fresh backend, CPU).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _run(script, *args, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTEST_CURRENT_TEST", None)
    if env_extra:
        env.update(env_extra)
    # Pin the subprocess to the CPU through jax.config as well as the
    # env var, before the script runs: on a machine with a GPU the
    # tests must not take the card from another process.
    boot = (
        "import sys, runpy, jax;"
        "jax.config.update('jax_platforms', 'cpu');"
        "sys.argv = sys.argv[1:];"
        "runpy.run_path(sys.argv[0], run_name='__main__')"
    )
    r = subprocess.run(
        [sys.executable, "-c", boot,
         os.path.join(REPO, "examples", script), *args],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "All Correct." in r.stdout, r.stdout + r.stderr


@pytest.mark.parametrize("script,args", [
    ("example_cpu_merge_ntt.py", ("9", "1")),
    ("example_cpu_4step_ntt.py", ("12", "1")),
    ("example_merge_ntt.py", ("9", "2")),
    ("example_merge_intt.py", ("9", "2")),
    ("example_4step_ntt.py", ("12", "2")),
    ("example_4step_intt.py", ("12", "2")),
    ("example_rns_ntt.py", ("12", "4")),
    ("example_rns_polymul.py", ("8", "2")),
])
def test_example_script(script, args):
    _run(script, *args)


def test_distributed_example():
    _run("example_distributed_polymul.py", "12", "2",
         env_extra={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
