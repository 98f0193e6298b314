"""The device-facing scripts and their set-up, exercised on the CPU.

- every chip_smoke.py phase at its rehearsal sizes (the same public
  entry points and oracle comparisons the GPU run makes);
- chip_smoke.py and bench.py refuse to report without a GPU, and
  chip_smoke.py fails when it stands alone, without the package;
- the compile-cache helper honours JAX_COMPILATION_CACHE_DIR and
  otherwise uses the fixed directory in the checkout.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PHASES = ["he_polymul_u64", "merge_u64", "merge_u32", "rns_polymul_u64",
          "fourstep_u64", "bigring_u64", "dist_fourstep"]


@pytest.mark.parametrize("phase", PHASES)
def test_smoke_phase_rehearsal(phase, capsys):
    smoke = chip_smoke.Smoke(chip_smoke.REHEARSE)
    getattr(smoke, phase)()
    out = capsys.readouterr().out
    assert smoke.failures == [], out
    assert "PASS" in out and "FAIL" not in out


def _run(args, cwd, **env_extra):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env_extra}
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _reported(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and '"ok": true' in lines[-1]


def test_smoke_without_gpu_fails_without_result():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert not _reported(r.stdout)


def test_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the run fails (the package is missing), even as a rehearsal."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py", "--rehearse"], str(tmp_path))
    assert r.returncode != 0
    assert "gpuntt" in r.stderr
    assert not _reported(r.stdout)


def test_bench_without_gpu_fails_without_result():
    r = _run(["bench.py"], REPO)
    assert r.returncode != 0
    assert "NTTs/sec" not in r.stdout


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; the helper
    sets nothing and reports that directory."""
    import jax

    from gpuntt.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset: the fixed, gitignored `.jax_cache/` at the checkout root."""
    import jax

    from gpuntt.utils import cache

    monkeypatch.delenv(cache.CACHE_ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(os.path.realpath(REPO), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.gpu
def test_smoke_full_width_on_gpu(gpu_device):
    """The u64 merge and HE polymul phases at full width on the card."""
    smoke = chip_smoke.Smoke(chip_smoke.FULL)
    smoke.merge_u64()
    smoke.he_polymul_u64()
    assert smoke.failures == []
