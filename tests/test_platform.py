"""Platform policy: compile-cache placement, the factor dtype chosen on the
GPU, no Pallas anywhere, and the chip entry points refusing to run
without a GPU."""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.interface import resolve_factor_dtype
from pips_ipmpp_tpu.ipm import solver as solver_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_gpu(monkeypatch):
    """jax.devices() reports a GPU; jax.config.update calls are recorded
    instead of applied.  Returns the list of recorded updates."""
    monkeypatch.setattr(jax, "devices", lambda *a: [SimpleNamespace(
        platform="gpu", device_kind="NVIDIA H100 80GB HBM3")])
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.append((name, val)))
    return updates


def test_compile_cache_honours_env_var(fake_gpu, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert solver_mod.enable_compilation_cache() == str(tmp_path)
    assert fake_gpu == []        # JAX reads the variable; nothing else set


def test_compile_cache_default_is_repo_dir(fake_gpu, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert solver_mod.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert solver_mod.enable_compilation_cache() == solver_mod.REPO_CACHE_DIR
    assert fake_gpu == [("jax_compilation_cache_dir",
                         solver_mod.REPO_CACHE_DIR)]


def test_compile_cache_off_on_cpu(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.append((name, val)))
    assert solver_mod.enable_compilation_cache() is None
    assert updates == []


@pytest.mark.parametrize("setting,expected", [
    ("auto", jnp.float64), ("float32", jnp.float32),
    ("float64", jnp.float64)])
def test_resolve_factor_dtype_on_gpu(fake_gpu, setting, expected):
    assert resolve_factor_dtype(Options(factor_dtype=setting)) is expected


def _run(args, cwd=REPO, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_fails_without_gpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository the script has nothing to run."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_fails_without_gpu():
    r = _run(["bench.py"])
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_no_module_imports_pallas():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pips_ipmpp_tpu as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('libpips_native'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if 'pallas' in m.split('.')]\n"
        "assert not bad, bad\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
