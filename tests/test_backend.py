"""Where the program runs (qgcm_tpu/backend.py) and the scripts that
must refuse to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from qgcm_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path,
                                    restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache,
    whatever the program had configured."""
    target = tmp_path / "from_env"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    jax.config.update("jax_compilation_cache_dir", None)
    assert backend.enable_compile_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_dir):
    """Without the variable the cache is the fixed <checkout>/.jax_cache,
    the same path in every process."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    want = os.path.join(REPO, ".jax_cache")
    assert backend.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert backend.enable_compile_cache() == want


def test_prepare_leaves_platform_unpinned(monkeypatch, tmp_path):
    """`qgcm prepare` builds its float64 IC/forcing on the CPU device
    inside a default_device scope; it must not pin the whole process to
    the CPU (a later run in the same process would land there)."""
    from qgcm_tpu.cli import main
    real_update = jax.config.update

    def update(name, value):
        assert name != "jax_platforms", "prepare pinned jax_platforms"
        return real_update(name, value)

    monkeypatch.setattr(jax.config, "update", update)
    case = tmp_path / "case"
    flags = ["--nxta", "24", "--nyta", "24", "--nxaooc", "24",
             "--nyaooc", "12", "--ndxr", "2", "--fnot", "5.92e-5",
             "--beta", "2.08e-11", "--ocean-only", "--cyclic-ocean"]
    assert main(["prepare", str(case), "--eddy-amp", "0.15",
                 "--forcing", "zero"] + flags) in (0, None)
    assert (case / "restart.nc").exists() and (case / "avges.nc").exists()


@pytest.mark.parametrize("script,alone", [
    ("chip_smoke.py", False),
    ("chip_smoke.py", True),
    ("bench.py", False),
])
def test_gpu_scripts_refuse_the_cpu(script, alone, tmp_path):
    """chip_smoke.py and bench.py fail, and print no result, when JAX
    finds no GPU -- and chip_smoke.py also when it stands alone in a
    directory without the package."""
    src = os.path.join(REPO, script)
    if alone:
        shutil.copy(src, tmp_path / script)
        src = str(tmp_path / script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, src], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0, proc.stdout
    assert '"ok": true' not in proc.stdout
    assert not any(ch.isdigit() for ch in proc.stdout), proc.stdout


@pytest.fixture
def gpu_env():
    """Environment for a child process on the GPU; skips unless JAX,
    left to choose its own platform, finds one. (This process stays
    on the CPU: tests/conftest.py pins it there.)"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return env


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_env):
    """Every chip_smoke.py phase passes on the card and the last line
    is the result object."""
    import json
    proc = subprocess.run([sys.executable,
                           os.path.join(REPO, "chip_smoke.py")],
                          env=gpu_env, capture_output=True, text=True,
                          timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
