"""The platform-keyed kernel selection, the compile-cache location, and
``chip_smoke.py``'s refusal to run without the GPU."""

import json
import os
import subprocess
import sys

import pytest

from tests.conftest import REPO_ROOT


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_use_kernels_by_platform(platform, want):
    from tpuslam.core.device import use_kernels

    assert use_kernels(platform) is want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_use_kernels_rejects_other_platforms(platform):
    """No silent fallback: a platform with no kernel selection is an
    error, not the reference path."""
    from tpuslam.core.device import use_kernels

    with pytest.raises(RuntimeError, match="no kernel selection"):
        use_kernels(platform)


@pytest.mark.parametrize("use_pallas,platform,want", [
    (None, "gpu", "kernel"),
    (None, "cpu", "reference"),
    (True, "cpu", "kernel"),
    (False, "gpu", "reference"),
])
def test_select(use_pallas, platform, want):
    from tpuslam.core.device import select

    got = select("kernel", "reference", use_pallas, platform)
    assert got == want


def test_default_backend_here_selects_reference():
    from tpuslam.core.device import use_kernels

    assert use_kernels() is False


@pytest.mark.parametrize("front", ["nn", "estep"])
def test_fronts_pick_by_selection(front, monkeypatch):
    """The dispatching fronts call whatever ``select`` returns: the
    kernel when the platform asks for it."""
    import numpy as np

    import jax.numpy as jnp

    from tpuslam.core import device
    from tpuslam.kernels import pallas_cpd, pallas_nn

    calls = []

    def spy(name):
        def fn(*a, **k):
            calls.append(name)
            return name
        return fn

    monkeypatch.setattr(device, "use_kernels", lambda platform=None: True)
    monkeypatch.setattr(pallas_nn, "nearest_neighbors_pallas", spy("nn"))
    monkeypatch.setattr(pallas_cpd, "cpd_estep_pallas", spy("estep"))
    x = jnp.zeros((4, 3), jnp.float32)
    if front == "nn":
        from tpuslam.ops.nn import nearest_neighbors

        assert nearest_neighbors(x, x, jnp.int32(4)) == "nn"
    else:
        from tpuslam.algorithms.cpd import cpd_estep_auto

        m = jnp.ones((4,), jnp.float32)
        out = cpd_estep_auto(x, m, x, m, np.float32(1.0), np.float32(0.1),
                             jnp.asarray(False))
        assert out == "estep"
    assert calls == [front]


def test_library_derives_no_interpret_flag_from_the_backend():
    """``interpret=`` is a test-only argument: no library module derives
    it from the platform."""
    pkg = os.path.join(REPO_ROOT, "tpuslam")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if "interpret=" in line and "interpret=interpret" \
                                not in line:
                            offenders.append(f"{path}:{i}")
    assert offenders == []


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    from tpuslam.core.device import compile_cache_dir

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache_dir() == os.path.join(REPO_ROOT, ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compile_cache_dir() == want


@pytest.mark.parametrize("env", [None, "set"])
def test_compile_cache_lands_there(env, tmp_path):
    """A fresh process compiles one function; its cache entry appears in
    ``JAX_COMPILATION_CACHE_DIR`` when set, else in the checkout's
    ``.jax_cache``."""
    cache = tmp_path / "cache" if env else None
    child_env = dict(os.environ, JAX_PLATFORMS="cpu")
    child_env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if cache is not None:
        child_env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    code = (
        "import jax, jax.numpy as jnp\n"
        "from tpuslam.core.device import configure_compile_cache\n"
        "print(configure_compile_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "jax.jit(lambda x: x * 3.25 + 1.5)(jnp.arange(7.0)).block_until_ready()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=child_env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    path = out.stdout.strip().splitlines()[-1]
    want = str(cache) if cache is not None else os.path.join(
        REPO_ROOT, ".jax_cache")
    assert path == want
    assert os.path.isdir(path) and os.listdir(path)


def test_chip_smoke_refuses_cpu():
    """Without the GPU, chip_smoke.py exits non-zero and its last line
    reports ``"ok": false``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert "gpu" in last["error"]


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository, the script fails and prints no result line."""
    import shutil

    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
