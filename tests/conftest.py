"""Test configuration: CPU jax with a virtual 8-device mesh, so the
sharded paths are exercised without several cards (SURVEY §4).

Tests that need the GPU carry the ``chip`` marker (registered in
``pyproject.toml``) and skip here; ``python chip_smoke.py`` runs them on
the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from tpuslam.core.device import configure_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
assert jax.default_backend() == "cpu"

import functools  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_DATA = "/root/reference/data"


@pytest.fixture
def rng():
    return np.random.Generator(np.random.PCG64(666))


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the Triton kernels in Pallas interpret mode for this test, so
    ``use_pallas=True`` call paths (which compile only for the GPU) run
    on the CPU."""
    from tpuslam.kernels import pallas_cpd, pallas_nn

    monkeypatch.setattr(
        pallas_nn, "nearest_neighbors_pallas",
        functools.partial(pallas_nn.nearest_neighbors_pallas, interpret=True),
    )
    monkeypatch.setattr(
        pallas_cpd, "cpd_estep_pallas",
        functools.partial(pallas_cpd.cpd_estep_pallas, interpret=True),
    )


@pytest.fixture
def gpu_selection(monkeypatch, interpret_kernels):
    """Make the platform-keyed selection pick the kernels, as it does on
    the GPU, with the kernels in interpret mode: the default call paths
    run end to end on the CPU.  Jit caches are cleared on both sides so
    no trace taken under the patch outlives the test."""
    from tpuslam.core import device

    monkeypatch.setattr(device, "use_kernels", lambda platform=None: True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def make_cloud(rng: np.random.Generator, n: int, spread: float = 10.0):
    return (rng.random((n, 3), dtype=np.float64) * spread).astype(np.float32)


def random_rigid(rng: np.random.Generator, angle: float = 0.2, trans: float = 1.0):
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    r = get_random_rotation_matrix(rng, angle)
    t = get_random_translation_vector(rng, trans)
    return r, t
