"""Tests that need the GPU: they skip on the CPU and run on the card
through ``python chip_smoke.py`` (its ``chip_tests`` phase).

Self-contained (no conftest fixtures): ``chip_smoke.py`` runs this file
in its own, already-initialized GPU process with ``--noconftest``.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; run by python chip_smoke.py")


def _pair(n, seed, angle=0.1, trans=0.5):
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    rng = np.random.default_rng(seed)
    before = (rng.random((n, 3), dtype=np.float64) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, angle).astype(np.float32)
    t = get_random_translation_vector(rng, trans).astype(np.float32)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
    return before, after


def test_results_do_not_move_under_highest_precision(gpu):
    """Every f32 contraction on the main path pins its precision, so
    forcing ``highest`` as the default matmul precision must not move
    the ICP or CPD results (an unpinned product would run in TF32)."""
    import jax

    import tpuslam
    from tpuslam import ApproximationType, ComputationMethod

    icp_pair = _pair(102_400, 1)
    cpd_pair = _pair(20_480, 2, angle=0.2, trans=1.0)
    cpd_kw = dict(computation_method=ComputationMethod.Cpd, cpd_weight=0.1,
                  max_iterations=15,
                  approximation_type=ApproximationType.Hybrid)

    def run():
        icp = tpuslam.register(*icp_pair, max_iterations=50,
                               convergence_epsilon=1e-5)
        cpd = tpuslam.register(*cpd_pair, **cpd_kw)
        return icp, cpd

    base = run()
    with jax.default_matmul_precision("highest"):
        high = run()
    for got, want in zip(high, base):
        assert got[2] == want[2]  # iterations
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)


def test_vmapped_kernels_match_reference(gpu):
    """The kernels batched by ``jax.vmap`` (the vmapped batch lowering)
    compile for the card and agree with the vmapped jnp references."""
    import jax
    import jax.numpy as jnp

    from tpuslam.algorithms.cpd import cpd_estep
    from tpuslam.kernels.pallas_cpd import cpd_estep_pallas
    from tpuslam.kernels.pallas_nn import nearest_neighbors_pallas
    from tpuslam.ops.nn import nearest_neighbors_ref

    rng = np.random.default_rng(3)
    b, n = 16, 2048
    src = jnp.asarray(rng.random((b, n, 3), dtype=np.float32) * 10)
    tgt = jnp.asarray(rng.random((b, n, 3), dtype=np.float32) * 10)
    cnt = jnp.asarray(rng.integers(1, n + 1, size=b), jnp.int32)
    ik, dk = jax.vmap(nearest_neighbors_pallas)(src, tgt, cnt)
    ir, dr = jax.vmap(nearest_neighbors_ref)(src, tgt, cnt)
    np.testing.assert_array_equal(np.asarray(dk), np.asarray(dr))
    np.testing.assert_array_equal(np.asarray(ik), np.asarray(ir))

    mask = jnp.ones((b, n), jnp.float32)
    s2 = jnp.full((b,), 4.0, jnp.float32)
    c = jnp.full((b,), 0.5, jnp.float32)
    tr = jnp.zeros((b,), bool)
    got = jax.vmap(cpd_estep_pallas)(src, mask, tgt, mask, s2, c, tr)
    want = jax.vmap(cpd_estep)(src, mask, tgt, mask, s2, c, tr)
    for f in ("p1", "pt1", "px"):
        a, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        np.testing.assert_allclose(a, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
