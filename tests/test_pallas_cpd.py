"""Triton-route Pallas CPD E-step vs the jnp oracle (interpret mode on
the CPU; ``tests/test_chip.py`` checks the compiled kernel on the GPU)."""

import numpy as np

from tpuslam.config.configuration import ApproximationType
import pytest

import jax.numpy as jnp

from tpuslam.algorithms.cpd import (
    cpd_estep,
    sigma_squared_init,
    uniform_constant,
)
from tpuslam.core.types import pad_cloud
from tpuslam.kernels.pallas_cpd import (
    cpd_estep_pallas,
)


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("nm", [(96, 80), (300, 257), (512, 512)])
def test_matches_jnp_estep(rng, nm, truncate):
    n_moving, n_target = nm
    before = (rng.random((n_moving, 3)) * 4.0 - 2.0).astype(np.float32)
    after = (before[:n_target] + 0.25).astype(np.float32)
    cb, ca = pad_cloud(before), pad_cloud(after)
    s2 = sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask())
    c = uniform_constant(
        s2, jnp.float32(0.3), jnp.float32(n_moving), jnp.float32(n_target)
    )
    args = (cb.points, cb.mask(), ca.points, ca.mask(), s2, c,
            jnp.asarray(truncate))
    want = cpd_estep(*args)
    got = cpd_estep_pallas(*args, interpret=True)
    np.testing.assert_allclose(
        np.asarray(got.p1), np.asarray(want.p1), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.pt1), np.asarray(want.pt1), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.px), np.asarray(want.px), rtol=1e-4, atol=1e-5
    )
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-4)
    # padded rows carry no statistics
    assert np.all(np.asarray(got.p1)[n_moving:] == 0)
    assert np.all(np.asarray(got.pt1)[n_target:] == 0)


def test_internal_padding_multi_tile(rng):
    # shapes that are not block multiples once the counts cut them: the
    # kernel's internal padding must carry no statistics
    n_moving, n_target = 1152, 1280
    before = (rng.random((n_moving, 3)) * 4.0).astype(np.float32)
    after = (rng.random((n_target, 3)) * 4.0).astype(np.float32)
    cb = pad_cloud(before[:1100], multiple=128)
    ca = pad_cloud(after[:1250], multiple=128)
    s2 = sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask())
    c = uniform_constant(
        s2, jnp.float32(0.3), jnp.float32(1100), jnp.float32(1250)
    )
    args = (cb.points, cb.mask(), ca.points, ca.mask(), s2, c,
            jnp.asarray(False))
    want = cpd_estep(*args)
    got = cpd_estep_pallas(*args, interpret=True)
    assert got.p1.shape == want.p1.shape
    np.testing.assert_allclose(
        np.asarray(got.p1), np.asarray(want.p1), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.pt1), np.asarray(want.pt1), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.px), np.asarray(want.px), rtol=1e-4, atol=1e-5
    )


def test_hybrid_kernel_arm_trajectory(rng, interpret_kernels):
    """A full Hybrid+FGT registration on the kernel arm lands in the same
    optimum as the jnp reference arm (the two differ only by summation
    order)."""
    from tests.conftest import random_rigid
    from tpuslam.algorithms.cpd import cpd_register
    from tpuslam.core.types import pad_cloud

    before = (rng.random((700, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.4)
    after = (before @ r.T + t)[rng.permutation(700)].astype(np.float32)
    kw = dict(weight=0.1, max_iterations=40, tolerance=1e-6,
              approximation_type=ApproximationType.Hybrid, use_fgt=True)
    ref = cpd_register(pad_cloud(before), pad_cloud(after),
                       use_pallas=False, **kw)
    got = cpd_register(pad_cloud(before), pad_cloud(after),
                       use_pallas=True, **kw)
    np.testing.assert_allclose(
        np.asarray(got.transform.rotation),
        np.asarray(ref.transform.rotation), atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(got.transform.translation),
        np.asarray(ref.transform.translation), atol=2e-3)


def _estep_case(rng, m, n, count_m, count_n, s2_factor, trunc):
    mov = (rng.random((m, 3)) * 4.0 - 2.0).astype(np.float32)
    tgt = (rng.random((n, 3)) * 4.0 - 2.0).astype(np.float32)
    mm = (np.arange(m) < count_m).astype(np.float32)
    tm = (np.arange(n) < count_n).astype(np.float32)
    s2 = sigma_squared_init(
        jnp.asarray(mov), jnp.asarray(mm), jnp.asarray(tgt), jnp.asarray(tm)
    )
    s2 = jnp.where(jnp.isfinite(s2), s2, 1.0) * s2_factor
    c = uniform_constant(
        s2, jnp.float32(0.3), jnp.float32(max(count_m, 1)),
        jnp.float32(max(count_n, 1)),
    )
    return (jnp.asarray(mov), jnp.asarray(mm), jnp.asarray(tgt),
            jnp.asarray(tm), s2, c, jnp.asarray(trunc))


def _assert_stats_close(got, want, rtol=1e-4):
    # rtol against each statistic's largest magnitude: entries far below
    # it (Gaussian tails) carry no relative precision in either form
    for f in ("p1", "pt1", "px"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        scale = max(float(np.max(np.abs(b))), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f)
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-5)


@pytest.mark.parametrize("count_m,count_n", [
    (0, 200), (1, 200), (200, 1), (137, 200), (200, 200),
])
def test_estep_counts_and_padding(rng, count_m, count_n):
    """Empty, single-row and partial masks: masked rows carry nothing,
    and the kernel agrees with the oracle on the rest."""
    args = _estep_case(rng, 200, 200, count_m, count_n, 1.0, False)
    got = cpd_estep_pallas(*args, interpret=True)
    want = cpd_estep(*args)
    assert got.p1.shape == (200,) and got.px.shape == (200, 3)
    assert got.pt1.shape == (200,)
    assert np.all(np.asarray(got.p1)[count_m:] == 0)
    assert np.all(np.asarray(got.pt1)[count_n:] == 0)
    assert np.all(np.isfinite(np.asarray(got.px)))
    _assert_stats_close(got, want)


@pytest.mark.parametrize("s2_factor,trunc", [
    (1.0, False), (1.0, True), (0.01, True), (0.002, True), (0.002, False),
])
def test_estep_tight_sigma_and_truncation(rng, s2_factor, trunc):
    """Tight sigma^2 (the Hybrid slow phase) with truncation on and off:
    both forms are per-coordinate, so they agree to f32 rounding."""
    args = _estep_case(rng, 300, 260, 300, 260, s2_factor, trunc)
    _assert_stats_close(cpd_estep_pallas(*args, interpret=True),
                        cpd_estep(*args))


def test_estep_truncation_drops_terms(rng):
    """Truncation can only remove mass: with it on, every denominator
    term that survives is unchanged and p1 never grows."""
    args = list(_estep_case(rng, 256, 256, 256, 256, 0.01, False))
    off = cpd_estep_pallas(*args, interpret=True)
    args[-1] = jnp.asarray(True)
    on = cpd_estep_pallas(*args, interpret=True)
    assert np.all(np.asarray(on.pt1) <= np.asarray(off.pt1) + 1e-6)
    assert float(on.error) >= float(off.error) - 1e-3
