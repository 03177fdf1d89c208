"""Triton-route Pallas NN kernel vs the jnp reference oracle (interpret
mode on the CPU; the same kernel compiles for the GPU, where
``tests/test_chip.py`` checks it at full size)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpuslam.core.types import pad_cloud
from tpuslam.kernels.pallas_nn import nearest_neighbors_pallas
from tpuslam.ops.nn import nearest_neighbors_ref


@pytest.mark.parametrize("n,m,count", [
    (128, 128, 100),
    (256, 512, 500),
    (512, 1024, 1024),
    (384, 640, 601),
])
def test_matches_reference(rng, n, m, count):
    src = (rng.random((n, 3)) * 10).astype(np.float32)
    tgt_full = (rng.random((m, 3)) * 10).astype(np.float32)
    tgt = pad_cloud(tgt_full[:count], multiple=m)  # pad back to m rows
    assert tgt.points.shape[0] == m

    idx_p, dist_p = nearest_neighbors_pallas(
        jnp.asarray(src), tgt.points, tgt.count, interpret=True
    )
    idx_r, dist_r = nearest_neighbors_ref(
        jnp.asarray(src), tgt.points, tgt.count
    )
    np.testing.assert_array_equal(np.asarray(idx_p), np.asarray(idx_r))
    np.testing.assert_allclose(
        np.asarray(dist_p), np.asarray(dist_r), rtol=1e-5, atol=1e-5
    )


def test_tie_breaking_first_index_wins(rng):
    # duplicate target points: the LOWEST index must win (common.cpp:416)
    src = np.zeros((128, 3), dtype=np.float32)
    tgt = np.ones((256, 3), dtype=np.float32)
    tgt[7] = 0.0  # first zero point
    tgt[200] = 0.0  # duplicate later — must not win
    cloud = pad_cloud(tgt, multiple=256)
    idx, dist = nearest_neighbors_pallas(
        jnp.asarray(src), cloud.points, cloud.count, interpret=True
    )
    assert np.all(np.asarray(idx) == 7)
    np.testing.assert_allclose(np.asarray(dist), 0.0, atol=1e-6)


def test_all_targets_invalid(rng):
    src = (rng.random((128, 3))).astype(np.float32)
    cloud = pad_cloud(np.zeros((1, 3), np.float32), multiple=128)
    cloud = cloud._replace(count=jnp.int32(0))
    idx, dist = nearest_neighbors_pallas(
        jnp.asarray(src), cloud.points, cloud.count, interpret=True
    )
    assert np.all(np.asarray(dist) > 1e37)


def test_internal_padding_multi_tile(rng):
    # 1152 rows is not a multiple of the kernel's blocks once count cuts
    # it to 1100: the tail block is partly internal padding, and the
    # count mask must keep padded rows from ever winning
    n, m, count = 1152, 1152, 1100
    src = (rng.random((n, 3)) * 10).astype(np.float32)
    tgt_full = (rng.random((m, 3)) * 10).astype(np.float32)
    tgt = pad_cloud(tgt_full[:count], multiple=128)
    assert tgt.points.shape[0] == 1152  # lane-aligned, NOT tile-aligned
    idx_p, dist_p = nearest_neighbors_pallas(
        jnp.asarray(src), tgt.points, tgt.count, interpret=True
    )
    idx_r, dist_r = nearest_neighbors_ref(
        jnp.asarray(src), tgt.points, tgt.count
    )
    assert idx_p.shape == (n,)
    np.testing.assert_array_equal(np.asarray(idx_p), np.asarray(idx_r))
    np.testing.assert_allclose(
        np.asarray(dist_p), np.asarray(dist_r), rtol=1e-5, atol=1e-5
    )


def test_no_valid_target_returns_exact_big(rng):
    """Cross-backend no-match contract: with zero valid targets the
    distance must be EXACTLY the oracle's BIG for any source coords
    (the sentinel arithmetic is input-dependent without the remap)."""
    from tpuslam.ops.nn import BIG as REF_BIG

    for shift in (0.0, -1e20):  # the large-negative case saturates to inf
        src = (rng.random((128, 3)).astype(np.float32) + np.float32(shift))
        cloud = pad_cloud(np.zeros((1, 3), np.float32), multiple=128)
        cloud = cloud._replace(count=jnp.int32(0))
        _, dist = nearest_neighbors_pallas(
            jnp.asarray(src), cloud.points, cloud.count, interpret=True
        )
        np.testing.assert_array_equal(
            np.asarray(dist), np.full(128, np.float32(REF_BIG))
        )
