"""NN correspondence search vs brute-force NumPy oracle
(``common.cpp:399-515``: first-index tie-break, strict ``<``)."""

import numpy as np
import jax.numpy as jnp

from tests.conftest import make_cloud
from tpuslam.ops.nn import nearest_neighbors_ref


def numpy_nn(src, tgt):
    d = ((src[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
    idx = d.argmin(axis=1)
    return idx, d[np.arange(len(src)), idx]


def test_matches_oracle(rng):
    src = make_cloud(rng, 257)
    tgt = make_cloud(rng, 391)
    tgt_pad = np.zeros((512, 3), dtype=np.float32)
    tgt_pad[:391] = tgt
    idx, dist = nearest_neighbors_ref(
        jnp.asarray(src), jnp.asarray(tgt_pad), jnp.int32(391)
    )
    idx_np, dist_np = numpy_nn(src.astype(np.float64), tgt.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(idx), idx_np)
    np.testing.assert_allclose(np.asarray(dist), dist_np, atol=1e-3)


def test_padding_never_wins(rng):
    src = make_cloud(rng, 10)
    # padded rows are zeros at the origin — put sources at the origin too
    src[0] = 0.0
    tgt = make_cloud(rng, 37) + 5.0
    tgt_pad = np.zeros((128, 3), dtype=np.float32)
    tgt_pad[:37] = tgt
    idx, _ = nearest_neighbors_ref(
        jnp.asarray(src), jnp.asarray(tgt_pad), jnp.int32(37)
    )
    assert (np.asarray(idx) < 37).all()


def test_first_index_tie_break():
    src = np.array([[0.0, 0.0, 0.0]], dtype=np.float32)
    tgt = np.zeros((128, 3), dtype=np.float32)
    tgt[:4] = [[1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1]]  # all dist 1
    idx, dist = nearest_neighbors_ref(
        jnp.asarray(src), jnp.asarray(tgt), jnp.int32(4)
    )
    assert int(idx[0]) == 0
    assert float(dist[0]) == 1.0


def test_chunked_path(rng):
    src = make_cloud(rng, 5000)
    tgt = make_cloud(rng, 700)
    tgt_pad = np.zeros((768, 3), dtype=np.float32)
    tgt_pad[:700] = tgt
    idx, dist = nearest_neighbors_ref(
        jnp.asarray(src), jnp.asarray(tgt_pad), jnp.int32(700), chunk=1024
    )
    idx_np, dist_np = numpy_nn(src.astype(np.float64), tgt.astype(np.float64))
    # f32 vs f64 can flip near-ties; indices must agree wherever the
    # top-2 margin is clear, distances must agree everywhere
    np.testing.assert_allclose(np.asarray(dist), dist_np, atol=1e-3)
    d_full = ((src[:, None, :].astype(np.float64)
               - tgt[None, :, :].astype(np.float64)) ** 2).sum(-1)
    top2 = np.partition(d_full, 1, axis=1)[:, :2]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(np.asarray(idx)[clear], idx_np[clear])


def test_no_match_contract_unified(rng):
    """Zero valid targets: every NN path returns (idx=0, dist=BIG) — the
    argmin-over-all-BIG convention of the jnp oracle.  A stable in-range
    index matters: the sharded combine adds a shard offset to it and the
    ICP loop gathers with it (padding weight masks the pair later)."""
    from tpuslam.kernels.pallas_nn import nearest_neighbors_pallas
    from tpuslam.ops.nn import BIG

    src = jnp.asarray(make_cloud(rng, 256))
    tgt = jnp.asarray(make_cloud(rng, 512))
    count = jnp.int32(0)

    idx, dist = nearest_neighbors_ref(src, tgt, count)
    assert (np.asarray(idx) == 0).all()
    assert (np.asarray(dist) == float(BIG)).all()

    idx, dist = nearest_neighbors_pallas(src, tgt, count, interpret=True)
    assert (np.asarray(idx) == 0).all()
    assert (np.asarray(dist) == float(BIG)).all()
