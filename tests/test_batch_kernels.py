"""The Triton kernels under ``jax.vmap`` (the batched-registration
path): the pallas_call batches by itself (a leading grid axis), and
per-pair results must equal the jnp oracles.  Interpret mode on the CPU."""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from tpuslam.core.types import pad_cloud


def _pairs(rng, b, n, m, counts):
    srcs = (rng.random((b, n, 3)) * 10.0).astype(np.float32)
    tgts = (rng.random((b, m, 3)) * 10.0).astype(np.float32)
    for k, c in enumerate(counts):
        tgts[k, c:] = 77.0  # junk past count; must never win
    return jnp.asarray(srcs), jnp.asarray(tgts), jnp.asarray(counts)


def _nn_kernel():
    from tpuslam.kernels.pallas_nn import nearest_neighbors_pallas

    return functools.partial(nearest_neighbors_pallas, interpret=True)


def test_nn_batched_kernel_matches_ref(rng):
    from tpuslam.ops.nn import nearest_neighbors_ref

    b, n, m = 3, 512, 1024
    counts = np.asarray([1024, 700, 1], np.int32)
    src, tgt, cnt = _pairs(rng, b, n, m, counts)
    idx_b, dist_b = jax.vmap(_nn_kernel())(src, tgt, cnt)
    for k in range(b):
        idx_r, dist_r = nearest_neighbors_ref(src[k], tgt[k], cnt[k])
        np.testing.assert_array_equal(
            np.asarray(idx_b[k]), np.asarray(idx_r), err_msg=f"pair {k}"
        )
        np.testing.assert_array_equal(
            np.asarray(dist_b[k]), np.asarray(dist_r), err_msg=f"pair {k}"
        )


def test_nn_vmap_matches_vmapped_oracle(rng):
    """The dispatching front under vmap on the kernel arm agrees with
    the vmapped oracle, bit for bit."""
    from tpuslam.ops.nn import nearest_neighbors_ref

    b, n, m = 2, 300, 400
    counts = np.asarray([400, 333], np.int32)
    src, tgt, cnt = _pairs(rng, b, n, m, counts)
    idx_b, dist_b = jax.vmap(_nn_kernel())(src, tgt, cnt)
    idx_r, dist_r = jax.vmap(nearest_neighbors_ref)(src, tgt, cnt)
    np.testing.assert_array_equal(np.asarray(idx_b), np.asarray(idx_r))
    np.testing.assert_array_equal(np.asarray(dist_b), np.asarray(dist_r))


def test_nn_vmap_unbatched_target(rng):
    """Many sources against ONE shared target cloud (the map-building
    regime): vmap broadcasts the unbatched operands."""
    from tpuslam.ops.nn import nearest_neighbors_ref

    b, n, m = 3, 256, 512
    src = jnp.asarray((rng.random((b, n, 3)) * 10).astype(np.float32))
    tgt = jnp.asarray((rng.random((m, 3)) * 10).astype(np.float32))
    cnt = jnp.int32(m)
    kern = _nn_kernel()
    idx_b, dist_b = jax.vmap(lambda s: kern(s, tgt, cnt))(src)
    idx_r, dist_r = jax.vmap(
        lambda s: nearest_neighbors_ref(s, tgt, cnt)
    )(src)
    np.testing.assert_array_equal(np.asarray(idx_b), np.asarray(idx_r))
    np.testing.assert_array_equal(np.asarray(dist_b), np.asarray(dist_r))


def _assert_close(out, ref, err_msg=""):
    np.testing.assert_allclose(
        np.asarray(out.p1), np.asarray(ref.p1), rtol=2e-5, atol=1e-6,
        err_msg="p1 " + err_msg,
    )
    np.testing.assert_allclose(
        np.asarray(out.pt1), np.asarray(ref.pt1), rtol=2e-5, atol=1e-6,
        err_msg="pt1 " + err_msg,
    )
    np.testing.assert_allclose(
        np.asarray(out.px), np.asarray(ref.px), rtol=2e-5, atol=1e-5,
        err_msg="px " + err_msg,
    )
    np.testing.assert_allclose(
        np.asarray(out.error), np.asarray(ref.error), rtol=1e-5,
        err_msg="error " + err_msg,
    )


def test_cpd_estep_batched_matches_oracle(rng):
    from tpuslam.algorithms.cpd import cpd_estep
    from tpuslam.kernels.pallas_cpd import cpd_estep_pallas

    b, m, n = 2, 256, 384
    moving = (rng.random((b, m, 3)) * 10.0).astype(np.float32)
    target = (rng.random((b, n, 3)) * 10.0).astype(np.float32)
    mmask = np.ones((b, m), np.float32)
    tmask = np.ones((b, n), np.float32)
    mmask[1, 200:] = 0.0
    tmask[1, 300:] = 0.0
    sigma2 = np.asarray([4.0, 2.5], np.float32)
    constant = np.asarray([0.7, 1.3], np.float32)
    trunc = np.asarray([False, True])

    args = [jnp.asarray(a) for a in
            (moving, mmask, target, tmask, sigma2, constant, trunc)]
    out = jax.vmap(
        functools.partial(cpd_estep_pallas, interpret=True)
    )(*args)
    for k in range(b):
        ref = cpd_estep(*[a[k] for a in args])
        _assert_close(
            jax.tree.map(lambda x: x[k], out), ref, f"pair {k}"
        )


def test_cpd_estep_vmap_unbatched_target(rng):
    """Several moving clouds against one shared target and shared
    scalars: vmap broadcasts the unbatched operands."""
    from tpuslam.algorithms.cpd import cpd_estep
    from tpuslam.kernels.pallas_cpd import cpd_estep_pallas

    b, m, n = 2, 256, 256
    moving = jnp.asarray((rng.random((b, m, 3)) * 10.0).astype(np.float32))
    target = jnp.asarray((rng.random((n, 3)) * 10.0).astype(np.float32))
    mask = jnp.ones((m,), jnp.float32)
    tmask = jnp.ones((n,), jnp.float32)
    s2, c = jnp.float32(3.0), jnp.float32(0.9)
    kern = functools.partial(cpd_estep_pallas, interpret=True)

    out = jax.vmap(
        lambda ty: kern(ty, mask, target, tmask, s2, c, jnp.asarray(False))
    )(moving)
    ref = jax.vmap(
        lambda ty: cpd_estep(ty, mask, target, tmask, s2, c,
                             jnp.asarray(False))
    )(moving)
    _assert_close(out, ref)


def test_batched_icp_on_pallas_route_matches_solo(rng, interpret_kernels):
    """End-to-end: a vmapped icp_register forced onto the kernel arm must
    equal solo registrations on the same arm."""
    from tests.conftest import random_rigid
    from tpuslam.algorithms.batch import stack_clouds
    from tpuslam.algorithms.icp import icp_register

    pairs = []
    for k in range(2):
        before = (rng.random((700 + 111 * k, 3)) * 10).astype(np.float32)
        r, t = random_rigid(rng, angle=0.15, trans=0.7)
        after = (before @ r.T + t)[
            rng.permutation(len(before))
        ].astype(np.float32)
        pairs.append((before, after))

    befores = stack_clouds([p[0] for p in pairs])
    afters = stack_clouds([p[1] for p in pairs])

    def one_batched(b, a):
        return icp_register(b, a, max_iterations=20, use_pallas=True)
    res = jax.vmap(one_batched)(befores, afters)

    for k, (before, after) in enumerate(pairs):
        npad = befores.points.shape[1]
        solo = icp_register(
            pad_cloud(before, multiple=npad),
            pad_cloud(after, multiple=npad),
            max_iterations=20, use_pallas=True,
        )
        np.testing.assert_allclose(
            np.asarray(res.transform.rotation[k]),
            np.asarray(solo.transform.rotation), atol=1e-6,
            err_msg=f"pair {k}",
        )
        assert int(res.iterations[k]) == int(solo.iterations)
