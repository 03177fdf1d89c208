"""Multi-chip sharding: sharded ICP/CPD/NN vs their single-device twins on
the virtual 8-device CPU mesh (SURVEY §4: fake multi-device testing via
``--xla_force_host_platform_device_count``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import random_rigid
from tpuslam.core.types import pad_cloud
from tpuslam.parallel.mesh import make_mesh, replicate_cloud, shard_cloud


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return make_mesh()


def test_sharded_nn_matches_reference(rng, mesh):
    from jax.sharding import PartitionSpec as P

    from tpuslam.ops.nn import nearest_neighbors_ref
    from tpuslam.parallel.nn import sharded_nn_combine

    src = (rng.random((256, 3)) * 10).astype(np.float32)
    tgt_np = (rng.random((900, 3)) * 10).astype(np.float32)
    tgt = shard_cloud(tgt_np, mesh)

    fn = jax.jit(
        jax.shard_map(
            lambda s, t, c: sharded_nn_combine(s, t, c),
            mesh=mesh,
            in_specs=(P(), P("points", None), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )
    gidx, dist, matched = fn(jnp.asarray(src), tgt.points, tgt.count)
    ref_idx, ref_dist = nearest_neighbors_ref(
        jnp.asarray(src), tgt.points, tgt.count
    )
    np.testing.assert_array_equal(np.asarray(gidx), np.asarray(ref_idx))
    np.testing.assert_allclose(
        np.asarray(dist), np.asarray(ref_dist), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(matched), tgt_np[np.asarray(gidx)], atol=1e-6
    )


def test_sharded_nn_chunked_sources(rng, mesh):
    """N > the 2048-row source chunk: the per-shard search must take the
    chunked path (r2 review: the unchunked call materialized an [N, M/d]
    tile that the single-device oracle deliberately bounds) and still
    match the oracle exactly."""
    from jax.sharding import PartitionSpec as P

    from tpuslam.ops.nn import nearest_neighbors_ref
    from tpuslam.parallel.nn import sharded_nn_combine

    src = (rng.random((4500, 3)) * 10).astype(np.float32)
    tgt_np = (rng.random((640, 3)) * 10).astype(np.float32)
    tgt = shard_cloud(tgt_np, mesh)

    fn = jax.jit(
        jax.shard_map(
            lambda s, t, c: sharded_nn_combine(s, t, c),
            mesh=mesh,
            in_specs=(P(), P("points", None), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )
    gidx, dist, matched = fn(jnp.asarray(src), tgt.points, tgt.count)
    ref_idx, ref_dist = nearest_neighbors_ref(
        jnp.asarray(src), tgt.points, tgt.count
    )
    np.testing.assert_array_equal(np.asarray(gidx), np.asarray(ref_idx))
    np.testing.assert_allclose(
        np.asarray(dist), np.asarray(ref_dist), rtol=1e-5, atol=1e-5
    )


def test_sharded_icp_matches_single_device(rng, mesh):
    from tpuslam.algorithms.icp import icp_register
    from tpuslam.parallel.icp import icp_register_sharded

    before = (rng.random((500, 3)) * 10).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=1.0)
    after = (before @ r.T + t)[rng.permutation(500)].astype(np.float32)

    single = icp_register(
        pad_cloud(before), pad_cloud(after), max_iterations=30
    )
    sharded = icp_register_sharded(
        replicate_cloud(before, mesh),
        shard_cloud(after, mesh),
        mesh,
        max_iterations=30,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.transform.rotation),
        np.asarray(single.transform.rotation),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.transform.translation),
        np.asarray(single.transform.translation),
        atol=1e-3,
    )
    # and it actually recovers the injected transform
    rot = np.asarray(sharded.transform.rotation)
    trans = np.asarray(sharded.transform.translation)
    mse = np.mean(
        np.sum((before @ rot.T + trans - (before @ r.T + t)) ** 2, -1)
    )
    assert mse < 1e-3


def test_sharded_icp_kernel_arm_matches_reference(
    rng, mesh, interpret_kernels
):
    """The per-shard search on the kernel arm (the GPU default; interpret
    mode here) inside the sharded ICP loop reproduces the reference arm:
    both compute the same exact per-shard NN, combined by the same
    lex-min collectives."""
    from tpuslam.parallel.icp import icp_register_sharded

    n = 700
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=1.0)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)

    ref = icp_register_sharded(
        replicate_cloud(before, mesh), shard_cloud(after, mesh), mesh,
        max_iterations=25, use_pallas=False,
    )
    kern = icp_register_sharded(
        replicate_cloud(before, mesh), shard_cloud(after, mesh), mesh,
        max_iterations=25, use_pallas=True,
    )
    assert int(kern.iterations) == int(ref.iterations)
    np.testing.assert_allclose(
        np.asarray(kern.transform.rotation),
        np.asarray(ref.transform.rotation),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(kern.transform.rotation), r, atol=1e-2
    )


def test_sharded_chunked_matches_unchunked(rng, mesh):
    """Chunked (warm-started) dispatch over the mesh — the production
    long-registration path (VERDICT r4 #8): the boundary state is the
    exact while_loop carry, so both drivers must follow the identical
    trajectory to their single-dispatch sharded runs."""
    from tpuslam.parallel.cpd import (
        cpd_register_sharded,
        cpd_register_sharded_chunked,
    )
    from tpuslam.parallel.icp import (
        icp_register_sharded,
        icp_register_sharded_chunked,
    )

    before = (rng.random((400, 3)) * 10).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=1.0)
    after = (before @ r.T + t)[rng.permutation(400)].astype(np.float32)
    rep, shd = replicate_cloud(before, mesh), shard_cloud(after, mesh)

    whole = icp_register_sharded(rep, shd, mesh, max_iterations=20)
    parts = icp_register_sharded_chunked(
        rep, shd, mesh, max_iterations=20, chunk=7
    )
    assert int(parts.iterations) == int(whole.iterations)
    np.testing.assert_array_equal(
        np.asarray(parts.transform.rotation),
        np.asarray(whole.transform.rotation),
    )
    np.testing.assert_array_equal(
        np.asarray(parts.error), np.asarray(whole.error)
    )

    kw = dict(weight=0.1, max_iterations=20, tolerance=1e-6)
    whole_c = cpd_register_sharded(rep, shd, mesh, **kw)
    parts_c = cpd_register_sharded_chunked(rep, shd, mesh, chunk=7, **kw)
    assert int(parts_c.iterations) == int(whole_c.iterations)
    np.testing.assert_array_equal(
        np.asarray(parts_c.transform.rotation),
        np.asarray(whole_c.transform.rotation),
    )
    np.testing.assert_array_equal(
        np.asarray(parts_c.error), np.asarray(whole_c.error)
    )


def test_sharded_cpd_matches_single_device(rng, mesh):
    from tpuslam.algorithms.cpd import cpd_register
    from tpuslam.parallel.cpd import cpd_register_sharded

    before = (rng.random((200, 3)) * 5.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.4)
    after = (before @ r.T + t)[rng.permutation(200)].astype(np.float32)

    single = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, max_iterations=40, tolerance=1e-6,
    )
    sharded = cpd_register_sharded(
        replicate_cloud(before, mesh),
        shard_cloud(after, mesh),
        mesh,
        weight=0.1, max_iterations=40, tolerance=1e-6,
    )
    assert int(sharded.iterations) == int(single.iterations)
    np.testing.assert_allclose(
        np.asarray(sharded.transform.rotation),
        np.asarray(single.transform.rotation),
        atol=2e-4,
    )
    # final sigma^2 is tiny and chaotic in f32 summation order; same
    # magnitude is the meaningful check
    np.testing.assert_allclose(
        float(sharded.error), float(single.error), rtol=0.25, atol=1e-5
    )


def test_graft_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip, entry

    dryrun_multichip(8)
    import jax

    fn, args = entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert float(out.error) < 1.0


def test_sharded_nicp_recovers(rng, mesh):
    from tpuslam.parallel.nicp import nicp_register_sharded

    before = (rng.random((600, 3)).astype(np.float32) - 0.5) * np.array(
        [10.0, 4.0, 1.5], dtype=np.float32
    )
    r, t = random_rigid(rng, angle=0.4, trans=5.0)
    after = (before @ r.T + t)[rng.permutation(600)].astype(np.float32)
    result = nicp_register_sharded(
        replicate_cloud(before, mesh), shard_cloud(after, mesh), mesh,
        seed=3,
    )
    rot = np.asarray(result.transform.rotation)
    trans = np.asarray(result.transform.translation)
    assert np.linalg.det(rot) == pytest.approx(1.0, abs=1e-3)
    mse = np.mean(
        np.sum((before @ rot.T + trans - (before @ r.T + t)) ** 2, -1)
    )
    assert mse < 1e-3
    assert int(result.iterations) == 4


def test_pairs_sharded_matches_batch(rng, mesh):
    from tpuslam.algorithms.batch import icp_register_batch, stack_clouds
    from tpuslam.parallel.batch import (
        icp_register_pairs_sharded,
        shard_pairs,
    )

    befores, afters = [], []
    for _ in range(8):  # one pair per virtual device
        b = (rng.random((300, 3)) * 10).astype(np.float32)
        r, t = random_rigid(rng, angle=0.2, trans=1.0)
        befores.append(b)
        afters.append((b @ r.T + t).astype(np.float32))
    sb, sa = stack_clouds(befores), stack_clouds(afters)

    local = icp_register_batch(sb, sa, max_iterations=25)
    sharded = icp_register_pairs_sharded(
        shard_pairs(sb, mesh), shard_pairs(sa, mesh), mesh,
        max_iterations=25,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.transform.rotation),
        np.asarray(local.transform.rotation),
        atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.iterations), np.asarray(local.iterations)
    )


def test_sharded_cpd_fgt_recovers_and_matches_single(rng, mesh):
    """Sharded FGT hybrid (per-shard clustering union, adaptive K) vs
    the single-device FGT path: both must recover the injected
    transform; the clusterings differ by construction, so transform
    agreement is asserted at approximation tolerance."""
    from tpuslam.algorithms.cpd import cpd_register
    from tpuslam.config.configuration import ApproximationType
    from tpuslam.parallel.cpd import cpd_register_sharded

    before = (rng.random((256, 3)) * 5.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.4)
    after = (before @ r.T + t)[rng.permutation(256)].astype(np.float32)

    single = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, max_iterations=60, tolerance=1e-6,
        approximation_type=ApproximationType.Hybrid, use_fgt=True,
    )
    sharded = cpd_register_sharded(
        replicate_cloud(before, mesh),
        shard_cloud(after, mesh),
        mesh,
        weight=0.1, max_iterations=60, tolerance=1e-6,
        approximation_type=ApproximationType.Hybrid, use_fgt=True,
    )
    # both recover the injected rotation
    np.testing.assert_allclose(
        np.asarray(single.transform.rotation), r, atol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(sharded.transform.rotation), r, atol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(sharded.transform.rotation),
        np.asarray(single.transform.rotation),
        atol=2e-2,
    )


def test_sharded_estep_stats_match_tightly(rng, mesh):
    """VERDICT r1 item 9: the sharded exact E-step's sufficient
    statistics (p1, px, error, pt1 reductions) must match the
    single-device E-step at <=1e-5-grade tolerance per call — not just
    the end-to-end sigma^2 magnitude."""
    from jax.sharding import PartitionSpec as P

    from tpuslam.algorithms.cpd import cpd_estep

    n_full = 1024
    moving = (rng.random((384, 3)) * 5.0).astype(np.float32)
    target = (rng.random((n_full, 3)) * 5.0).astype(np.float32)
    mask_b = jnp.ones((384,), jnp.float32)
    sigma2 = jnp.float32(1.7)
    constant = jnp.float32(0.9)

    full = cpd_estep(
        jnp.asarray(moving), mask_b, jnp.asarray(target),
        jnp.ones((n_full,), jnp.float32), sigma2, constant,
        jnp.asarray(False),
    )

    def local(tgt_shard):
        mask_a = jnp.ones((tgt_shard.shape[0],), jnp.float32)
        loc = cpd_estep(
            jnp.asarray(moving), mask_b, tgt_shard, mask_a, sigma2,
            constant, jnp.asarray(False),
        )
        p1 = jax.lax.psum(loc.p1, "points")
        px = jax.lax.psum(loc.px, "points")
        err = jax.lax.psum(loc.error, "points")
        t_pt1_a2 = jax.lax.psum(
            jnp.sum(loc.pt1 * jnp.sum(tgt_shard * tgt_shard, -1)),
            "points",
        )
        s_pt1_a = jax.lax.psum(
            jnp.einsum("n,nr->r", loc.pt1, tgt_shard), "points"
        )
        return p1, px, err, t_pt1_a2, s_pt1_a

    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P("points", None),),
            out_specs=(P(), P(), P(), P(), P()), check_vma=False,
        )
    )
    p1, px, err, t_pt1_a2, s_pt1_a = fn(jnp.asarray(target))

    np.testing.assert_allclose(
        np.asarray(p1), np.asarray(full.p1), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(px), np.asarray(full.px), rtol=1e-5, atol=1e-6
    )
    # error: the per-shard 3*n_local*log(s2)/2 terms psum to the global
    # one exactly in exact arithmetic; f32 reassociation only
    np.testing.assert_allclose(
        float(err), float(full.error), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(t_pt1_a2),
        float(jnp.sum(full.pt1 * jnp.sum(jnp.asarray(target) ** 2, -1))),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(s_pt1_a),
        np.asarray(jnp.einsum("n,nr->r", full.pt1, jnp.asarray(target))),
        rtol=1e-5, atol=1e-5,
    )


def test_sharded_icp_prealigned_recovers_large_motion(rng, mesh):
    """icp-prealign on the points-axis mesh: sharded NICP seed composed
    around the sharded ICP loop recovers a motion outside the cold
    basin, matching the single-device prealigned run."""
    from tpuslam.algorithms.icp import icp_register_prealigned
    from tpuslam.parallel.icp import icp_register_sharded_prealigned

    before = (rng.random((500, 3)) * 10 * np.array([4, 2, 1])).astype(
        np.float32
    )
    r, t = random_rigid(rng, angle=2.2, trans=35.0)
    after = (before @ r.T + t)[rng.permutation(500)].astype(np.float32)

    kw = dict(eps=1e-6, max_distance_squared=1e9, max_iterations=50)
    single = icp_register_prealigned(
        pad_cloud(before), pad_cloud(after), **kw
    )
    sharded = icp_register_sharded_prealigned(
        replicate_cloud(before, mesh), shard_cloud(after, mesh), mesh, **kw
    )
    np.testing.assert_allclose(
        np.asarray(sharded.transform.rotation),
        np.asarray(single.transform.rotation),
        atol=1e-4,
    )
    rot = np.asarray(sharded.transform.rotation)
    trans = np.asarray(sharded.transform.translation)
    mse = np.mean(
        np.sum((before @ rot.T + trans - (before @ r.T + t)) ** 2, -1)
    )
    assert mse < 1e-3


def test_comm_model_matches_traced_collectives(mesh):
    """The byte model in tpuslam.parallel.comm_model must equal the collectives the
    sharded programs ACTUALLY trace — counted from the jaxpr (loop-body
    collectives once = per-iteration accounting), so the model can never
    silently drift from the code."""
    import jax
    import jax.numpy as jnp

    from tpuslam.config.configuration import ApproximationType
    from tpuslam.parallel.comm_model import (
        cpd_comm_bytes,
        cpd_init_comm_bytes,
        icp_comm_bytes,
        nicp_comm_bytes,
        total_collective_bytes,
    )

    n, m = 1024, 2048  # padded; m divisible by 8 devices
    f32 = jnp.float32

    # --- ICP -----------------------------------------------------------
    from tpuslam.parallel import icp as picp

    fn = picp._build(mesh, True)
    jx = jax.make_jaxpr(fn)(
        jnp.zeros((n, 3), f32), jnp.ones((n,), f32),
        jnp.zeros((m, 3), f32), jnp.int32(m),
        f32(1e-3), f32(1e9), jnp.int32(5),
        jnp.eye(3, dtype=f32), jnp.zeros((3,), f32),
        f32(1e5), f32(3.4e38),
    )
    got = total_collective_bytes(jx)
    want = icp_comm_bytes(n)["total"]
    assert got == want, (got, want)

    # --- CPD (exact E-step) --------------------------------------------
    from tpuslam.parallel import cpd as pcpd

    fnc = pcpd._build(mesh, False, ApproximationType.NONE)
    jxc = jax.make_jaxpr(fnc)(
        jnp.zeros((n, 3), f32), jnp.ones((n,), f32),
        jnp.zeros((m, 3), f32), jnp.int32(m),
        f32(0.1), f32(1e-3), f32(1e-3), jnp.int32(5),
        jnp.asarray(False), jnp.eye(3, dtype=f32),
        jnp.zeros((3,), f32), f32(1.0), f32(1.0), f32(0.0), f32(0.0),
    )
    got = total_collective_bytes(jxc)
    want = (
        cpd_comm_bytes(n)["total"] + cpd_init_comm_bytes()["total"]
    )
    assert got == want, (got, want)

    # --- NICP (one shot + batched rescore combine) ----------------------
    from tpuslam.parallel import nicp as pnicp

    k = 256
    fnn = pnicp._build(mesh)
    jxn = jax.make_jaxpr(fnn)(
        jnp.zeros((n, 3), f32), jnp.ones((n,), f32),
        jnp.zeros((m, 3), f32), jnp.int32(m),
        jnp.zeros((k,), jnp.int32),
    )
    got = total_collective_bytes(jxn)
    want = nicp_comm_bytes(k)["total"]
    assert got == want, (got, want)
