"""Batched multi-pair registration: each pair's result must equal its
solo run (the vmap-freeze property of the loop bodies)."""

import numpy as np
import pytest

from tests.conftest import random_rigid
from tpuslam.algorithms.batch import (
    cpd_register_batch,
    icp_register_batch,
    nicp_register_batch,
    stack_clouds,
)
from tpuslam.algorithms.icp import icp_register
from tpuslam.core.types import pad_cloud


def make_pairs(rng, sizes, angle=0.2, trans=1.0):
    befores, afters, truths = [], [], []
    for n in sizes:
        b = (rng.random((n, 3)) * 10).astype(np.float32)
        r, t = random_rigid(rng, angle=angle, trans=trans)
        a = (b @ r.T + t)[rng.permutation(n)].astype(np.float32)
        befores.append(b)
        afters.append(a)
        truths.append((r, t))
    return befores, afters, truths


def test_icp_batch_matches_solo(rng):
    befores, afters, truths = make_pairs(rng, [300, 450, 200])
    batch = icp_register_batch(
        stack_clouds(befores), stack_clouds(afters), max_iterations=30
    )
    for i, (b, a) in enumerate(zip(befores, afters)):
        solo = icp_register(
            pad_cloud(b, multiple=512), pad_cloud(a, multiple=512),
            max_iterations=30, use_pallas=False,
        )
        np.testing.assert_allclose(
            np.asarray(batch.transform.rotation[i]),
            np.asarray(solo.transform.rotation),
            atol=1e-5,
        )
        assert int(batch.iterations[i]) == int(solo.iterations)
        # and each recovers its own injected transform
        r, t = truths[i]
        rot = np.asarray(batch.transform.rotation[i])
        tr = np.asarray(batch.transform.translation[i])
        mse = np.mean(np.sum((b @ rot.T + tr - (b @ r.T + t)) ** 2, -1))
        assert mse < 1e-3


def test_icp_batch_unrolled_matches_vmapped(rng):
    # the large-pair lowering (tools/batch_diag.py crossover) unrolls
    # solo bodies instead of vmapping the while_loop; forced ON here at
    # small sizes, it must agree with the vmapped lowering pair-by-pair
    befores, afters, _ = make_pairs(rng, [300, 450, 200])
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    vmapped = icp_register_batch(bb, ba, max_iterations=30, unroll=False)
    unrolled = icp_register_batch(bb, ba, max_iterations=30, unroll=True)
    np.testing.assert_allclose(
        np.asarray(unrolled.transform.rotation),
        np.asarray(vmapped.transform.rotation),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(unrolled.transform.translation),
        np.asarray(vmapped.transform.translation),
        atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(unrolled.iterations), np.asarray(vmapped.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(unrolled.error), np.asarray(vmapped.error), atol=1e-6
    )


def test_icp_batch_unrolled_kernel_matches_vmapped(rng, gpu_selection):
    # both lowerings on the kernel arm (the GPU default; interpret mode
    # here) agree with each other and with per-pair solo runs
    befores, afters, _ = make_pairs(rng, [300, 450, 200])
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    vmapped = icp_register_batch(bb, ba, max_iterations=12, unroll=False)
    unrolled = icp_register_batch(bb, ba, max_iterations=12, unroll=True)
    np.testing.assert_allclose(
        np.asarray(unrolled.transform.rotation),
        np.asarray(vmapped.transform.rotation),
        atol=1e-6,
    )
    for i, (b, a) in enumerate(zip(befores, afters)):
        solo = icp_register(
            pad_cloud(b, multiple=512), pad_cloud(a, multiple=512),
            max_iterations=12,
        )
        np.testing.assert_allclose(
            np.asarray(unrolled.transform.rotation[i]),
            np.asarray(solo.transform.rotation),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(unrolled.transform.translation[i]),
            np.asarray(solo.transform.translation),
            atol=1e-6,
        )
        assert int(unrolled.iterations[i]) == int(solo.iterations)


def test_nicp_batch_recovers(rng):
    befores, afters, truths = make_pairs(rng, [400, 350], angle=0.3)
    # NICP needs anisotropic clouds
    befores = [b * np.array([1.0, 0.5, 0.2], np.float32) for b in befores]
    afters = []
    for b, (r, t) in zip(befores, truths):
        afters.append((b @ r.T + t).astype(np.float32))
    batch = nicp_register_batch(stack_clouds(befores), stack_clouds(afters))
    for i, (b, (r, t)) in enumerate(zip(befores, truths)):
        rot = np.asarray(batch.transform.rotation[i])
        tr = np.asarray(batch.transform.translation[i])
        mse = np.mean(np.sum((b @ rot.T + tr - (b @ r.T + t)) ** 2, -1))
        assert mse < 1e-3


def test_cpd_batch_recovers(rng):
    befores, afters, truths = make_pairs(rng, [200, 250], angle=0.2,
                                         trans=0.5)
    # const-scale: the free-scale M-step can collapse on this fixture
    # (same failure solo — the batch faithfully reproduces it)
    batch = cpd_register_batch(
        stack_clouds(befores), stack_clouds(afters),
        weight=0.1, max_iterations=60, tolerance=1e-6, const_scale=True,
    )
    for i, (b, (r, t)) in enumerate(zip(befores, truths)):
        rot = np.asarray(batch.transform.rotation[i])
        tr = np.asarray(batch.transform.translation[i])
        s = float(batch.transform.scale[i])
        mse = np.mean(
            np.sum((s * (b @ rot.T) + tr - (b @ r.T + t)) ** 2, -1)
        )
        assert mse < 5e-3


def test_stack_clouds_padding(rng):
    clouds = [rng.random((n, 3)).astype(np.float32) for n in (50, 300)]
    stacked = stack_clouds(clouds)
    assert stacked.points.shape == (2, 384, 3)
    assert list(np.asarray(stacked.count)) == [50, 300]


def test_register_pairs_library_api(rng):
    """Top-level tpuslam.register_pairs equals per-pair tpuslam.register
    for every method (the one-call batched API)."""
    import numpy as np

    import tpuslam
    from tests.conftest import make_cloud, random_rigid

    pairs = []
    for k in range(3):
        before = make_cloud(rng, 200 + 40 * k)
        r, t = random_rigid(rng, angle=0.15, trans=0.4)
        pairs.append((before, (before @ r.T + t).astype(np.float32)))
    befores = [p[0] for p in pairs]
    afters = [p[1] for p in pairs]

    for method, kwargs in (
        (tpuslam.ComputationMethod.Icp, {}),
        (tpuslam.ComputationMethod.NoniterativeIcp, {}),
        (tpuslam.ComputationMethod.Cpd, {"max_iterations": 8}),
    ):
        rots, ts, iters, errs = tpuslam.register_pairs(
            befores, afters, computation_method=method, **kwargs
        )
        assert rots.shape == (3, 3, 3) and ts.shape == (3, 3)
        for i, (bf, af) in enumerate(pairs):
            r1, t1, it1, e1 = tpuslam.register(
                bf, af, computation_method=method, **kwargs
            )
            # batched pairs pad to a COMMON size, solo runs to their
            # own 128-multiple: different reduction tiling => f32-level
            # differences only
            np.testing.assert_allclose(rots[i], r1, atol=1e-4)
            np.testing.assert_allclose(ts[i], t1, atol=1e-4)


def test_prealign_batch_matches_solo(rng):
    # anisotropic pairs at a motion outside the cold basin: the batched
    # prealigned path must equal per-pair icp_register_prealigned AND
    # recover the injected transform
    from tpuslam.algorithms.batch import icp_register_prealigned_batch
    from tpuslam.algorithms.icp import icp_register_prealigned

    befores, afters, truths = [], [], []
    for n in (300, 450, 200):
        b = (rng.random((n, 3)) * 10 * np.array([4, 2, 1])).astype(
            np.float32
        )
        r, t = random_rigid(rng, angle=2.0, trans=30.0)
        a = (b @ r.T + t)[rng.permutation(n)].astype(np.float32)
        befores.append(b)
        afters.append(a)
        truths.append((r, t))
    kw = dict(eps=1e-6, max_distance_squared=1e9, max_iterations=40)
    batch = icp_register_prealigned_batch(
        stack_clouds(befores), stack_clouds(afters), **kw
    )
    # the large-pair unrolled lowering must agree with the vmapped one
    unrolled = icp_register_prealigned_batch(
        stack_clouds(befores), stack_clouds(afters), unroll=True, **kw
    )
    np.testing.assert_allclose(
        np.asarray(unrolled.transform.rotation),
        np.asarray(batch.transform.rotation),
        atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(unrolled.iterations), np.asarray(batch.iterations)
    )
    for i, (b, a) in enumerate(zip(befores, afters)):
        solo = icp_register_prealigned(
            pad_cloud(b, multiple=512), pad_cloud(a, multiple=512),
            use_pallas=False, **kw,
        )
        np.testing.assert_allclose(
            np.asarray(batch.transform.rotation[i]),
            np.asarray(solo.transform.rotation),
            atol=1e-5,
        )
        assert int(batch.iterations[i]) == int(solo.iterations)
        r, t = truths[i]
        rot = np.asarray(batch.transform.rotation[i])
        tr = np.asarray(batch.transform.translation[i])
        mse = np.mean(np.sum((b @ rot.T + tr - (b @ r.T + t)) ** 2, -1))
        assert mse < 1e-3


def test_register_pairs_prealign(rng):
    # library API honors config.icp_prealign for the batched path
    import tpuslam
    from tpuslam.config.configuration import Configuration

    b = (rng.random((400, 3)) * 10 * np.array([4, 2, 1])).astype(np.float32)
    r, t = random_rigid(rng, angle=2.2, trans=35.0)
    a = (b @ r.T + t)[rng.permutation(400)].astype(np.float32)
    config = Configuration(
        max_iterations=60, max_distance_squared=1e9,
        convergence_epsilon=1e-6, icp_prealign=True,
    )
    rots, trs, iters, errs = tpuslam.register_pairs([b, b], [a, a], config)
    for i in range(2):
        mse = np.mean(
            np.sum((b @ rots[i].T + trs[i] - (b @ r.T + t)) ** 2, -1)
        )
        assert mse < 1e-3


def test_register_pairs_cpd_honors_all_config_fields(rng):
    """The CPD arm of register_pairs must carry every
    trajectory-determining config field (cpd-use-fgt, centroid init,
    FGT shape knobs) — a dropped field silently diverges from the
    documented 'equals its solo register run' contract."""
    import numpy as np

    import tpuslam
    from tests.conftest import make_cloud, random_rigid

    pairs = []
    for k in range(2):
        before = make_cloud(rng, 200)
        r, t = random_rigid(rng, angle=0.15, trans=0.4)
        pairs.append((before, (before @ r.T + t).astype(np.float32)))
    befores = [p[0] for p in pairs]
    afters = [p[1] for p in pairs]

    kwargs = dict(
        computation_method=tpuslam.ComputationMethod.Cpd,
        max_iterations=8,
        cpd_use_fgt=True,
        approximation_type=tpuslam.ApproximationType.Hybrid,
        cpd_centroid_init=True,
        order_of_truncation=6,
    )
    rots, ts, iters, errs = tpuslam.register_pairs(
        befores, afters, **kwargs
    )
    for i, (bf, af) in enumerate(pairs):
        r1, t1, it1, e1 = tpuslam.register(bf, af, **kwargs)
        np.testing.assert_allclose(rots[i], r1, atol=1e-4)
        np.testing.assert_allclose(ts[i], t1, atol=1e-4)
        assert int(iters[i]) == int(it1)


def test_batch_vmap_kernel_equals_solo(rng, gpu_selection):
    """The vmapped lowering on the kernel arm (the pallas_call batched by
    vmap) must be bit-identical to solo runs on the same arm —
    including pairs of different live sizes (padding)."""
    from tpuslam.core.types import Cloud

    sizes = [700, 1024, 512]
    befores, afters, _ = make_pairs(rng, sizes, angle=0.15, trans=2.0)
    bb = stack_clouds(befores)
    ba = stack_clouds(afters)
    out = icp_register_batch(
        bb, ba, eps=0.0, max_distance_squared=1e18, max_iterations=8,
        divergence_guard=False, unroll=False,
    )

    for k in range(len(sizes)):
        solo = icp_register(
            Cloud(bb.points[k], bb.count[k]),
            Cloud(ba.points[k], ba.count[k]),
            eps=0.0, max_distance_squared=1e18, max_iterations=8,
            divergence_guard=False,
        )
        np.testing.assert_array_equal(
            np.asarray(out.transform.rotation[k]),
            np.asarray(solo.transform.rotation),
        )
        np.testing.assert_array_equal(
            np.asarray(out.error[k]), np.asarray(solo.error)
        )
