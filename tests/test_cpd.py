"""CPD: blocked-E-step EM vs a literal NumPy transcription of the
reference's exact algorithm (``coherentpointdrift.cpp``), plus
self-registration convergence oracles (SURVEY §4 test plan)."""

import math

import numpy as np
import pytest

from tests.conftest import random_rigid
from tpuslam.algorithms.cpd import (
    Sufficient,
    cpd_estep,
    cpd_mstep,
    cpd_register,
    sigma_squared_init,
    uniform_constant,
)
from tpuslam.config.configuration import ApproximationType
from tpuslam.core.types import pad_cloud

import jax.numpy as jnp


def numpy_sigma_squared(before, after):
    """O(N M) loop oracle (coherentpointdrift.cpp:126-139)."""
    total = 0.0
    for b in before:
        d = after - b
        total += np.sum(d * d)
    return total / (3.0 * len(before) * len(after))


def numpy_estep(transformed, target, constant, sigma2,
                do_truncate=False, truncate=1e-3):
    """Literal oracle of ComputePMatrix (coherentpointdrift.cpp:167-221)."""
    m, n = len(transformed), len(target)
    mult = -0.5 / sigma2
    p1 = np.zeros(m)
    pt1 = np.zeros(n)
    px = np.zeros((m, 3))
    error = 0.0
    log_trunc = math.log(truncate)
    for x in range(n):
        diff = target[x] - transformed
        idx = mult * np.sum(diff * diff, axis=-1)
        p = np.exp(idx)
        if do_truncate:
            p[idx < log_trunc] = 0.0
        denom = p.sum() + constant
        pt1[x] = 1.0 - constant / denom
        p1 += p / denom
        px += np.outer(p / denom, target[x])
        error -= math.log(denom)
    error += 3.0 * n * math.log(sigma2) / 2.0
    return p1, pt1, px, error


def small_clouds(rng, m=96, n=80):
    before = (rng.random((m, 3)) * 4.0 - 2.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.15, trans=0.3)
    after = (before[:n] @ r.T + t).astype(np.float32)
    return before, after, r, t


def test_sigma_squared_closed_form(rng):
    before, after, _, _ = small_clouds(rng)
    cb, ca = pad_cloud(before), pad_cloud(after)
    got = float(
        sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask())
    )
    want = numpy_sigma_squared(before, after)
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("truncate", [False, True])
def test_estep_matches_reference_oracle(rng, truncate):
    before, after, _, _ = small_clouds(rng)
    cb, ca = pad_cloud(before), pad_cloud(after)
    sigma2 = numpy_sigma_squared(before, after)
    c = float(
        uniform_constant(
            jnp.float32(sigma2), jnp.float32(0.3),
            jnp.float32(len(before)), jnp.float32(len(after)),
        )
    )
    stats = cpd_estep(
        cb.points, cb.mask(), ca.points, ca.mask(),
        jnp.float32(sigma2), jnp.float32(c), jnp.asarray(truncate),
    )
    p1, pt1, px, error = numpy_estep(
        before.astype(np.float64), after.astype(np.float64), c, sigma2,
        do_truncate=truncate,
    )
    np.testing.assert_allclose(np.asarray(stats.p1)[: len(before)], p1,
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(stats.pt1)[: len(after)], pt1,
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(stats.px)[: len(before)], px,
                               rtol=2e-4, atol=1e-5)
    assert float(stats.error) == pytest.approx(error, rel=1e-3)
    # padded rows carry no statistics
    assert np.all(np.asarray(stats.p1)[len(before):] == 0)
    assert np.all(np.asarray(stats.pt1)[len(after):] == 0)


def test_mstep_identity_fixture(rng):
    """With uniform responsibilities between identical clouds the M-step
    must return R = I, t = 0, scale = 1."""
    pts = (rng.random((64, 3)) * 2.0).astype(np.float32)
    n = len(pts)
    p1 = jnp.ones((n,), jnp.float32)
    stats = Sufficient(
        p1=p1, pt1=p1, px=jnp.asarray(pts), error=jnp.float32(0.0)
    )
    res = cpd_mstep(jnp.asarray(pts), jnp.asarray(pts), stats,
                    const_scale=False, prev_scale=jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(res.rotation), np.eye(3), atol=1e-4)
    np.testing.assert_allclose(np.asarray(res.translation), 0.0, atol=1e-4)
    assert float(res.scale) == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize(
    "mode",
    [ApproximationType.NONE, ApproximationType.Hybrid, ApproximationType.Full],
)
def test_cpd_recovers_transform(rng, mode):
    before = (rng.random((300, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.25, trans=0.5)
    after = (before @ r.T + t)[rng.permutation(300)].astype(np.float32)
    # tolerance tightened vs the 1e-3 default: the reference's relative-
    # likelihood stop triggers prematurely in FGT-constant mode (its own
    # docs report CPD convergence < 0.5 on CPU above ~16k points,
    # documentation.tex:626-642); 1e-6 keeps EM running to the optimum
    result = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, max_iterations=150, tolerance=1e-6,
        approximation_type=mode,
    )
    rot = np.asarray(result.transform.rotation)
    trans = np.asarray(result.transform.translation)
    scale = float(result.transform.scale)
    mse = np.mean(
        np.sum(
            (scale * (before @ rot.T) + trans - (before @ r.T + t)) ** 2, -1
        )
    )
    assert mse < 5e-3
    assert int(result.iterations) > 0


def test_const_scale_keeps_scale_one(rng):
    before = (rng.random((200, 3)) * 4.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.3)
    after = (before @ r.T + t).astype(np.float32)
    result = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, const_scale=True, max_iterations=50,
    )
    assert float(result.transform.scale) == 1.0


def test_missing_max_iterations_runs_zero_iterations(rng):
    """Parser truth: absent max-iterations -> -1 -> EM loop never runs
    (coherentpointdrift.cpp:104), identity result."""
    before = (rng.random((100, 3))).astype(np.float32)
    after = (rng.random((100, 3))).astype(np.float32)
    result = cpd_register(pad_cloud(before), pad_cloud(after),
                          max_iterations=-1)
    assert int(result.iterations) == 0
    np.testing.assert_allclose(
        np.asarray(result.transform.rotation), np.eye(3)
    )


def test_padding_invariance(rng):
    before = (rng.random((150, 3)) * 5.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.4)
    after = (before @ r.T + t).astype(np.float32)
    res_a = cpd_register(
        pad_cloud(before, multiple=128), pad_cloud(after, multiple=128),
        weight=0.1, max_iterations=30,
    )
    res_b = cpd_register(
        pad_cloud(before, multiple=512), pad_cloud(after, multiple=512),
        weight=0.1, max_iterations=30,
    )
    np.testing.assert_allclose(
        np.asarray(res_a.transform.rotation),
        np.asarray(res_b.transform.rotation),
        atol=1e-4,
    )
    assert int(res_a.iterations) == int(res_b.iterations)


def test_history_trace(rng):
    before = (rng.random((150, 3)) * 4.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.15, trans=0.3)
    after = (before @ r.T + t).astype(np.float32)
    result = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, max_iterations=20, tolerance=1e-6,
        record_history=True, history_length=64,
    )
    hist = np.asarray(result.history)
    iters = int(result.iterations)
    assert hist.shape == (64, 4)
    assert iters >= 2
    # recorded sigma2 per iteration, NaN past the final iteration
    assert np.all(np.isfinite(hist[:iters]))
    assert np.all(np.isnan(hist[iters:]))
    # last recorded sigma2 equals the reported error
    assert hist[iters - 1, 0] == pytest.approx(float(result.error))


def test_free_scale_collapse_and_centroid_init_rescue(rng):
    """Free-scale CPD started from identity collapses at large
    translations: near-uniform responsibilities make the cross-covariance
    vanish, the first M-step drives ``scale`` toward 0, and EM stalls in
    that degenerate optimum (faithful to ``coherentpointdrift.cpp``, which
    also starts from identity).  ``centroid_init=True`` (extension) starts
    from the centroid-difference translation and recovers the transform."""
    before = (rng.random((300, 3)) * 10.0).astype(np.float32)
    r, _ = random_rigid(rng, angle=0.3, trans=0.0)
    t = np.array([30.0, -18.0, 22.0], np.float32)
    after = (before @ r.T + t).astype(np.float32)

    collapsed = cpd_register(
        pad_cloud(before), pad_cloud(after), weight=0.1,
        const_scale=False, max_iterations=150, tolerance=1e-5,
    )
    assert float(collapsed.transform.scale) < 0.1  # degenerate optimum

    rescued = cpd_register(
        pad_cloud(before), pad_cloud(after), weight=0.1,
        const_scale=False, centroid_init=True,
        max_iterations=150, tolerance=1e-5,
    )
    assert float(rescued.transform.scale) == pytest.approx(1.0, abs=0.01)
    np.testing.assert_allclose(
        float(rescued.transform.scale)
        * np.asarray(rescued.transform.rotation), r, atol=0.02)
    np.testing.assert_allclose(
        np.asarray(rescued.transform.translation), t, atol=0.1)


def test_centroid_init_noop_when_centroids_match(rng):
    """With coincident centroids the centroid start is the zero start, so
    both paths must agree (same EM trajectory)."""
    before = (rng.random((200, 3)) * 4.0).astype(np.float32)
    before -= before.mean(axis=0)
    r, _ = random_rigid(rng, angle=0.2, trans=0.0)
    after = (before @ r.T).astype(np.float32)
    res_a = cpd_register(pad_cloud(before), pad_cloud(after),
                         weight=0.1, max_iterations=30)
    res_b = cpd_register(pad_cloud(before), pad_cloud(after),
                         weight=0.1, max_iterations=30, centroid_init=True)
    np.testing.assert_allclose(
        np.asarray(res_a.transform.rotation),
        np.asarray(res_b.transform.rotation), atol=1e-5)
    assert int(res_a.iterations) == int(res_b.iterations)


def test_chunked_presorted_matches_unchunked(rng, interpret_kernels):
    """On the kernel arm (the GPU default; Pallas interpret mode here)
    the chunked driver's trajectory is bit-identical to the
    single-dispatch run."""
    from tpuslam.algorithms.cpd import cpd_register_chunked

    before = (rng.random((300, 3)) * 6.0 - 3.0).astype(np.float32)
    after = before[rng.permutation(300)].astype(np.float32) + 0.1
    kw = dict(
        weight=0.1, max_iterations=20, tolerance=1e-6, use_pallas=True
    )
    whole = cpd_register(pad_cloud(before), pad_cloud(after), **kw)
    parts = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), chunk=7, **kw
    )
    assert int(parts.iterations) == int(whole.iterations)
    np.testing.assert_array_equal(
        np.asarray(parts.transform.rotation),
        np.asarray(whole.transform.rotation),
    )
    np.testing.assert_array_equal(
        np.asarray(parts.error), np.asarray(whole.error)
    )


def test_chunked_phase_split_matches_unchunked(rng):
    """Hybrid-with-FGT per-phase dispatch sizing (``chunk_fast`` for the
    FGT fast phase, ``chunk`` for the exact slow phase): the trajectory
    must stay bit-identical to the single-dispatch run whatever the two
    sizes are — the phase test only re-sizes dispatches."""
    from tpuslam.algorithms.cpd import cpd_register_chunked

    before = (rng.random((300, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.25, trans=0.5)
    after = (before @ r.T + t)[rng.permutation(300)].astype(np.float32)
    kw = dict(
        weight=0.1, max_iterations=60, tolerance=1e-6,
        approximation_type=ApproximationType.Hybrid, use_fgt=True,
    )
    whole = cpd_register(pad_cloud(before), pad_cloud(after), **kw)
    for chunk, chunk_fast in ((1, 9), (3, 17)):
        parts = cpd_register_chunked(
            pad_cloud(before), pad_cloud(after), chunk=chunk,
            chunk_fast=chunk_fast, **kw
        )
        assert int(parts.iterations) == int(whole.iterations)
        np.testing.assert_array_equal(
            np.asarray(parts.transform.rotation),
            np.asarray(whole.transform.rotation),
        )
        np.testing.assert_array_equal(
            np.asarray(parts.error), np.asarray(whole.error)
        )


@pytest.mark.parametrize(
    "mode",
    [ApproximationType.NONE, ApproximationType.Hybrid, ApproximationType.Full],
)
def test_chunked_matches_unchunked(rng, mode):
    """Chunked EM dispatch must follow the identical trajectory: the
    boundary state is the exact while_loop carry (same transform bits,
    same sigma^2, same iteration count), for chunk sizes that do and do
    not divide the count."""
    from tpuslam.algorithms.cpd import cpd_register_chunked

    before = (rng.random((300, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.25, trans=0.5)
    after = (before @ r.T + t)[rng.permutation(300)].astype(np.float32)
    kw = dict(
        weight=0.1, max_iterations=60, tolerance=1e-6,
        approximation_type=mode,
    )
    whole = cpd_register(pad_cloud(before), pad_cloud(after), **kw)
    for chunk in (1, 7, 64):
        parts = cpd_register_chunked(
            pad_cloud(before), pad_cloud(after), chunk=chunk, **kw
        )
        assert int(parts.iterations) == int(whole.iterations), chunk
        np.testing.assert_array_equal(
            np.asarray(parts.transform.rotation),
            np.asarray(whole.transform.rotation),
        )
        np.testing.assert_array_equal(
            np.asarray(parts.transform.translation),
            np.asarray(whole.transform.translation),
        )
        np.testing.assert_array_equal(
            np.asarray(parts.error), np.asarray(whole.error)
        )


def test_chunked_minus_one_runs_zero_iterations(rng):
    # CPD's -1 is ZERO iterations (coherentpointdrift.cpp:104), and the
    # chunked driver must preserve that quirk, not treat it as unbounded
    from tpuslam.algorithms.cpd import cpd_register_chunked

    before = (rng.random((200, 3)) * 2.0).astype(np.float32)
    after = (rng.random((200, 3)) * 2.0).astype(np.float32)
    res = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=-1, chunk=4,
        weight=0.1,
    )
    assert int(res.iterations) == 0
    np.testing.assert_allclose(
        np.asarray(res.transform.rotation), np.eye(3), atol=1e-6
    )


def test_checkpoint_resume_matches_uninterrupted(rng, tmp_path):
    """Kill-and-continue for CPD (SURVEY §5.4): checkpointed chunked EM
    continued in a fresh call equals the uninterrupted run bit-for-bit."""
    from tpuslam.algorithms.cpd import cpd_register_chunked

    before = (rng.random((300, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.25, trans=0.5)
    after = (before @ r.T + t)[rng.permutation(300)].astype(np.float32)
    kw = dict(weight=0.1, tolerance=1e-9, chunk=4)
    whole = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=30, **kw
    )
    ck = str(tmp_path / "cpd.ckpt.npz")
    part = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=12,
        checkpoint_path=ck, **kw,
    )
    assert int(part.iterations) == 12
    cont = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=30,
        checkpoint_path=ck, **kw,
    )
    np.testing.assert_array_equal(
        np.asarray(cont.transform.rotation),
        np.asarray(whole.transform.rotation),
    )
    assert int(cont.iterations) == int(whole.iterations)
    assert float(cont.error) == float(whole.error)
    # an ICP checkpoint must be rejected by the CPD loader (kind guard)
    from tpuslam.harness.checkpoint import load_cpd_checkpoint

    with pytest.raises(ValueError, match="kind"):
        from tpuslam.algorithms.icp import ICPResume
        from tpuslam.harness.checkpoint import save_icp_checkpoint

        ick = str(tmp_path / "icp.ckpt.npz")
        save_icp_checkpoint(
            ick,
            ICPResume(
                rotation=np.eye(3, dtype=np.float32),
                translation=np.zeros(3, np.float32),
                error=np.float32(1.0),
            ),
        )
        load_cpd_checkpoint(ick)


def test_registry_cpd_chunk_env_matches_whole(rng, monkeypatch):
    # TPUSLAM_CPD_CHUNK forces the chunked EM driver through the
    # registry; results must be identical to the single-dispatch run
    from tpuslam.algorithms.registry import run_with_configuration
    from tpuslam.config.configuration import ComputationMethod, Configuration

    before = (rng.random((250, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.4)
    after = (before @ r.T + t).astype(np.float32)
    config = Configuration(
        computation_method=ComputationMethod.Cpd,
        max_iterations=40, cpd_weight=0.1, cpd_tolerance=1e-7,
    )
    whole = run_with_configuration(before, after, config)
    monkeypatch.setenv("TPUSLAM_CPD_CHUNK", "6")
    parts = run_with_configuration(before, after, config)
    np.testing.assert_array_equal(parts[0], whole[0])
    np.testing.assert_array_equal(parts[1], whole[1])
    assert parts[2] == whole[2] and parts[3] == whole[3]


def test_checkpoint_mismatch_starts_fresh(rng, tmp_path, capsys):
    # a checkpoint written under different EM parameters (here: weight)
    # is ignored by the driver, not resumed
    from tpuslam.algorithms.cpd import cpd_register_chunked

    before = (rng.random((200, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.4)
    after = (before @ r.T + t).astype(np.float32)
    ck = str(tmp_path / "cpd.ckpt.npz")
    cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=8, chunk=3,
        weight=0.1, tolerance=1e-9, checkpoint_path=ck,
    )
    clean = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=8, chunk=3,
        weight=0.5, tolerance=1e-9,
    )
    resumed = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), max_iterations=8, chunk=3,
        weight=0.5, tolerance=1e-9, checkpoint_path=ck,
    )
    assert "ignoring checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(
        np.asarray(resumed.transform.rotation),
        np.asarray(clean.transform.rotation),
    )


def test_checkpoint_corrupt_file_starts_fresh_cpd(rng, tmp_path, capsys):
    """Truncated/zero-byte checkpoint files are ignored (fresh start,
    overwrite), never a crash — the exact kill-during-save scenario
    checkpointing exists for."""
    from tpuslam.algorithms.cpd import cpd_register_chunked
    from tpuslam.harness.checkpoint import load_cpd_checkpoint

    before = (rng.random((200, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.2, trans=0.5)
    after = (before @ r.T + t)[rng.permutation(200)].astype(np.float32)
    kw = dict(max_iterations=6, chunk=3, weight=0.1)
    clean = cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), **kw
    )
    ck = str(tmp_path / "cpd.ckpt.npz")
    cpd_register_chunked(
        pad_cloud(before), pad_cloud(after), checkpoint_path=ck, **kw
    )
    blob = open(ck, "rb").read()
    for corrupt in (b"", blob[: len(blob) // 2]):
        with open(ck, "wb") as fh:
            fh.write(corrupt)
        res = cpd_register_chunked(
            pad_cloud(before), pad_cloud(after),
            checkpoint_path=ck, **kw,
        )
        assert "ignoring checkpoint" in capsys.readouterr().out
        np.testing.assert_array_equal(
            np.asarray(res.transform.rotation),
            np.asarray(clean.transform.rotation),
        )
        load_cpd_checkpoint(ck)  # overwritten with a valid boundary


def test_history_trace_wraps_as_ring(rng):
    """A run longer than history_length keeps the MOST RECENT
    iterations at slots i % history_length (true ring) — the old clamp
    overwrote one slot and misrepresented the trace (review finding)."""
    before = (rng.random((150, 3)) * 4.0).astype(np.float32)
    r, t = random_rigid(rng, angle=0.15, trans=0.3)
    after = (before @ r.T + t).astype(np.float32)
    full = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, max_iterations=12, tolerance=0.0,
        record_history=True, history_length=64,
    )
    ring = cpd_register(
        pad_cloud(before), pad_cloud(after),
        weight=0.1, max_iterations=12, tolerance=0.0,
        record_history=True, history_length=8,
    )
    iters = int(full.iterations)
    assert iters == 12 and int(ring.iterations) == 12
    hist_full = np.asarray(full.history)
    hist_ring = np.asarray(ring.history)
    # ring slot i%8 holds the LAST write to it: iterations 8..11 evict
    # 0..3; iterations 4..7 remain in slots 4..7
    for i in range(4, 12):
        np.testing.assert_array_equal(hist_ring[i % 8], hist_full[i])


def test_hybrid_fast_threshold_matches_loop_init(rng):
    """The chunked driver's phase test must use EXACTLY the loop's own
    switch value: hybrid_fast_threshold == 0.015 * sigma_squared_init
    on the same arrays, both centroid-init modes."""
    from tpuslam.algorithms.cpd import hybrid_fast_threshold

    before = (rng.random((300, 3)) * 6.0).astype(np.float32)
    after = (before[rng.permutation(300)] + 0.5).astype(np.float32)
    cb, ca = pad_cloud(before), pad_cloud(after)
    want = 0.015 * sigma_squared_init(
        cb.points, cb.mask(), ca.points, ca.mask()
    )
    np.testing.assert_allclose(
        float(hybrid_fast_threshold(cb, ca)), float(want), rtol=1e-6
    )
    t0 = (np.asarray(ca.points)[: 300].mean(0)
          - np.asarray(cb.points)[: 300].mean(0))
    want_c = 0.015 * sigma_squared_init(
        cb.points + jnp.asarray(t0) , cb.mask(), ca.points, ca.mask()
    )
    got_c = hybrid_fast_threshold(cb, ca, centroid_init=True)
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=1e-4)


