"""Sequential scan registration (odometry): pairwise alignment +
absolute pose composition (tpuslam.algorithms.sequence)."""

import numpy as np
import pytest

from tests.conftest import random_rigid
from tpuslam.algorithms.sequence import register_sequence


def _make_trajectory(rng, n_scans=5, n_pts=1500, step_angle=0.08,
                     step_trans=0.4):
    """Static scene scanned from a drifting pose; returns (scans,
    true sensor poses P_k with P_0 = I)."""
    scene = (rng.random((n_pts, 3)) * 10.0).astype(np.float32)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    for _ in range(n_scans - 1):
        dr, dt = random_rigid(rng, angle=step_angle, trans=step_trans)
        r_prev, t_prev = poses[-1]
        poses.append(
            ((r_prev @ dr).astype(np.float32),
             (r_prev @ dt + t_prev).astype(np.float32))
        )
    scans = []
    for r, t in poses:
        # scan = scene in the sensor frame: P_k^-1(scene)
        local = (scene - t) @ r  # r^-1 = r.T applied on the right
        scans.append(local[rng.permutation(n_pts)].astype(np.float32))
    return scans, poses


def _pose_error(est_r, est_t, true_r, true_t):
    dev = np.degrees(np.arccos(np.clip(
        (np.trace(est_r @ true_r.T) - 1) / 2, -1, 1)))
    return dev, float(np.linalg.norm(est_t - true_t))


@pytest.mark.parametrize("batch", [False, True])
def test_register_sequence_recovers_trajectory(rng, batch):
    scans, poses = _make_trajectory(rng)
    out = register_sequence(
        scans, max_iterations=60, batch=batch,
        max_distance_squared=1e6,
    )
    assert len(out.relative) == len(scans) - 1
    assert len(out.absolute) == len(scans)
    for k, (true_r, true_t) in enumerate(poses):
        dev, terr = _pose_error(
            out.absolute[k].rotation, out.absolute[k].translation,
            true_r, true_t,
        )
        assert dev < 1.0 and terr < 0.15, (k, dev, terr, batch)


def test_register_sequence_seed_reduces_iterations(rng):
    """The constant-velocity seed should not cost iterations; on a
    smooth trajectory (repeated similar steps) later pairs start near
    the solution and converge at least as fast as unseeded runs."""
    scans, _ = _make_trajectory(rng, n_scans=5)
    seeded = register_sequence(scans, max_iterations=60,
                               max_distance_squared=1e6)
    cold = register_sequence(scans, max_iterations=60,
                             seed_with_previous=False,
                             max_distance_squared=1e6)
    # pair 0 has no seed either way; compare the rest in aggregate
    assert seeded.iterations[1:].sum() <= cold.iterations[1:].sum()
    for k in range(len(scans) - 1):
        assert seeded.errors[k] < 5e-3


def test_register_sequence_mixed_sizes(rng):
    """Different per-scan sizes pad to one common shape."""
    scans, poses = _make_trajectory(rng, n_scans=3, n_pts=1100)
    scans[1] = scans[1][:700]
    out = register_sequence(scans, max_iterations=60,
                            max_distance_squared=1e6)
    dev, terr = _pose_error(
        out.absolute[-1].rotation, out.absolute[-1].translation,
        poses[-1][0], poses[-1][1],
    )
    assert dev < 1.5 and terr < 0.2


def test_register_sequence_needs_two(rng):
    with pytest.raises(ValueError):
        register_sequence([np.zeros((10, 3), np.float32)])


def test_seeded_accuracy_matches_unseeded(rng):
    """Patience semantics for seeded pairs: a warm start must not LOSE
    accuracy.  Before the patience fix the reference divergence guard
    fired on near-optimum error fluctuation after ~2 iterations and
    returned seed quality (trajectory drift 6x worse at 20x100k,
    measured on an earlier build)."""
    scans, poses = _make_trajectory(rng, n_scans=6)
    seeded = register_sequence(scans, max_iterations=60,
                               max_distance_squared=1e6)
    cold = register_sequence(scans, max_iterations=60,
                             seed_with_previous=False,
                             max_distance_squared=1e6)
    for k, (true_r, true_t) in enumerate(poses):
        dev_s, terr_s = _pose_error(
            seeded.absolute[k].rotation, seeded.absolute[k].translation,
            true_r, true_t,
        )
        dev_c, terr_c = _pose_error(
            cold.absolute[k].rotation, cold.absolute[k].translation,
            true_r, true_t,
        )
        # seeded pose error within 2x of cold (same basin, both tight)
        assert dev_s <= max(2.0 * dev_c, 0.5), (k, dev_s, dev_c)
        assert terr_s <= max(2.0 * terr_c, 0.05), (k, terr_s, terr_c)


def test_scan_lowering_matches_per_pair(rng):
    """The dispatch-amortized scan lowering runs the same per-iteration
    math as the per-pair path (shared ``_icp_loop``); trajectories must
    land in the same optimum (bitwise equality is not promised — pair 0
    runs patience semantics in-scan vs the cold divergence guard
    per-pair)."""
    scans, poses = _make_trajectory(rng)
    scanned = register_sequence(scans, max_iterations=60,
                                max_distance_squared=1e6)
    perpair = register_sequence(scans, max_iterations=60, scan=False,
                                max_distance_squared=1e6)
    for k, (true_r, true_t) in enumerate(poses):
        for out in (scanned, perpair):
            dev, terr = _pose_error(
                out.absolute[k].rotation, out.absolute[k].translation,
                true_r, true_t,
            )
            assert dev < 1.0 and terr < 0.15, (k, dev, terr)


def test_scan_lowering_chunked_dispatch_identical(rng):
    """Splitting the scan lowering into several pairs_per_dispatch
    chunks threads the seed carry across dispatches; the trajectory
    must be identical to the single-dispatch run (the boundary carry
    IS the scan carry)."""
    scans, _ = _make_trajectory(rng, n_scans=6)
    whole = register_sequence(scans, max_iterations=60,
                              max_distance_squared=1e6)
    parts = register_sequence(scans, max_iterations=60,
                              max_distance_squared=1e6,
                              pairs_per_dispatch=2)
    for k in range(len(scans) - 1):
        np.testing.assert_array_equal(
            whole.relative[k].rotation, parts.relative[k].rotation)
        np.testing.assert_array_equal(
            whole.relative[k].translation, parts.relative[k].translation)
    np.testing.assert_array_equal(whole.iterations, parts.iterations)


def test_scan_lowering_kernel_arm(rng, gpu_selection):
    """The scan lowering on the kernel arm (the GPU default; interpret
    mode here) recovers the trajectory."""
    scans, poses = _make_trajectory(rng, n_scans=3, n_pts=700,
                                    step_angle=0.05, step_trans=0.3)
    out = register_sequence(scans, max_iterations=40,
                            max_distance_squared=1e6)
    for k, (true_r, true_t) in enumerate(poses):
        dev, terr = _pose_error(
            out.absolute[k].rotation, out.absolute[k].translation,
            true_r, true_t,
        )
        assert dev < 1.5 and terr < 0.2, (k, dev, terr)


def test_icp_patience_returns_best_state(rng):
    """patience>0 keeps the best-so-far transform: running MORE
    iterations past convergence never degrades the returned error."""
    from tpuslam.algorithms.icp import icp_register
    from tpuslam.core.types import pad_cloud
    from tpuslam.data.synthesis import get_random_rotation_matrix

    base = (rng.random((800, 3), np.float64) * 4).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    after = (base @ r.T + 0.3).astype(np.float32)
    ref = icp_register(pad_cloud(base), pad_cloud(after),
                       max_iterations=40, max_distance_squared=1e6)
    pat = icp_register(pad_cloud(base), pad_cloud(after),
                       max_iterations=40, max_distance_squared=1e6,
                       divergence_guard=False, patience=3)
    assert float(pat.error) <= float(ref.error) * 1.01 + 1e-8


def test_sequence_stream_matches_batch_lowering(rng):
    """The streaming API (one seeded dispatch per arriving scan, device
    artifacts retained) must follow the batch scan lowering's
    trajectory on the same stream — the per-pair math is the shared
    _icp_loop with identical seeds."""
    from tpuslam.algorithms.sequence import SequenceStream

    scans, poses = _make_trajectory(rng)
    batch = register_sequence(scans, max_iterations=60,
                              max_distance_squared=1e6)
    stream = SequenceStream(scans[0], max_iterations=60,
                            max_distance_squared=1e6)
    for s in scans[1:]:
        stream.push(s)
    assert len(stream.absolute) == len(scans)
    for k, (true_r, true_t) in enumerate(poses):
        dev, terr = _pose_error(
            stream.absolute[k].rotation, stream.absolute[k].translation,
            true_r, true_t,
        )
        assert dev < 1.0 and terr < 0.15, (k, dev, terr)
    # same trajectory as the batch lowering (identical per-pair math)
    for k in range(len(scans)):
        np.testing.assert_allclose(
            stream.absolute[k].rotation, batch.absolute[k].rotation,
            atol=1e-5,
        )


def test_sequence_stream_rejects_oversized_scan(rng):
    from tpuslam.algorithms.sequence import SequenceStream

    scans, _ = _make_trajectory(rng, n_scans=2, n_pts=500)
    stream = SequenceStream(scans[0])
    import pytest as _pytest

    with _pytest.raises(ValueError):
        stream.push(np.zeros((4096, 3), np.float32))


def test_sequence_stream_kernel_arm(rng, gpu_selection):
    """Streaming on the kernel arm (the GPU default; interpret mode
    here): device copies retained across pushes."""
    from tpuslam.algorithms.sequence import SequenceStream

    scans, poses = _make_trajectory(rng, n_scans=3, n_pts=700,
                                    step_angle=0.05, step_trans=0.3)
    stream = SequenceStream(scans[0], max_iterations=40,
                            max_distance_squared=1e6)
    for s in scans[1:]:
        stream.push(s)
    dev, terr = _pose_error(
        stream.absolute[-1].rotation, stream.absolute[-1].translation,
        poses[-1][0], poses[-1][1],
    )
    assert dev < 1.5 and terr < 0.2, (dev, terr)
