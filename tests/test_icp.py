"""ICP integration tests: golden self-registration with a known transform
(the reference's oracle, SURVEY §4.2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import make_cloud, random_rigid
from tpuslam.algorithms.icp import icp_register
from tpuslam.core.types import pad_cloud


def register(before, after, **kw):
    return icp_register(pad_cloud(before), pad_cloud(after), **kw)


def test_recovers_small_transform(rng):
    cloud = make_cloud(rng, 500)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = cloud @ r_true.T + t_true
    res = register(
        cloud, after, eps=1e-5, max_distance_squared=1e4, max_iterations=50
    )
    assert float(res.error) < 1e-4
    np.testing.assert_allclose(
        np.asarray(res.transform.rotation), r_true, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(res.transform.translation), t_true, atol=1e-2
    )


def test_identity_converges_immediately(rng):
    cloud = make_cloud(rng, 200)
    res = register(cloud, cloud.copy(), eps=1e-4, max_iterations=50)
    assert float(res.error) < 1e-4
    assert int(res.iterations) <= 2
    np.testing.assert_allclose(
        np.asarray(res.transform.rotation), np.eye(3), atol=1e-3
    )


def test_respects_max_iterations(rng):
    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 1.2, 8.0)  # hard: won't converge in 3
    after = cloud @ r_true.T + t_true
    res = register(
        cloud, after, eps=1e-12, max_iterations=3, divergence_guard=False
    )
    assert int(res.iterations) <= 3


def test_shuffled_correspondences(rng):
    # after cloud in a different row order — ICP must still register
    cloud = make_cloud(rng, 400)
    r_true, t_true = random_rigid(rng, 0.15, 0.5)
    after = (cloud @ r_true.T + t_true)[rng.permutation(400)]
    res = register(cloud, after, eps=1e-5, max_iterations=50)
    assert float(res.error) < 1e-3


def test_zero_correspondences_stops(rng):
    cloud = make_cloud(rng, 100)
    far = cloud + 1000.0
    res = register(cloud, far, eps=1e-6, max_distance_squared=1.0,
                   max_iterations=10)
    # all NN distances exceed the gate -> loop stops with identity
    np.testing.assert_allclose(
        np.asarray(res.transform.rotation), np.eye(3), atol=1e-6
    )
    assert float(res.error) == pytest.approx(1e5)  # initial sentinel


def test_divergence_guard_reverts(rng):
    # craft: guard must never yield a worse error than the best-seen
    cloud = make_cloud(rng, 150)
    r_true, t_true = random_rigid(rng, 0.9, 6.0)
    after = cloud @ r_true.T + t_true
    res = register(cloud, after, eps=1e-12, max_iterations=100)
    res_ng = register(
        cloud, after, eps=1e-12, max_iterations=100, divergence_guard=False
    )
    assert float(res.error) <= float(res_ng.error) + 1e-3


def test_padded_rows_do_not_perturb(rng):
    cloud = make_cloud(rng, 130)  # pads to 256
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = cloud @ r_true.T + t_true
    res_padded = register(cloud, after, eps=1e-6, max_iterations=30)
    # same clouds, different padding amount
    before_c = pad_cloud(np.concatenate([cloud, np.zeros((0, 3), np.float32)]),
                         multiple=512)
    after_c = pad_cloud(after, multiple=512)
    res_other = icp_register(before_c, after_c, eps=1e-6, max_iterations=30)
    np.testing.assert_allclose(
        np.asarray(res_padded.transform.rotation),
        np.asarray(res_other.transform.rotation),
        atol=1e-5,
    )


def test_registry_end_to_end(rng):
    from tpuslam.algorithms.registry import run_with_configuration
    from tpuslam.config.configuration import Configuration

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = cloud @ r_true.T + t_true
    config = Configuration(
        max_iterations=50, max_distance_squared=1e4, convergence_epsilon=1e-5
    )
    rot, trans, iters, err = run_with_configuration(cloud, after, config)
    assert err < 1e-3
    np.testing.assert_allclose(rot, r_true, atol=1e-2)


def test_registry_chunk_env_matches_whole(rng, monkeypatch):
    # TPUSLAM_ICP_CHUNK forces the chunked driver through the registry;
    # results must be identical to the single-dispatch run
    from tpuslam.algorithms.registry import run_with_configuration
    from tpuslam.config.configuration import Configuration

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.3, 2.0)
    after = cloud @ r_true.T + t_true
    config = Configuration(
        max_iterations=50, max_distance_squared=1e4, convergence_epsilon=1e-7
    )
    whole = run_with_configuration(cloud, after, config)
    monkeypatch.setenv("TPUSLAM_ICP_CHUNK", "6")
    parts = run_with_configuration(cloud, after, config)
    np.testing.assert_array_equal(parts[0], whole[0])
    np.testing.assert_array_equal(parts[1], whole[1])
    assert parts[2] == whole[2]
    assert parts[3] == whole[3]


def test_nan_input_terminates(rng):
    """Fail-fast guard (SURVEY §5.3): non-finite data must not spin the
    unbounded (-1) loop forever."""
    from tpuslam.algorithms.icp import icp_register
    from tpuslam.core.types import pad_cloud

    before = np.full((100, 3), np.nan, dtype=np.float32)
    after = (rng.random((100, 3))).astype(np.float32)
    result = icp_register(
        pad_cloud(before), pad_cloud(after), max_iterations=-1
    )
    assert int(result.iterations) < 10  # terminated, not spun


def test_chunked_matches_unchunked(rng):
    # chunked dispatch must follow the identical trajectory: same final
    # transform, error, and total iteration count, for chunk sizes that
    # do and do not divide the iteration count
    from tpuslam.algorithms.icp import icp_register_chunked

    cloud = make_cloud(rng, 400)
    r_true, t_true = random_rigid(rng, 0.6, 4.0)
    after = cloud @ r_true.T + t_true
    kw = dict(eps=1e-7, max_distance_squared=1e4, max_iterations=50)
    whole = register(cloud, after, **kw)
    for chunk in (1, 3, 10, 64):
        parts = icp_register_chunked(
            pad_cloud(cloud), pad_cloud(after), chunk=chunk, **kw
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


def test_chunked_matches_unchunked_run_to_eps(rng):
    # max_iterations=-1 (run to convergence) through the chunked driver
    from tpuslam.algorithms.icp import icp_register_chunked

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = cloud @ r_true.T + t_true
    kw = dict(eps=1e-5, max_distance_squared=1e4, max_iterations=-1)
    whole = register(cloud, after, **kw)
    parts = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), chunk=4, **kw
    )
    assert int(parts.iterations) == int(whole.iterations)
    np.testing.assert_array_equal(
        np.asarray(parts.error), np.asarray(whole.error)
    )


def test_chunked_divergence_guard(rng):
    # a diverging problem must stop inside a chunk with the reverted
    # transform, exactly as the unchunked guard does
    from tpuslam.algorithms.icp import icp_register_chunked

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 2.8, 20.0)  # hostile transform
    after = cloud @ r_true.T + t_true
    kw = dict(eps=1e-12, max_distance_squared=1e6, max_iterations=40)
    whole = register(cloud, after, **kw)
    parts = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), chunk=7, **kw
    )
    assert int(parts.iterations) == int(whole.iterations)
    np.testing.assert_array_equal(
        np.asarray(parts.transform.rotation),
        np.asarray(whole.transform.rotation),
    )


def test_chunked_matches_unchunked_kernel_arm(rng, interpret_kernels):
    # chunked dispatch on the kernel arm (the GPU default; Pallas
    # interpret mode here): identical trajectory to one whole dispatch
    from tpuslam.algorithms.icp import icp_register_chunked

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.3, 2.0)
    after = cloud @ r_true.T + t_true
    kw = dict(
        eps=1e-7, max_distance_squared=1e4, max_iterations=12,
        use_pallas=True,
    )
    whole = register(cloud, after, **kw)
    parts = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), chunk=5, **kw
    )
    assert int(parts.iterations) == int(whole.iterations)
    np.testing.assert_array_equal(
        np.asarray(parts.transform.rotation),
        np.asarray(whole.transform.rotation),
    )
    np.testing.assert_array_equal(
        np.asarray(parts.error), np.asarray(whole.error)
    )


def test_non_finite_error_reverts_to_last_accepted(rng):
    """A numeric blowup (NaN coordinate) must stop the loop AND revert
    to the last accepted transform instead of committing the NaN step
    (r2 review: pick() previously guarded only no_corr/diverged)."""
    import numpy as np
    from tpuslam.core.types import Cloud, pad_cloud

    pts = make_cloud(rng, 100)
    pts[3] = np.nan
    before = pad_cloud(pts)
    after = pad_cloud(make_cloud(rng, 100))
    res = icp_register(
        before, after, eps=0.0, max_distance_squared=1e18,
        max_iterations=5, divergence_guard=False,
    )
    assert np.isfinite(np.asarray(res.transform.rotation)).all()
    assert np.isfinite(float(res.error))
    np.testing.assert_array_equal(
        np.asarray(res.transform.rotation), np.eye(3, dtype=np.float32)
    )
    assert int(res.iterations) == 0


@pytest.mark.parametrize("env,want", [
    ("7", 7), ("0", 0), ("-3", 0), ("junk", 0), (None, 0),
])
def test_icp_chunk_size_gate(env, want):
    """Chunking happens only on request: an explicit TPUSLAM_*_CHUNK
    value; unset or malformed means one whole-loop dispatch."""
    from tpuslam.algorithms.registry import chunk_size

    assert chunk_size(env) == want


def _anisotropic_pair(rng, angle, trans, n=2000, keep=1500):
    """Clouds with resolvable principal axes, asymmetric subsampling and
    mild noise — the regime where cold-start ICP's basin is exceeded."""
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    base = make_cloud(rng, n) * np.array([4.0, 2.0, 1.0], np.float32)
    r = get_random_rotation_matrix(rng, angle)
    t = get_random_translation_vector(rng, trans)
    before = base[rng.permutation(n)[:keep]]
    after = (
        base[rng.permutation(n)[:keep]] @ r.T + t
        + rng.normal(0.0, 0.02, (keep, 3))
    ).astype(np.float32)
    return before, after, r, t


def test_prealign_rescues_large_motion(rng):
    # icp-prealign extension: a one-shot NICP seed moves a motion far
    # outside cold ICP's basin (rotation 2.6 rad, translation 40) into it
    from tpuslam.algorithms.icp import icp_register_prealigned

    before, after, r_true, t_true = _anisotropic_pair(rng, 2.6, 40.0)
    kw = dict(eps=1e-5, max_distance_squared=1e9, max_iterations=100)
    cold = register(before, after, **kw)
    pre = icp_register_prealigned(pad_cloud(before), pad_cloud(after), **kw)
    np.testing.assert_allclose(
        np.asarray(pre.transform.rotation), r_true, atol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(pre.transform.translation), t_true, atol=0.5
    )
    # the cold start must NOT have recovered the rotation (otherwise this
    # test stopped exercising the rescue) and the seeded run must beat it
    assert np.abs(np.asarray(cold.transform.rotation) - r_true).max() > 0.5
    assert float(pre.error) < 0.5 * float(cold.error)


def test_prealign_chunked_matches_unchunked(rng):
    from tpuslam.algorithms.icp import icp_register_prealigned

    before, after, r_true, _ = _anisotropic_pair(rng, 1.0, 10.0, n=600, keep=500)
    kw = dict(eps=1e-7, max_distance_squared=1e9, max_iterations=40)
    whole = icp_register_prealigned(pad_cloud(before), pad_cloud(after), **kw)
    parts = icp_register_prealigned(
        pad_cloud(before), pad_cloud(after), chunk=7, **kw
    )
    np.testing.assert_array_equal(
        np.asarray(parts.transform.rotation), np.asarray(whole.transform.rotation)
    )
    np.testing.assert_array_equal(
        np.asarray(parts.transform.translation),
        np.asarray(whole.transform.translation),
    )
    assert int(parts.iterations) == int(whole.iterations)
    assert float(parts.error) == float(whole.error)


def test_prealign_registry_end_to_end(rng):
    from tpuslam.algorithms.registry import run_with_configuration
    from tpuslam.config.configuration import Configuration

    before, after, r_true, t_true = _anisotropic_pair(rng, 2.6, 40.0)
    config = Configuration(
        max_iterations=100, max_distance_squared=1e9,
        convergence_epsilon=1e-5, icp_prealign=True,
    )
    rot, trans, iters, err = run_with_configuration(before, after, config)
    np.testing.assert_allclose(rot, r_true, atol=2e-2)
    np.testing.assert_allclose(trans, t_true, atol=0.5)


def test_prealign_degenerate_axes_stays_finite(rng):
    """On an isotropic cloud (cube: principal axes unresolvable) the NICP
    seed is arbitrary — prealigned ICP must still terminate with finite,
    proper results (the divergence guard bounds the damage)."""
    from tpuslam.algorithms.icp import icp_register_prealigned

    cloud = make_cloud(rng, 1000)  # uniform cube, isotropic covariance
    r_true, t_true = random_rigid(rng, 0.3, 2.0)
    after = (cloud @ r_true.T + t_true)[rng.permutation(1000)].astype(
        np.float32
    )
    res = icp_register_prealigned(
        pad_cloud(cloud), pad_cloud(after),
        eps=1e-5, max_distance_squared=1e9, max_iterations=60,
    )
    rot = np.asarray(res.transform.rotation)
    assert np.all(np.isfinite(rot))
    assert np.isfinite(float(res.error))
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-4)
    assert np.linalg.det(rot) == pytest.approx(1.0, abs=1e-4)


def test_prealign_large_coordinate_units(rng):
    """The divergence-guard seed must be scale-free: on clouds in large
    units (first-iteration MSE > 1e5) the seeded loop has to actually
    refine, not freeze at the raw NICP transform (regression: an
    absolute 1e5 prev_error seed aborted iteration 1)."""
    from tpuslam.algorithms.icp import icp_register_prealigned

    before, after, r_true, t_true = _anisotropic_pair(rng, 2.0, 30.0)
    scale = 1000.0  # millimeter-style units
    res = icp_register_prealigned(
        pad_cloud(before * scale), pad_cloud(after * scale),
        eps=1e-5, max_distance_squared=1e18, max_iterations=100,
    )
    assert int(res.iterations) > 0 or float(res.error) < 1.0
    np.testing.assert_allclose(
        np.asarray(res.transform.rotation), r_true, atol=2e-2
    )
    np.testing.assert_allclose(
        np.asarray(res.transform.translation), t_true * scale, rtol=0.02,
        atol=0.5 * scale,
    )


def test_checkpoint_resume_matches_uninterrupted(rng, tmp_path):
    """Kill-and-continue (SURVEY §5.4): a chunked run checkpointed to
    disk and continued in a fresh call follows the exact trajectory of
    the uninterrupted run — same transform bits, same iteration count."""
    from tpuslam.algorithms.icp import icp_register_chunked

    cloud = make_cloud(rng, 400)
    r_true, t_true = random_rigid(rng, 0.4, 3.0)
    after = (cloud @ r_true.T + t_true)[rng.permutation(400)].astype(
        np.float32
    )
    kw = dict(eps=1e-7, max_distance_squared=1e4, chunk=5)
    whole = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), max_iterations=30, **kw
    )
    ck = str(tmp_path / "icp.ckpt.npz")
    # "killed" first process: only 10 of the 30 iterations run
    part = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), max_iterations=10,
        checkpoint_path=ck, **kw,
    )
    assert int(part.iterations) == 10
    # fresh process continues from the boundary on disk
    cont = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), max_iterations=30,
        checkpoint_path=ck, **kw,
    )
    np.testing.assert_array_equal(
        np.asarray(cont.transform.rotation),
        np.asarray(whole.transform.rotation),
    )
    np.testing.assert_array_equal(
        np.asarray(cont.transform.translation),
        np.asarray(whole.transform.translation),
    )
    assert int(cont.iterations) == int(whole.iterations)
    assert float(cont.error) == float(whole.error)


def test_checkpoint_mismatch_starts_fresh(rng, tmp_path, capsys):
    """A checkpoint from a different registration (parameters or cloud
    content) is some other run's state: the loader rejects it, and the
    chunked driver treats that as 'no checkpoint' — fresh start, file
    overwritten — so harness sweeps reusing one path stay correct."""
    from tpuslam.algorithms.icp import icp_register_chunked
    from tpuslam.harness.checkpoint import load_icp_checkpoint

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    ck = str(tmp_path / "icp.ckpt.npz")
    kw = dict(max_iterations=6, chunk=3, eps=0.0, checkpoint_path=ck)
    icp_register_chunked(pad_cloud(cloud), pad_cloud(after), **kw)
    import os

    assert os.path.exists(ck)
    # the loader itself rejects a parameter mismatch...
    with pytest.raises(ValueError, match="mismatch"):
        load_icp_checkpoint(ck, expect_meta={"eps": 1e-5})
    # ...and a driver run on DIFFERENT clouds (fingerprint mismatch)
    # ignores the file and produces the same result as a no-checkpoint
    # run instead of resuming foreign state (e.g. the harness's warmup
    # pass perturbs the cloud by 1e-4 and reuses the same path)
    other = (cloud * (1.0 + 1e-4)).astype(np.float32)
    other_after = (other @ r_true.T + t_true).astype(np.float32)
    clean = icp_register_chunked(
        pad_cloud(other), pad_cloud(other_after),
        max_iterations=6, chunk=3, eps=0.0,
    )
    resumed = icp_register_chunked(
        pad_cloud(other), pad_cloud(other_after), **kw
    )
    assert "ignoring checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(
        np.asarray(resumed.transform.rotation),
        np.asarray(clean.transform.rotation),
    )
    assert int(resumed.iterations) == int(clean.iterations)


def test_checkpoint_idempotent_rerun(rng, tmp_path):
    # a completed checkpointed run re-executed with the same arguments
    # returns the same result from the persisted final boundary
    from tpuslam.algorithms.icp import icp_register_chunked

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    ck = str(tmp_path / "icp.ckpt.npz")
    kw = dict(max_iterations=6, chunk=3, eps=0.0, checkpoint_path=ck)
    first = icp_register_chunked(pad_cloud(cloud), pad_cloud(after), **kw)
    again = icp_register_chunked(pad_cloud(cloud), pad_cloud(after), **kw)
    np.testing.assert_array_equal(
        np.asarray(again.transform.rotation),
        np.asarray(first.transform.rotation),
    )
    assert int(again.iterations) == int(first.iterations)
    assert float(again.error) == float(first.error)


def test_registry_checkpoint_env(rng, monkeypatch, tmp_path):
    """TPUSLAM_ICP_CKPT through the registry: a killed chunked run
    continues from disk and lands on the uninterrupted result."""
    from tpuslam.algorithms.registry import run_with_configuration
    from tpuslam.config.configuration import Configuration

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.3, 2.0)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    config = Configuration(
        max_iterations=20, max_distance_squared=1e4,
        convergence_epsilon=0.0,
    )
    monkeypatch.setenv("TPUSLAM_ICP_CHUNK", "4")
    whole = run_with_configuration(cloud, after, config)
    ck = str(tmp_path / "cli.ckpt.npz")
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", ck)
    config_part = Configuration(
        max_iterations=8, max_distance_squared=1e4,
        convergence_epsilon=0.0,
    )
    run_with_configuration(cloud, after, config_part)  # "killed" at 8
    cont = run_with_configuration(cloud, after, config)
    np.testing.assert_array_equal(cont[0], whole[0])
    np.testing.assert_array_equal(cont[1], whole[1])
    assert cont[2] == whole[2] and cont[3] == whole[3]


def test_checkpoint_corrupt_file_starts_fresh(rng, tmp_path, capsys):
    """A truncated or zero-byte file at the checkpoint path (a killed
    legacy save, or a foreign file) is 'not my checkpoint': the driver
    starts fresh and overwrites it instead of crashing at load time."""
    from tpuslam.algorithms.icp import icp_register_chunked
    from tpuslam.harness.checkpoint import load_icp_checkpoint

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    kw = dict(max_iterations=6, chunk=3, eps=0.0)
    clean = icp_register_chunked(pad_cloud(cloud), pad_cloud(after), **kw)

    ck = str(tmp_path / "icp.ckpt.npz")
    # build a real checkpoint, then truncate it mid-file
    icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), checkpoint_path=ck, **kw
    )
    blob = open(ck, "rb").read()
    for corrupt in (b"", blob[: len(blob) // 2]):
        with open(ck, "wb") as fh:
            fh.write(corrupt)
        res = icp_register_chunked(
            pad_cloud(cloud), pad_cloud(after), checkpoint_path=ck, **kw
        )
        assert "ignoring checkpoint" in capsys.readouterr().out
        np.testing.assert_array_equal(
            np.asarray(res.transform.rotation),
            np.asarray(clean.transform.rotation),
        )
        assert int(res.iterations) == int(clean.iterations)
        # the corrupt file was overwritten with a valid boundary
        load_icp_checkpoint(ck)


def test_checkpoint_prealign_and_cold_not_interchangeable(rng, tmp_path):
    """A cold-start checkpoint must not be accepted by a prealigned run
    of the same clouds/parameters (and vice versa): the runs follow
    different trajectories, so resuming across them would silently
    return the wrong arm's result (checkpoint meta carries `prealign`)."""
    import os

    from tpuslam.algorithms.icp import (
        icp_register_chunked,
        icp_register_prealigned,
    )

    cloud = make_cloud(rng, 400)
    r_true, t_true = random_rigid(rng, 1.2, 6.0)  # outside cold basin
    after = (cloud @ r_true.T + t_true)[rng.permutation(400)].astype(
        np.float32
    )
    kw = dict(max_iterations=8, eps=0.0, max_distance_squared=1e6)
    ck = str(tmp_path / "icp.ckpt.npz")

    cold = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), chunk=4,
        checkpoint_path=ck, **kw,
    )
    assert os.path.exists(ck)
    pre_fresh = icp_register_prealigned(
        pad_cloud(cloud), pad_cloud(after), chunk=4, **kw
    )
    # the two arms genuinely differ on this motion
    assert not np.allclose(
        np.asarray(cold.transform.rotation),
        np.asarray(pre_fresh.transform.rotation),
        atol=1e-3,
    )
    # prealigned run over the cold checkpoint: ignores it, matches the
    # fresh prealigned result bit-for-bit
    pre_over_cold = icp_register_prealigned(
        pad_cloud(cloud), pad_cloud(after), chunk=4,
        checkpoint_path=ck, **kw,
    )
    np.testing.assert_array_equal(
        np.asarray(pre_over_cold.transform.rotation),
        np.asarray(pre_fresh.transform.rotation),
    )
    # and the reverse: a cold run over the (now prealigned) checkpoint
    cold_over_pre = icp_register_chunked(
        pad_cloud(cloud), pad_cloud(after), chunk=4,
        checkpoint_path=ck, **kw,
    )
    np.testing.assert_array_equal(
        np.asarray(cold_over_pre.transform.rotation),
        np.asarray(cold.transform.rotation),
    )


def test_prealign_resume_skips_seed_computation(rng, tmp_path, monkeypatch):
    """An idempotent re-run (or continue) of a checkpointed prealigned
    registration loads the post-seed boundary from disk and never pays
    the NICP seed again."""
    import tpuslam.algorithms.nicp as nicp_mod
    from tpuslam.algorithms.icp import icp_register_prealigned

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.8, 4.0)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    kw = dict(max_iterations=6, eps=0.0, max_distance_squared=1e6)
    ck = str(tmp_path / "pre.ckpt.npz")

    calls = []
    real = nicp_mod.nicp_register

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(nicp_mod, "nicp_register", counting)
    first = icp_register_prealigned(
        pad_cloud(cloud), pad_cloud(after), chunk=3,
        checkpoint_path=ck, **kw,
    )
    assert len(calls) == 1
    again = icp_register_prealigned(
        pad_cloud(cloud), pad_cloud(after), chunk=3,
        checkpoint_path=ck, **kw,
    )
    assert len(calls) == 1  # seed superseded by the on-disk boundary
    np.testing.assert_array_equal(
        np.asarray(again.transform.rotation),
        np.asarray(first.transform.rotation),
    )
    assert int(again.iterations) == int(first.iterations)


def test_registry_ckpt_env_alone_forces_chunked(rng, monkeypatch, tmp_path):
    """TPUSLAM_ICP_CKPT without TPUSLAM_ICP_CHUNK (and below the TPU
    auto-chunk gate, as on this CPU backend) must still persist
    boundaries — the env var forces the chunked driver rather than
    being silently ignored."""
    import os

    from tpuslam.algorithms.registry import run_with_configuration
    from tpuslam.config.configuration import Configuration

    cloud = make_cloud(rng, 300)
    r_true, t_true = random_rigid(rng, 0.3, 2.0)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    config = Configuration(
        max_iterations=12, max_distance_squared=1e4,
        convergence_epsilon=0.0,
    )
    monkeypatch.delenv("TPUSLAM_ICP_CHUNK", raising=False)
    whole = run_with_configuration(cloud, after, config)
    ck = str(tmp_path / "forced.ckpt.npz")
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", ck)
    config_part = Configuration(
        max_iterations=5, max_distance_squared=1e4,
        convergence_epsilon=0.0,
    )
    run_with_configuration(cloud, after, config_part)
    assert os.path.exists(ck)  # boundary persisted despite chunk gate 0
    cont = run_with_configuration(cloud, after, config)
    np.testing.assert_array_equal(cont[0], whole[0])
    assert cont[2] == whole[2] and cont[3] == whole[3]


def test_cloud_fingerprint_discriminates(rng):
    """The fingerprint separates row permutations (warm NN bounds are
    per-row), centered clouds (sum alone collapses toward 0), and
    rotations of the same centered cloud."""
    from tpuslam.harness.checkpoint import cloud_fingerprint

    pts = make_cloud(rng, 500)
    pts -= pts.mean(axis=0)  # centered: plain sum ~ 0
    c = pad_cloud(pts)
    fp = cloud_fingerprint(c.points, c.mask())
    perm = pad_cloud(pts[rng.permutation(len(pts))])
    fp_perm = cloud_fingerprint(perm.points, perm.mask())
    assert fp != fp_perm
    r, _ = random_rigid(rng, 0.7, 0.0)
    rot = pad_cloud((pts @ r.T).astype(np.float32))
    fp_rot = cloud_fingerprint(rot.points, rot.mask())
    assert fp != fp_rot
