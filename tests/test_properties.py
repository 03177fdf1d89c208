"""Property-based tests (hypothesis): invariants that must hold for ALL
inputs, not just the seeded fixtures — the test-strategy depth the
reference lacks entirely (SURVEY §4: no unit framework at all).

Shapes are FIXED inside each property and only the values vary, so jit
caches one executable per test instead of recompiling per example.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import jax.numpy as jnp

from tpuslam.data.synthesis import (
    apply_permutation,
    inverse_permutation,
)
from tpuslam.ops.nn import nearest_neighbors_ref
from tpuslam.ops.procrustes import weighted_procrustes

# moderate, non-degenerate coordinate range (registration operates on
# normalized clouds of spread ~10; extreme magnitudes are covered by the
# writer/loader fuzz tests)
coords = st.floats(
    min_value=-100.0, max_value=100.0,
    allow_nan=False, allow_infinity=False, width=32,
)


def points_strategy(n):
    return hnp.arrays(np.float32, (n, 3), elements=coords)


@settings(max_examples=60, deadline=None)
@given(points_strategy(24), st.integers(0, 2**31 - 1))
def test_procrustes_always_proper(before, seed):
    """For ANY input pair, the recovered rotation is proper:
    det(R) = +1 and R R^T = I (the det-correction contract that
    replaces the reference's gesvd sign gymnastics, SURVEY §2.7)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    after = rng.standard_normal((24, 3)).astype(np.float32) * 10.0
    w = (rng.random(24) > 0.3).astype(np.float32)
    r, t = weighted_procrustes(
        jnp.asarray(before), jnp.asarray(after), jnp.asarray(w)
    )
    r = np.asarray(r, np.float64)
    assert np.isfinite(r).all() and np.isfinite(np.asarray(t)).all()
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-3)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-3)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(0.0, np.pi))
def test_procrustes_recovers_exact_rigid(seed, angle):
    """When after IS a rigid transform of before (non-degenerate spread),
    the minimizer recovers it to f32 accuracy for any axis/angle."""
    rng = np.random.Generator(np.random.PCG64(seed))
    before = (rng.random((32, 3)) * 10.0 - 5.0).astype(np.float32)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    k = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    r_true = (
        np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    ).astype(np.float32)
    t_true = rng.standard_normal(3).astype(np.float32) * 5.0
    after = before @ r_true.T + t_true
    r, t = weighted_procrustes(
        jnp.asarray(before), jnp.asarray(after),
        jnp.ones((32,), jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(r), r_true, atol=5e-3)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=5e-2)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 16))
def test_nn_matches_bruteforce_with_ties(seed, quant):
    """The NN oracle equals NumPy brute force — including the FIRST-
    index-wins tie-break (``common.cpp:416`` strict ``<``) — on
    coordinates quantized hard enough to force distance ties."""
    rng = np.random.Generator(np.random.PCG64(seed))
    src = np.round(rng.random((32, 3)) * quant).astype(np.float32)
    tgt = np.round(rng.random((40, 3)) * quant).astype(np.float32)
    count = int(rng.integers(1, 41))
    idx, dist = nearest_neighbors_ref(
        jnp.asarray(src), jnp.asarray(tgt), jnp.int32(count)
    )
    d2 = np.sum(
        (src[:, None, :].astype(np.float64)
         - tgt[None, :count, :].astype(np.float64)) ** 2, -1
    )
    want_idx = np.argmin(d2, axis=1)  # np.argmin: first occurrence wins
    np.testing.assert_array_equal(np.asarray(idx), want_idx)
    np.testing.assert_allclose(
        np.asarray(dist), d2[np.arange(32), want_idx], rtol=1e-6
    )


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**31 - 1), st.data())
def test_permutation_utils_properties(seed, data):
    """inverse_permutation inverts; apply_permutation touches exactly
    the first min(len(perm), len(values)) rows (identity padding past
    the permutation length, ``common.h:100-108``).  Domain: permutation
    indices < len(values) — beyond it the reference is C++ UB (see the
    apply_permutation docstring), ours raises."""
    n_vals = data.draw(st.integers(1, 64))
    n_perm = data.draw(st.integers(1, n_vals))
    rng = np.random.Generator(np.random.PCG64(seed))
    perm = rng.permutation(n_perm)
    inv = inverse_permutation(perm)
    np.testing.assert_array_equal(perm[inv], np.arange(n_perm))
    np.testing.assert_array_equal(inv[perm], np.arange(n_perm))
    vals = rng.standard_normal((n_vals, 3)).astype(np.float32)
    out = apply_permutation(vals, perm)
    k = min(n_perm, n_vals)
    np.testing.assert_array_equal(out[:k], vals[perm[:k]])
    np.testing.assert_array_equal(out[k:], vals[k:])


@settings(max_examples=30, deadline=None)
@given(points_strategy(48))
def test_writer_roundtrip_any_values(pts):
    """save_cloud -> load_cloud is the bitwise identity for ANY finite
    f32 coordinates (both formats)."""
    import os
    import tempfile

    from tpuslam.data.loader import load_cloud
    from tpuslam.data.writer import save_cloud

    for ext in (".obj", ".off"):
        fd, path = tempfile.mkstemp(suffix=ext)
        os.close(fd)
        try:
            assert save_cloud(path, pts)
            np.testing.assert_array_equal(load_cloud(path), pts)
        finally:
            os.unlink(path)


@settings(max_examples=25, deadline=None)
@given(
    st.dictionaries(
        st.sampled_from(
            [
                "method", "before-path", "after-path", "max-iterations",
                "cloud-before-resize", "cloud-after-resize", "random-seed",
                "rotation-range", "translation-range", "cloud-spread",
                "noise-affected-points-before", "cpd-weight",
                "approximation-type", "nicp-subcloud-size",
            ]
        ),
        st.one_of(
            st.integers(-10, 10**6),
            st.floats(allow_nan=True, allow_infinity=True, width=32),
            st.text(max_size=12),
            st.booleans(),
            st.none(),
        ),
        max_size=8,
    )
)
def test_serve_never_dies(request_dict):
    """ANY JSON-object request yields exactly one parseable response —
    adversarial values (NaN ranges, negative sizes, junk strings) must
    produce an error response, never kill the service loop."""
    import io
    import json

    from tpuslam.harness.cli import run_serve

    inp = io.StringIO(json.dumps(request_dict) + "\n")
    out = io.StringIO()
    assert run_serve(inp, out) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    resp = json.loads(lines[0])
    assert isinstance(resp["ok"], bool)
    if not resp["ok"]:
        assert resp["error"]


@settings(max_examples=40, deadline=None)
@given(points_strategy(24), st.integers(0, 2**31 - 1))
def test_transform_points_matches_f64_oracle(points, seed):
    """transform_points (the per-coordinate FMA form that stays exact
    f32 — the [N,3]@[3,3] matmul form may run in TF32 on the GPU) must
    agree with a float64 matmul oracle to f32
    roundoff for ANY rotation/translation/scale, in both the plain and
    the explicitly-batched-rotation broadcast layouts."""
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam.ops.geometry import transform_points

    rng = np.random.Generator(np.random.PCG64(seed))
    r = get_random_rotation_matrix(rng, rng.random() * np.pi)
    t = get_random_translation_vector(rng, rng.random() * 30.0)
    s = np.float32(0.25 + rng.random() * 4.0)

    oracle = (
        s * (points.astype(np.float64) @ np.asarray(r, np.float64).T)
        + np.asarray(t, np.float64)
    )
    # worst-case f32 error of the FMA form: a few ulps of the result
    # magnitude per coordinate
    tol = 1e-5 * max(1.0, float(np.abs(oracle).max()))

    got = np.asarray(transform_points(jnp.asarray(points), r, t, s))
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=0)

    # batched layout: rotation f32[B,3,3] against points f32[B,N,3]
    bp = np.stack([points, points[::-1]])
    br = np.stack([np.asarray(r, np.float32)] * 2)
    bt = np.stack([np.asarray(t, np.float32)] * 2)
    got_b = np.asarray(
        transform_points(jnp.asarray(bp), br, bt[:, None, :], s)
    )
    np.testing.assert_allclose(got_b[0], oracle, atol=tol, rtol=0)
    np.testing.assert_allclose(got_b[1], oracle[::-1], atol=tol, rtol=0)
