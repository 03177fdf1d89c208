"""Non-iterative closest point (Oomori-style one-shot SVD registration).

Capability equivalent of the reference's NICP (CPU ``noniterative.cpp``,
GPU ``nicpcuda.cu``), redesigned as one jitted program:

The reference computes, per repetition, SVDs of the two *randomly permuted*
centered 3xN cloud matrices and forms ``R = U_after @ U_before.T``
(``noniterative.cpp:25-55``).  The permutations never change the singular
subspaces — they only jitter which of the sign-ambiguous left singular bases
the numerical SVD happens to return, so K repetitions are a randomized walk
over (at most) the 4 proper-rotation sign combinations of
``R = U_after @ diag(s) @ U_before.T`` (``s in {+-1}^3``, ``det(R) = +1``).

Here we enumerate that candidate set *deterministically and exhaustively*:
two 3x3 eigendecompositions of the masked scatter matrices (the N-point work
is a single f32 contraction each), then all sign candidates scored in one vmap.
This supersedes the reference's K-repetition jitter (``nicp-iterations`` /
``nicp-batch-size`` become no-ops, documented divergence): it evaluates the
complete candidate set the reference samples from, in one shot, with no
batched tall SVDs (``parallelsvdhelper.cu:5-123``) and no stream/thread
machinery.

Approximation-ladder semantics preserved (``noniterative.cpp:57-284``):

* ``None``   — every candidate is scored *exactly*: a fixed random subcloud
  of ``before`` (``GetSubcloud``, ``common.cpp:25-37``) is transformed, NN-
  matched against ``after`` (max distance 1e6, ``noniterative.cpp:73``) and
  the correspondence MSE is the score.
* ``Full``   — candidates ranked by the crude approximated error (MSE of the
  centered clouds in index order under R alone, ``noniterative.cpp:53`` via
  the deprecated overload ``common.cpp:233``); best 1 exactly rescored.
* ``Hybrid`` — best 5 by approximated error exactly rescored, best wins.
  With 4 candidates total this rescoring covers the full set.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tpuslam.algorithms.icp import RegistrationResult
from tpuslam.config.configuration import ApproximationType
from tpuslam.core.types import LANE, Cloud, RigidTransform, round_up
from tpuslam.ops.nn import nearest_neighbors
from tpuslam.ops.geometry import transform_points

BIG = jnp.float32(3.4e38)
# the reference's fixed NN acceptance radius for exact rescoring
# (noniterative.cpp:73)
MAX_DISTANCE_FOR_COMPARISON = 1e6

# all 8 sign matrices diag(s), s in {+1,-1}^3
_SIGNS = jnp.array(
    [[sx, sy, sz] for sx in (1.0, -1.0) for sy in (1.0, -1.0)
     for sz in (1.0, -1.0)],
    dtype=jnp.float32,
)  # f32[8, 3]

# eigengap below this fraction of the largest eigenvalue counts as
# degenerate (rotationally near-symmetric cloud): the scatter
# eigenvectors within the tied subspace are then numerically arbitrary
# and the 4-candidate sign enumeration is insufficient.  The reference's K random permutations (noniterative.cpp:
# 57-200) only re-roll the arbitrary basis — they do not search the
# in-plane angle either, so it fails these clouds outright.
DEGENERATE_GAP_THRESHOLD = 0.05


def spectrum_gaps(points: "np.ndarray", sample: int = 16384):
    """Host-side pre-pass (numpy): relative eigengaps
    ``((l1-l2)/l1, (l2-l3)/l1)`` of the centered scatter of ``points``
    (subsampled for O(1) cost at any cloud size)."""
    import numpy as np

    pts = np.asarray(points, np.float64)
    if len(pts) > sample:
        pts = pts[:: len(pts) // sample + 1]
    if len(pts) < 4:
        return 1.0, 1.0  # too few points to call anything degenerate
    mu = pts.mean(axis=0)
    xc = pts - mu
    evals = np.linalg.eigvalsh(xc.T @ xc)[::-1]  # descending
    lam1 = max(float(evals[0]), 1e-30)
    return (
        float(evals[0] - evals[1]) / lam1,
        float(evals[1] - evals[2]) / lam1,
    )


def degenerate_axes_for(
    before_points: "np.ndarray",
    after_points: "np.ndarray",
    threshold: float = DEGENERATE_GAP_THRESHOLD,
):
    """Which principal-basis axes need in-plane candidate widening:
    axis 0 when the (l2, l3) pair ties (rotation within the e2/e3 plane
    is unresolved — cylinders), axis 2 when (l1, l2) ties.  Empty tuple
    = non-degenerate, no widening needed."""
    g12b, g23b = spectrum_gaps(before_points)
    g12a, g23a = spectrum_gaps(after_points)
    axes = []
    if min(g23b, g23a) < threshold:
        axes.append(0)
    if min(g12b, g12a) < threshold:
        axes.append(2)
    return tuple(axes)


def _rot_about_axis(axis: int, thetas: jnp.ndarray) -> jnp.ndarray:
    """f32[K, 3, 3] rotations by ``thetas`` about basis axis ``axis``
    (the rotation acts within the other two coordinates' plane)."""
    k = thetas.shape[0]
    c, s = jnp.cos(thetas), jnp.sin(thetas)
    i, j = [a for a in range(3) if a != axis]
    out = jnp.zeros((k, 3, 3), jnp.float32)
    out = out.at[:, axis, axis].set(1.0)
    out = out.at[:, i, i].set(c)
    out = out.at[:, j, j].set(c)
    out = out.at[:, i, j].set(-s)
    out = out.at[:, j, i].set(s)
    return out


def masked_centroid(points: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    total = jnp.maximum(jnp.sum(mask), 1.0)
    return jnp.sum(points * mask[:, None], axis=0) / total


def principal_axes(
    points: jnp.ndarray, mask: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Left singular basis of the centered 3xN cloud matrix, descending.

    Computed as eigh of the 3x3 scatter ``C = X_c^T X_c`` — one contraction
    over N instead of a tall-matrix SVD (the reference's cloud-size gesvd,
    ``parallelsvdhelper.cu:60-79``).  Returns (U f32[3,3] columns = axes,
    eigenvalues f32[3] descending).
    """
    mu = masked_centroid(points, mask)
    xc = (points - mu) * mask[:, None]
    c = jnp.einsum("nr,nc->rc", xc, xc, precision=jax.lax.Precision.HIGHEST)
    evals, evecs = jnp.linalg.eigh(c)  # ascending
    return evecs[:, ::-1], evals[::-1]


class _Candidates(NamedTuple):
    rotations: jnp.ndarray  # f32[8, 3, 3]
    translations: jnp.ndarray  # f32[8, 3]
    proper: jnp.ndarray  # bool[8] — det(R) == +1


def _enumerate_candidates(
    u_before: jnp.ndarray,
    u_after: jnp.ndarray,
    mu_before: jnp.ndarray,
    mu_after: jnp.ndarray,
    degenerate_angles: int = 0,
    degenerate_axes: Tuple[int, ...] = (),
) -> _Candidates:
    # R_s = U_a diag(s) A U_b^T with A = in-basis rotation; the base set
    # is A = I (det(R) = prod(s) det(U_a) det(U_b), det(A) = 1).  When a
    # degenerate eigenspace makes U_b/U_a's in-plane basis arbitrary,
    # the sign set is widened with rotations about the gap axis —
    # ``degenerate_angles`` samples per axis in ``degenerate_axes``.
    mats = [jnp.eye(3, dtype=jnp.float32)[None]]
    if degenerate_angles > 1 and degenerate_axes:
        thetas = (
            jnp.arange(1, degenerate_angles, dtype=jnp.float32)
            * jnp.float32(2.0 * jnp.pi / degenerate_angles)
        )
        for ax in degenerate_axes:
            mats.append(_rot_about_axis(ax, thetas))
    a_stack = jnp.concatenate(mats, axis=0)  # f32[W, 3, 3]
    hi = jax.lax.Precision.HIGHEST
    rots = jnp.einsum(
        "rk,sk,wkl,cl->swrc", u_after, _SIGNS, a_stack, u_before,
        precision=hi,
    ).reshape(-1, 3, 3)
    det_pair = jnp.linalg.det(u_after) * jnp.linalg.det(u_before)
    dets = jnp.repeat(
        jnp.prod(_SIGNS, axis=1) * det_pair, a_stack.shape[0]
    )
    trans = mu_after[None, :] - jnp.einsum(
        "src,c->sr", rots, mu_before, precision=hi
    )
    return _Candidates(rotations=rots, translations=trans, proper=dets > 0)


def _approximated_errors(
    cands: _Candidates,
    centered_before: jnp.ndarray,
    centered_after: jnp.ndarray,
    pair_mask: jnp.ndarray,
) -> jnp.ndarray:
    """The reference's crude per-candidate score (``noniterative.cpp:53``):
    MSE of rotated centered-before vs centered-after in index order, over the
    first min(N, M) rows.  Only meaningful relative to other candidates."""
    n_pairs = jnp.maximum(jnp.sum(pair_mask), 1.0)

    def one(r):
        diff = (
            transform_points(centered_before, r, jnp.zeros(3, r.dtype))
            - centered_after
        ) * pair_mask[:, None]
        return jnp.sum(diff * diff) / n_pairs

    return jax.vmap(one)(cands.rotations)


def _exact_errors(
    cands: _Candidates,
    subcloud: jnp.ndarray,
    sub_mask: jnp.ndarray,
    after: Cloud,
    use_pallas=None,
) -> jnp.ndarray:
    """Exact rescore (``noniterative.cpp:91-96``): transform the subcloud,
    NN-match against the full after cloud, correspondence MSE.

    All candidates' transformed subclouds are flattened into ONE NN call —
    one kernel launch, and no vmap-of-pallas lowering (the subcloud row
    count is lane-aligned by the caller)."""
    c = cands.rotations.shape[0]
    k = subcloud.shape[0]
    transformed = (
        jnp.einsum(
            "crk,nk->cnr", cands.rotations, subcloud,
            precision=jax.lax.Precision.HIGHEST,
        )
        + cands.translations[:, None, :]
    )  # [C, k, 3]
    _, dist = nearest_neighbors(
        transformed.reshape(c * k, 3), after.points, after.count,
        use_pallas=use_pallas,
    )
    dist = dist.reshape(c, k)
    w = jnp.logical_and(
        dist < MAX_DISTANCE_FOR_COMPARISON, sub_mask[None, :] > 0
    ).astype(jnp.float32)
    return jnp.sum(dist * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)


@partial(
    jax.jit,
    static_argnames=(
        "approximation_type", "subcloud_size", "use_pallas",
        "degenerate_angles", "degenerate_axes",
    ),
)
def nicp_register(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    subcloud_size: int = 1000,
    seed: int = 0,
    use_pallas=None,
    degenerate_angles: int = 0,
    degenerate_axes: Tuple[int, ...] = (),
) -> RegistrationResult:
    """One-shot registration of ``before`` onto ``after``.

    Returns the best candidate transform, the number of candidates scored
    (the analog of the reference's ``repetitions`` out-param) and its exact
    or approximated error per the mode semantics above.

    ``degenerate_angles``/``degenerate_axes`` (static; see
    ``degenerate_axes_for`` for the host-side auto pre-pass) widen the
    candidate set with in-plane rotations when the inertia spectrum is
    (near-)degenerate — rotationally symmetric-ish clouds, where the
    eigenvectors within the tied subspace are arbitrary and neither the
    4-candidate enumeration nor the reference's random-permutation
    jitter (``noniterative.cpp:57-200``) can resolve the in-plane
    angle.  The angle grid seeds within ~(180/angles) degrees; a short
    subcloud NN + Procrustes polish then snaps the winner to the exact
    transform (extension — the reference has no working counterpart on
    these clouds)."""
    mask_b = before.mask()
    mask_a = after.mask()
    mu_b = masked_centroid(before.points, mask_b)
    mu_a = masked_centroid(after.points, mask_a)
    u_b, _ = principal_axes(before.points, mask_b)
    u_a, _ = principal_axes(after.points, mask_a)
    widened = degenerate_angles > 1 and len(degenerate_axes) > 0
    cands = _enumerate_candidates(
        u_b, u_a, mu_b, mu_a,
        degenerate_angles=degenerate_angles,
        degenerate_axes=degenerate_axes,
    )

    # subcloud of before for exact scoring (common.cpp:25-37): random valid
    # rows; if the cloud is smaller than subcloud_size the whole cloud is
    # used and the shortfall is weight-masked out.  The row count is
    # rounded up to the padding granule (``LANE``); rows beyond the
    # requested size carry zero weight, preserving the exact
    # subcloud-size semantics.
    k_req = min(subcloud_size, before.padded_size)
    k = min(round_up(k_req, LANE), before.padded_size)
    key = jax.random.PRNGKey(seed)
    scores = jax.random.uniform(key, (before.padded_size,))
    scores = jnp.where(mask_b > 0, scores, -1.0)  # invalid rows lose
    # top_k beats a full argsort (O(N log k) vs O(N log^2 N) bitonic) —
    # at 1M points the argsort dominated the whole NICP run
    _, order = jax.lax.top_k(scores, k)
    subcloud = before.points[order]
    sub_mask = mask_b[order] * (
        jnp.arange(k, dtype=jnp.int32) < k_req
    ).astype(jnp.float32)

    improper_penalty = jnp.where(cands.proper, 0.0, BIG)

    def crude_scores():
        # the reference's crude index-order score (noniterative.cpp:53)
        centered_b = (before.points - mu_b) * mask_b[:, None]
        centered_a = (after.points - mu_a) * mask_a[:, None]
        n_pair = jnp.minimum(before.count, after.count)
        pair_mask = (
            jnp.arange(before.padded_size, dtype=jnp.int32) < n_pair
        ).astype(jnp.float32)
        # truncate/pad the after side to the before size for index pairing
        m = before.padded_size
        ca = (
            centered_a[:m]
            if centered_a.shape[0] >= m
            else jnp.pad(centered_a, ((0, m - centered_a.shape[0]), (0, 0)))
        )
        return (
            _approximated_errors(cands, centered_b, ca, pair_mask)
            + improper_penalty
        )

    if approximation_type == ApproximationType.Full and not widened:
        # rank by crude score, exactly rescore only the winner
        best_by_approx = jnp.argmin(crude_scores())
        one = _Candidates(
            rotations=cands.rotations[best_by_approx][None],
            translations=cands.translations[best_by_approx][None],
            proper=cands.proper[best_by_approx][None],
        )
        exact = _exact_errors(one, subcloud, sub_mask, after, use_pallas)
        rotation = one.rotations[0]
        translation = one.translations[0]
        error = exact[0]
    else:
        # None: exact-score every candidate (noniterative.cpp:224-236);
        # non-widened Hybrid: top-5 by approx rescored — with 4 proper
        # candidates the rescored set is the full set, so both modes
        # score all candidates.
        # WIDENED (any mode): the crude index-order score physically
        # cannot rank the in-plane angle — on a (near-)rotationally
        # symmetric cloud with shuffled index pairing the cross term
        # vanishes, so the score is ~constant in theta (measured: a
        # crude-ranked top-5 picked a flipped solution) — so every
        # widened candidate is scored exactly.
        exact = _exact_errors(cands, subcloud, sub_mask, after, use_pallas)
        exact = exact + improper_penalty
        best = jnp.argmin(exact)
        rotation = cands.rotations[best]
        translation = cands.translations[best]
        error = exact[best]

    if widened:
        # hierarchical angle refinement: the winning in-plane angle is
        # only exact to the 2pi/angles grid, and on (near-)symmetric
        # shapes an NN+Procrustes polish STALLS — the symmetric bulk's
        # correspondences are satisfied at ANY angle, so its pull
        # cancels the asymmetric features' (measured: a 3-iteration
        # polish plateaus ~6 deg off).  The exact subcloud NN score has
        # no such blind spot: it keeps ranking the true angle best down
        # to roughly the features' own angular width, so two rounds of
        # 17-sample rescored grids about the winner (spacing /8 per
        # round) resolve the angle to ~0.35 deg per degenerate axis.
        hi = jax.lax.Precision.HIGHEST

        def rodrigues(axis_vec, thetas):
            a = axis_vec / jnp.linalg.norm(axis_vec)
            kmat = jnp.array(
                [[0.0, -a[2], a[1]],
                 [a[2], 0.0, -a[0]],
                 [-a[1], a[0], 0.0]],
                jnp.float32,
            )
            c = jnp.cos(thetas)[:, None, None]
            s = jnp.sin(thetas)[:, None, None]
            eye = jnp.eye(3, dtype=jnp.float32)
            return eye[None] + s * kmat[None] + (1.0 - c) * (
                jnp.matmul(kmat, kmat, precision=hi)
            )[None]

        span = 2.0 * jnp.pi / degenerate_angles
        for _level in range(2):
            for ax in degenerate_axes:
                deltas = jnp.linspace(
                    -span / 2, span / 2, 17, dtype=jnp.float32
                )
                # right-composition = rotate about BEFORE's degenerate
                # eigen-axis: R(d) = R @ Rot(u_b[:, ax], d)
                rots = jnp.einsum(
                    "rc,kcl->krl", rotation,
                    rodrigues(u_b[:, ax], deltas), precision=hi,
                )
                trs = mu_a[None, :] - jnp.einsum(
                    "krc,c->kr", rots, mu_b, precision=hi
                )
                grid = _Candidates(
                    rotations=rots,
                    translations=trs,
                    proper=jnp.ones((17,), bool),
                )
                sc = _exact_errors(
                    grid, subcloud, sub_mask, after, use_pallas
                )
                b = jnp.argmin(sc)
                rotation, translation = rots[b], trs[b]
            span = span / 8.0

        # final short NN + Procrustes polish: from a sub-degree start
        # the features' correspondences are locked, so this absorbs the
        # residual translation/off-axis error without the stall above
        def polish_step(carry, _):
            rot, tr = carry
            moved = transform_points(subcloud, rot, tr)
            idx, dist = nearest_neighbors(
                moved, after.points, after.count, use_pallas=use_pallas
            )
            w = jnp.logical_and(
                dist < MAX_DISTANCE_FOR_COMPARISON, sub_mask > 0
            ).astype(jnp.float32)
            from tpuslam.ops.procrustes import weighted_procrustes

            r_s, t_s = weighted_procrustes(moved, after.points[idx], w)
            return (
                jnp.matmul(r_s, rot, precision=hi),
                jnp.matmul(r_s, tr, precision=hi) + t_s,
            ), None

        (rotation, translation), _ = jax.lax.scan(
            polish_step, (rotation, translation), None, length=3
        )
        one = _Candidates(
            rotations=rotation[None],
            translations=translation[None],
            proper=jnp.asarray([True]),
        )
        error = _exact_errors(
            one, subcloud, sub_mask, after, use_pallas
        )[0]

    n_scored = jnp.sum(cands.proper.astype(jnp.int32))
    return RegistrationResult(
        transform=RigidTransform(
            rotation=rotation,
            translation=translation,
            scale=jnp.float32(1.0),
        ),
        iterations=n_scored,
        error=error,
    )
