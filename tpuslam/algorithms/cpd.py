"""Coherent Point Drift — rigid GMM/EM registration (Myronenko & Song).

Capability equivalent of the reference's CPD (CPU
``coherentpointdrift.cpp``, GPU ``cpdcuda.cu``), redesigned so that the
whole EM optimization is ONE jitted ``lax.while_loop`` — the reference's
GPU E-step launches O(N) kernels from a host loop (``cpdcuda.cu:104-116``)
and its FGT path round-trips the entire E-step through the CPU
(``cpdcuda.cu:150-170``); here nothing leaves the device.

The N x M responsibility matrix is never materialized: the E-step streams
target tiles through a blocked ``exp(-d^2 / 2 sigma^2)`` evaluation and
accumulates only the sufficient statistics ``p1 = P 1`` (M), ``pt1 = P^T 1`` (N), ``px = P X`` (M, 3) and
the log-likelihood — exactly the reference's memory strategy
(``cudaprobabilities.h:19-30``) with the tiling done on-device.  Raw
``exp`` is numerically safe here: exponents are <= 0 so overflow is
impossible, and underflow to zero is the correct limit (the denominator is
floored by the uniform-component constant, ``coherentpointdrift.cpp:204``).

Semantics matched to the reference (parser truth):

* ``sigma^2`` init ``= sum_ij |b_i - a_j|^2 / (3 N M)``
  (``coherentpointdrift.cpp:126-139``) — computed in closed form
  (``N sum|b|^2 + M sum|a|^2 - 2 sum b . sum a``) instead of an O(NM) pass.
* Uniform-component constant: the exact E-step uses
  ``c = (2 pi sigma0^2)^1.5 w M / ((1-w) N)`` computed ONCE from the
  *initial* sigma^2 (``coherentpointdrift.cpp:96``); the FGT path
  recomputes it from the *current* sigma^2 every call
  (``cpdutils.cpp:44``).  Both behaviors preserved per mode.
* Weight clamped to (1e-6, 1 - 1e-6) (``coherentpointdrift.cpp:91-94``).
* Loop: ``iter < max_iterations && ntol > tolerance && sigma^2 > eps`` with
  ``ntol = |(L - L_prev)/L|`` (``coherentpointdrift.cpp:104-113``); a
  missing ``max-iterations`` maps to -1 and the loop never runs (identity
  result) — reproduced.
* M-step (``coherentpointdrift.cpp:223-278``): weighted centroids,
  ``A = px^T B - Np mu_a mu_b^T``, det-corrected 3x3 SVD, optional scale
  ``tr(S D)/denominator``, sigma^2 update with const-scale and free-scale
  branches, ``t = mu_a - s R mu_b``.  Returned rotation is ``scale * R``
  (``coherentpointdrift.cpp:123``).
* Approximation ladder (``coherentpointdrift.cpp:140-165``): ``None`` =
  exact; ``Full`` = sigma^2 floored at 0.05, fast path; ``Hybrid`` = fast
  path while ``sigma^2 > 0.015 sigma0^2`` else exact with truncation 1e-3
  (responsibilities with log-exponent below log(1e-3) dropped,
  ``coherentpointdrift.cpp:191-196``).  The reference's fast path IS the
  Fast Gauss Transform (``fgt.cpp``); here the fast-phase E-step is
  picked by a size crossover (``CPD_FGT_CROSSOVER``): the exact blocked
  E-step with FGT-mode *constant* semantics below it (the O(N*M) pass
  beats the approximation's fixed clustering/expansion cost at small
  sizes), the device FGT (``tpuslam.ops.fgt``) at or above it, where the
  quadratic pass loses to the ~linear FGT.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from tpuslam.algorithms.icp import RegistrationResult
from tpuslam.config.configuration import ApproximationType
from tpuslam.core.types import Cloud, RigidTransform, pick_block
from tpuslam.ops.geometry import transform_points

_TWO_PI = 2.0 * math.pi

# Exact-vs-FGT fast-phase crossover (padded rows): the exact blocked
# E-step is O(N*M) while the device FGT is ~O((N+M)*K*P), so at or above
# this size the Full/Hybrid wide-sigma^2 iterations run the FGT — the
# reference's ladder (coherentpointdrift.cpp:141-166, cpdutils.cpp:19-73
# run FGT for ALL fast-phase E-steps) — and below it the exact pass.
# The value was carried over from an earlier platform and has not been
# measured on the GPU yet; it stays as the path selector until a GPU
# measurement moves it (ROADMAP, Speed).
CPD_FGT_CROSSOVER = 74_018


def resolve_use_fgt(
    use_fgt: Optional[bool],
    approximation_type: "ApproximationType",
    m_pad: int,
    n_pad: int,
) -> bool:
    """Tri-state ``use_fgt`` dispatch: ``True``/``False`` are explicit
    overrides; ``None`` (auto, the default) picks FGT for the Full/
    Hybrid fast phase when the problem is at or past the crossover
    size.  Exact mode (``NONE``) never uses FGT — the
    reference has no such path either."""
    if use_fgt is not None:
        return bool(use_fgt)
    if approximation_type == ApproximationType.NONE:
        return False
    return max(int(m_pad), int(n_pad)) >= CPD_FGT_CROSSOVER


class Sufficient(NamedTuple):
    """E-step sufficient statistics (the reference's ``Probabilities``,
    ``cudaprobabilities.h:7-31``)."""

    p1: jnp.ndarray  # f32[M]   P @ 1
    pt1: jnp.ndarray  # f32[N]  P^T @ 1
    px: jnp.ndarray  # f32[M,3] P @ X
    error: jnp.ndarray  # f32[]  negative log-likelihood


def sigma_squared_init(
    moving: jnp.ndarray,
    moving_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
) -> jnp.ndarray:
    """Closed form of ``CalculateSigmaSquared`` (``coherentpointdrift.cpp:
    126-139``): sum_ij |b_i - a_j|^2 = N_a sum|b|^2 + N_b sum|a|^2
    - 2 (sum b).(sum a), masked."""
    nb = jnp.sum(moving_mask)
    na = jnp.sum(target_mask)
    sb2 = jnp.sum(jnp.sum(moving * moving, -1) * moving_mask)
    sa2 = jnp.sum(jnp.sum(target * target, -1) * target_mask)
    sb = jnp.sum(moving * moving_mask[:, None], axis=0)
    sa = jnp.sum(target * target_mask[:, None], axis=0)
    total = na * sb2 + nb * sa2 - 2.0 * jnp.dot(
        sb, sa, precision=jax.lax.Precision.HIGHEST
    )
    return total / (3.0 * nb * na)


def uniform_constant(
    sigma2: jnp.ndarray, weight: jnp.ndarray, m: jnp.ndarray, n: jnp.ndarray
) -> jnp.ndarray:
    """``(2 pi sigma^2)^{3/2} w M / ((1-w) N)``
    (``coherentpointdrift.cpp:96``, ``cpdutils.cpp:44``)."""
    return (
        jnp.power(_TWO_PI * sigma2, 1.5) * weight * m / ((1.0 - weight) * n)
    )


def cpd_estep(
    transformed: jnp.ndarray,
    moving_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    sigma2: jnp.ndarray,
    constant: jnp.ndarray,
    trunc_active: jnp.ndarray,
    truncate: float = 1e-3,
) -> Sufficient:
    """Blocked exact E-step (``ComputePMatrix``,
    ``coherentpointdrift.cpp:167-221``), streaming target tiles.

    ``trunc_active`` (traced bool): drop responsibilities whose exponent is
    below ``log(truncate)`` — branchless equivalent of the ``doTruncate``
    path (``coherentpointdrift.cpp:191-196``).
    """
    m = transformed.shape[0]
    n = target.shape[0]
    tile = pick_block(n)
    multiplier = -0.5 / sigma2
    log_trunc = jnp.float32(math.log(truncate))

    tiles_x = target.reshape(n // tile, tile, 3)
    tiles_mask = target_mask.reshape(n // tile, tile)

    def step(carry, inp):
        p1, px, err = carry
        xt, mt = inp  # f32[tile,3], f32[tile]
        # exact per-coordinate form: the |y|^2+|x|^2-2yx expansion
        # cancels once 2 sigma^2 is small next to the norms
        d2 = (transformed[:, 0:1] - xt[:, 0][None, :]) ** 2
        d2 += (transformed[:, 1:2] - xt[:, 1][None, :]) ** 2
        d2 += (transformed[:, 2:3] - xt[:, 2][None, :]) ** 2
        expo = multiplier * d2
        g = jnp.exp(expo) * moving_mask[:, None]
        g = jnp.where(
            jnp.logical_and(trunc_active, expo < log_trunc), 0.0, g
        )
        denom = jnp.sum(g, axis=0) + constant  # f32[tile]
        pt1_t = (1.0 - constant / denom) * mt
        pn = (g / denom[None, :]) * mt[None, :]
        p1 = p1 + jnp.sum(pn, axis=1)
        px = px + jnp.dot(pn, xt, precision=jax.lax.Precision.HIGHEST)
        err = err - jnp.sum(jnp.log(denom) * mt)
        return (p1, px, err), pt1_t

    init = (
        jnp.zeros((m,), jnp.float32),
        jnp.zeros((m, 3), jnp.float32),
        jnp.float32(0.0),
    )
    (p1, px, err), pt1_tiles = jax.lax.scan(step, init, (tiles_x, tiles_mask))
    n_valid = jnp.sum(target_mask)
    err = err + 3.0 * n_valid * jnp.log(sigma2) / 2.0
    return Sufficient(p1=p1, pt1=pt1_tiles.reshape(n), px=px, error=err)


def cpd_estep_auto(*args, use_pallas=None) -> Sufficient:
    """Dispatching front: the two-pass Triton kernel on the GPU, the
    blocked jnp scan on the CPU (``tpuslam.core.device.select``).  Both
    batch under ``jax.vmap``."""
    from tpuslam.core.device import select
    from tpuslam.kernels import pallas_cpd

    return select(pallas_cpd.cpd_estep_pallas, cpd_estep, use_pallas)(*args)


def cpd_estep_fgt(
    transformed: jnp.ndarray,
    moving_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    sigma2: jnp.ndarray,
    weight: jnp.ndarray,
    m: jnp.ndarray,
    n: jnp.ndarray,
    fgt_k: int,
    fgt_p: int,
    ratio_of_far_field: float,
    sigma2_init: jnp.ndarray | None = None,
    clusters=None,
) -> Sufficient:
    """FGT-approximated E-step (``ComputePMatrixWithFGT``,
    ``cpdutils.cpp:19-73``): five Gauss transforms — Kt1 for the
    denominators, then p1 and the three px columns with 1/denominator
    weights — batched into one clustering + one 4-weight expansion (the
    clustering is weight-independent; see ``tpuslam.ops.fgt``).

    ``fgt_k`` is the static center-count cap; when ``sigma2_init`` is
    given, the live count follows the reference's per-iteration resize
    ``K = min(N, M, 50 + sigma0^2/sigma^2)`` (``cpdutils.cpp:35``) via
    runtime masking in ``k_center`` (clusters past the live count get no
    assignments and zero expansion weight).

    ``clusters``: precomputed ``(centers_y, indx_y, centers_x, indx_x)``
    — the EM loop's cross-iteration clustering cache (``cpd_register``
    transforms the cached moving-side centers instead of re-selecting;
    see ``ops.fgt.compute_fgt_model_multi``).  The cached path always
    uses all ``fgt_k`` centers — a strictly TIGHTER approximation than
    the reference's adaptive live count, which exists to bound its CPU
    cost, not its accuracy.
    """
    from tpuslam.ops.fgt import (
        FGTModel,
        compute_fgt_model_multi,
        fgt_predict,
        fgt_predict_multi,
    )

    if sigma2_init is not None and clusters is None:
        k_rt = jnp.minimum(
            jnp.minimum(m, n),
            50.0 + sigma2_init / jnp.maximum(sigma2, 1e-20),
        ).astype(jnp.int32)
        k_rt = jnp.clip(k_rt, 1, fgt_k)
    else:
        k_rt = None
    cl_y = cl_x = None
    if clusters is not None:
        cl_y = (clusters[0], clusters[1])
        cl_x = (clusters[2], clusters[3])
    hsigma = jnp.sqrt(2.0 * sigma2)
    model_y = compute_fgt_model_multi(
        transformed, moving_mask[:, None], moving_mask, hsigma, fgt_k,
        fgt_p, k_rt, clustering=cl_y,
    )
    kt1 = fgt_predict(
        target,
        FGTModel(centers=model_y.centers, ak=model_y.ak[..., 0]),
        hsigma, ratio_of_far_field, fgt_p,
    )
    ndi = uniform_constant(sigma2, weight, m, n)
    denom = jnp.maximum(kt1, 0.0) + ndi  # FGT can dip slightly negative
    inv_denom = target_mask / denom
    pt1 = (1.0 - ndi / denom) * target_mask

    # one 4-weight model on the target: [1/denom, x/denom, y/denom, z/denom]
    weights4 = jnp.concatenate(
        [inv_denom[:, None], target * inv_denom[:, None]], axis=1
    )
    model_x = compute_fgt_model_multi(
        target, weights4, target_mask, hsigma, fgt_k, fgt_p, k_rt,
        clustering=cl_x,
    )
    out = fgt_predict_multi(
        transformed, model_x, hsigma, ratio_of_far_field, fgt_p
    )
    p1 = out[:, 0] * moving_mask
    px = out[:, 1:4] * moving_mask[:, None]

    err = -jnp.sum(jnp.log(denom) * target_mask)
    err = err + 3.0 * jnp.sum(target_mask) * jnp.log(sigma2) / 2.0
    return Sufficient(p1=p1, pt1=pt1, px=px, error=err)


class MStepResult(NamedTuple):
    rotation: jnp.ndarray
    translation: jnp.ndarray
    scale: jnp.ndarray
    sigma2: jnp.ndarray


def mstep_from_moments(
    np_: jnp.ndarray,
    mu_b: jnp.ndarray,
    mu_a: jnp.ndarray,
    a_mat: jnp.ndarray,
    sigma_sub: jnp.ndarray,
    scale_den: jnp.ndarray,
    const_scale: bool,
    prev_scale: jnp.ndarray,
) -> MStepResult:
    """The moment->transform core of the M-step (``MStep``,
    ``coherentpointdrift.cpp:241-278``): det-corrected 3x3 SVD of
    ``A = px^T B - Np mu_a mu_b^T``, scale ``tr(S D)/denominator`` and the
    sigma^2 update.  Shared by the single-device M-step (from Sufficient
    arrays) and the sharded M-step (from psum'd partial moments)."""
    inv_np = 1.0 / np_
    u, sv, vt = jnp.linalg.svd(a_mat, full_matrices=False)
    det_uv = jnp.linalg.det(jnp.matmul(u, vt, precision=jax.lax.Precision.HIGHEST))
    d = jnp.array([1.0, 1.0, 0.0], a_mat.dtype) + jnp.array(
        [0.0, 0.0, 1.0], a_mat.dtype
    ) * det_uv
    r = jnp.matmul(u * d[None, :], vt, precision=jax.lax.Precision.HIGHEST)
    # tr(S diag(1,1,det(UV^T)))  (coherentpointdrift.cpp:258-260)
    scale_num = sv[0] + sv[1] + det_uv * sv[2]

    if const_scale:
        scale = prev_scale
        sigma2 = (
            inv_np * jnp.abs(sigma_sub + scale_den - 2.0 * scale_num) / 3.0
        )
    else:
        scale = scale_num / scale_den
        sigma2 = inv_np * jnp.abs(sigma_sub - scale * scale_num) / 3.0

    t = mu_a - scale * jnp.matmul(r, mu_b, precision=jax.lax.Precision.HIGHEST)
    return MStepResult(rotation=r, translation=t, scale=scale, sigma2=sigma2)


def cpd_mstep(
    moving: jnp.ndarray,
    target: jnp.ndarray,
    stats: Sufficient,
    const_scale: bool,
    prev_scale: jnp.ndarray,
) -> MStepResult:
    """Closed-form rigid M-step (``MStep``, ``coherentpointdrift.cpp:
    223-278``) — a handful of einsums and a 3x3 SVD (the reference burns
    ~210 lines of cuBLAS/cuSOLVER plumbing on this, ``cpdcuda.cu:172-300``).

    Masking note: padded rows have ``p1 = 0`` / ``pt1 = 0`` by E-step
    construction, so every sum here is already mask-clean.
    """
    np_ = jnp.sum(stats.p1)
    inv_np = 1.0 / np_
    hi = jax.lax.Precision.HIGHEST
    mu_b = inv_np * jnp.einsum("m,mr->r", stats.p1, moving, precision=hi)
    mu_a = inv_np * jnp.einsum("n,nr->r", stats.pt1, target, precision=hi)

    # A = px^T B - Np mu_a mu_b^T   (coherentpointdrift.cpp:240)
    a_mat = (
        jnp.einsum(
            "mr,mc->rc", stats.px, moving, precision=hi,
        )
        - np_ * jnp.outer(mu_a, mu_b)
    )
    sigma_sub = (
        jnp.sum(stats.pt1 * jnp.sum(target * target, -1))
        - np_ * jnp.dot(mu_a, mu_a, precision=hi)
    )
    scale_den = (
        jnp.sum(stats.p1 * jnp.sum(moving * moving, -1))
        - np_ * jnp.dot(mu_b, mu_b, precision=hi)
    )
    return mstep_from_moments(
        np_, mu_b, mu_a, a_mat, sigma_sub, scale_den, const_scale,
        prev_scale,
    )


class CPDState(NamedTuple):
    rotation: jnp.ndarray
    translation: jnp.ndarray
    scale: jnp.ndarray
    sigma2: jnp.ndarray
    log_likelihood: jnp.ndarray
    ntol: jnp.ndarray
    iterations: jnp.ndarray


class CPDResume(NamedTuple):
    """Warm-start carry for chunked dispatch (``cpd_register_chunked``):
    the FULL EM loop state at an iteration boundary — everything the
    while_loop would hold had it continued (sigma2_0 / t0 / c_init are
    pure functions of the unchanged inputs and are recomputed
    identically) — plus the iterations already done (verbose loop_nr
    and history-slot continuity)."""

    rotation: jnp.ndarray  # f32[3,3]
    translation: jnp.ndarray  # f32[3]
    scale: jnp.ndarray  # f32[]
    sigma2: jnp.ndarray  # f32[]
    log_likelihood: jnp.ndarray  # f32[]
    ntol: jnp.ndarray  # f32[]
    done_before: int = 0


@partial(
    jax.jit,
    static_argnames=(
        "const_scale", "approximation_type", "use_fgt",
        "order_of_truncation", "fgt_k", "verbose", "record_history",
        "history_length", "use_pallas", "centroid_init",
    ),
)
def cpd_register(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    weight: float = 0.3,
    const_scale: bool = False,
    max_iterations: int = -1,
    tolerance: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    ratio_of_far_field: float = 10.0,
    order_of_truncation: int = 8,
    use_fgt: Optional[bool] = None,
    # cap >= 50 + 1/0.015 so the adaptive live count (cpdutils.cpp:35)
    # is never clipped during the Hybrid FGT phase
    fgt_k: int = 128,
    verbose: bool = False,
    record_history: bool = False,
    history_length: int = 256,
    use_pallas=None,
    centroid_init: bool = False,
    resume: Optional[CPDResume] = None,
) -> RegistrationResult:
    """Register ``before`` (the moving GMM centroids) onto ``after``.

    ``use_fgt`` picks the Full/Hybrid fast-phase E-step.  ``None``
    (auto, the default) applies the size crossover
    (``CPD_FGT_CROSSOVER``): below it the exact blocked E-step with
    FGT-mode constant semantics; at or above it the reference's
    actual Fast Gauss Transform (``tpuslam.ops.fgt``, with ``fgt_k``
    centers, truncation order ``order_of_truncation`` and far-field
    radius ``ratio_of_far_field``, ``cpdutils.cpp:33-36``) — exactly
    the ladder the reference prescribes
    (``coherentpointdrift.cpp:141-166``).  ``True``/``False`` force
    one arm.

    ``centroid_init=True`` starts EM from the centroid-difference
    translation instead of zero (and computes sigma^2_0 from the
    pre-aligned clouds).  Off by default for reference parity
    (``coherentpointdrift.cpp`` always starts from identity); it rescues
    the free-scale mode at large translations, where a zero start lets
    the first M-step collapse ``scale`` toward 0 (near-uniform
    responsibilities make the cross-covariance vanish) and EM stalls in
    that degenerate optimum.
    """
    use_fgt = resolve_use_fgt(
        use_fgt, approximation_type, before.padded_size, after.padded_size
    )
    moving = before.points
    target = after.points
    mask_b = before.mask()
    mask_a = after.mask()
    m = jnp.sum(mask_b)
    n = jnp.sum(mask_a)

    weight = jnp.clip(jnp.float32(weight), 1e-6, 1.0 - 1e-6)
    eps = jnp.float32(eps)
    tolerance = jnp.float32(tolerance)
    max_iterations = jnp.asarray(max_iterations, jnp.int32)

    if centroid_init:
        t0 = (
            jnp.sum(target * mask_a[:, None], axis=0) / n
            - jnp.sum(moving * mask_b[:, None], axis=0) / m
        )
        sigma2_0 = sigma_squared_init(moving + t0, mask_b, target, mask_a)
    else:
        t0 = jnp.zeros((3,), jnp.float32)
        sigma2_0 = sigma_squared_init(moving, mask_b, target, mask_a)
    c_init = uniform_constant(sigma2_0, weight, m, n)

    iter_offset = (
        jnp.int32(0) if resume is None
        else jnp.asarray(resume.done_before, jnp.int32)
    )

    def cond(s: CPDState):
        # non-finite sigma^2/ntol fail the comparisons and stop the loop
        # (fail-fast, SURVEY §5.3); jnp.isfinite guard kept explicit for
        # the log-likelihood which feeds ntol next iteration
        return jnp.logical_and(
            jnp.logical_and(
                s.iterations < max_iterations,
                jnp.isfinite(s.log_likelihood),
            ),
            jnp.logical_and(s.ntol > tolerance, s.sigma2 > eps),
        )

    # cross-iteration FGT clustering cache: the farthest-point
    # selection is 127 sequential O(N) argmax steps.  The target's
    # clustering is a constant of the run; the moving cloud's
    # ASSIGNMENTS are invariant under EM's similarity transforms
    # (uniform distance scaling preserves the pick order and
    # nearest-center partition), and its centers — segment means —
    # transform exactly with the cloud.  Selected ONCE here, outside
    # the loop.
    fgt_kk = min(fgt_k, before.padded_size, after.padded_size)
    will_fgt = use_fgt and approximation_type in (
        ApproximationType.Full, ApproximationType.Hybrid,
    )
    if will_fgt:
        from tpuslam.ops.fgt import k_center

        centers_y0, indx_y = k_center(moving, mask_b, fgt_kk)
        centers_x, indx_x = k_center(target, mask_a, fgt_kk)

    def fgt_stats(transformed, sigma_e, s: CPDState):
        centers_y = transform_points(
            centers_y0, s.rotation, s.translation, s.scale
        )
        return cpd_estep_fgt(
            transformed, mask_b, target, mask_a, sigma_e, weight, m, n,
            fgt_kk,
            order_of_truncation, ratio_of_far_field,
            sigma2_init=sigma2_0,
            clusters=(centers_y, indx_y, centers_x, indx_x),
        )

    # Hybrid with true FGT runs as specialized while_loops, one per
    # phase (see the loop construction below), instead of a
    # lax.cond-per-iteration body, so each iteration executes exactly
    # one E-step kind by construction.
    hybrid_split = (
        approximation_type == ApproximationType.Hybrid and use_fgt
    )

    def freeze(body_fn, cond_fn):
        # freeze finished problems for vmap (see icp.py body note)
        def wrapped(s: CPDState) -> CPDState:
            new_s = body_fn(s)
            keep = cond_fn(s)
            return jax.tree.map(
                lambda old, new: jnp.where(keep, new, old), s, new_s
            )

        return wrapped

    def _body(s: CPDState, fast_phase: bool = False) -> CPDState:
        transformed = transform_points(
            moving, s.rotation, s.translation, s.scale
        )

        if approximation_type == ApproximationType.NONE:
            stats = cpd_estep_auto(
                transformed, mask_b, target, mask_a, s.sigma2, c_init,
                jnp.asarray(False), use_pallas=use_pallas,
            )
        elif approximation_type == ApproximationType.Full:
            # sigma^2 floor (coherentpointdrift.cpp:152-155) and FGT-mode
            # constant from the *current* sigma^2 (cpdutils.cpp:44)
            sigma_e = jnp.maximum(s.sigma2, 0.05)
            if use_fgt:
                stats = fgt_stats(transformed, sigma_e, s)
            else:
                stats = cpd_estep_auto(
                    transformed, mask_b, target, mask_a, sigma_e,
                    uniform_constant(sigma_e, weight, m, n),
                    jnp.asarray(False), use_pallas=use_pallas,
                )
        elif hybrid_split:  # Hybrid (coherentpointdrift.cpp:157-164)
            if fast_phase is True:
                stats = fgt_stats(transformed, s.sigma2, s)
            elif fast_phase is False:
                stats = cpd_estep_auto(
                    transformed, mask_b, target, mask_a, s.sigma2,
                    c_init, jnp.asarray(True), use_pallas=use_pallas,
                )
            else:  # the multi-bounce fallback body (see loop build)
                stats = jax.lax.cond(
                    s.sigma2 > 0.015 * sigma2_0,
                    lambda: fgt_stats(transformed, s.sigma2, s),
                    lambda: cpd_estep_auto(
                        transformed, mask_b, target, mask_a, s.sigma2,
                        c_init, jnp.asarray(True),
                        use_pallas=use_pallas,
                    ),
                )
        else:  # Hybrid, exact blocked kernel both phases (below the
            # FGT crossover): one kernel, traced phase flag — no cond
            fast_now = s.sigma2 > 0.015 * sigma2_0
            c_used = jnp.where(
                fast_now,
                uniform_constant(s.sigma2, weight, m, n),
                c_init,
            )
            stats = cpd_estep_auto(
                transformed, mask_b, target, mask_a, s.sigma2, c_used,
                jnp.logical_not(fast_now), use_pallas=use_pallas,
            )
        return _finish(s, stats)

    def _finish(s: CPDState, stats: Sufficient) -> CPDState:
        ntol = jnp.abs((stats.error - s.log_likelihood) / stats.error)
        mres = cpd_mstep(moving, target, stats, const_scale, s.scale)
        if verbose:
            # the reference's per-iteration printf
            # (coherentpointdrift.cpp:121: "loop_nr %d, error: %f")
            jax.debug.print(
                "loop_nr {i}, error: {e}",
                i=s.iterations + 1 + iter_offset, e=mres.sigma2,
            )
        return CPDState(
            rotation=mres.rotation,
            translation=mres.translation,
            scale=mres.scale,
            sigma2=mres.sigma2,
            log_likelihood=stats.error,
            ntol=ntol,
            iterations=s.iterations + 1,
        )

    if resume is None:
        init = CPDState(
            rotation=jnp.eye(3, dtype=jnp.float32),
            translation=t0,
            scale=jnp.float32(1.0),
            sigma2=sigma2_0,
            log_likelihood=jnp.float32(0.0),
            ntol=tolerance + 10.0,
            iterations=jnp.int32(0),
        )
    else:
        # warm start at an EM iteration boundary: the resumed state IS
        # the while_loop carry (sigma2_0/t0/c_init above are recomputed
        # bit-identically from the unchanged inputs), so a chunked run
        # follows the unchunked trajectory step for step
        init = CPDState(
            rotation=jnp.asarray(resume.rotation, jnp.float32),
            translation=jnp.asarray(resume.translation, jnp.float32),
            scale=jnp.asarray(resume.scale, jnp.float32),
            sigma2=jnp.asarray(resume.sigma2, jnp.float32),
            log_likelihood=jnp.asarray(
                resume.log_likelihood, jnp.float32
            ),
            ntol=jnp.asarray(resume.ntol, jnp.float32),
            iterations=jnp.int32(0),
        )
    if hybrid_split:
        def fast_now(s):
            return s.sigma2 > 0.015 * sigma2_0

        def cond_fast(s):
            return jnp.logical_and(cond(s), fast_now(s))

        def cond_slow(s):
            return jnp.logical_and(
                cond(s), jnp.logical_not(fast_now(s))
            )

        # (cond, frozen body) per phase, run as a FLAT sequence of
        # top-level while_loops: fast, slow, fast, slow, then a
        # cond-body fallback.  The sequence covers any trajectory with
        # <= 2 phase flips exactly (sigma^2 is monotone decreasing in
        # every recorded trajectory — one flip); a pathological
        # multi-bounce run finishes in the fallback loop, whose body
        # re-evaluates the phase per iteration exactly like the
        # reference (coherentpointdrift.cpp:158-164).
        slow_arm = (
            cond_slow, freeze(partial(_body, fast_phase=False), cond_slow)
        )
        arms = [
            (cond_fast,
             freeze(partial(_body, fast_phase=True), cond_fast)),
            slow_arm,
            (cond_fast,
             freeze(partial(_body, fast_phase=True), cond_fast)),
            slow_arm,
            (cond, freeze(partial(_body, fast_phase=None), cond)),
        ]
    else:
        arms = [(cond, freeze(_body, cond))]

    if record_history:
        # per-iteration (sigma2, ntol, log-likelihood, scale) ring — the
        # reference's printf telemetry (coherentpointdrift.cpp:121) as
        # data (SURVEY §5.4: dump per-iteration state for debuggability)
        def with_hist(cond_fn, body_fn):
            def cond_h(carry):
                return cond_fn(carry[0])

            def body_h(carry):
                s, hist = carry
                new_s = body_fn(s)
                keep = cond_fn(s)
                row = jnp.stack(
                    [new_s.sigma2, new_s.ntol, new_s.log_likelihood,
                     new_s.scale]
                )
                # true ring: iteration i lands in slot i %
                # history_length, so a run longer than the buffer keeps
                # the most recent history_length iterations
                # (reconstructable from result.iterations) instead of
                # overwriting one slot; frozen (vmap) steps leave their
                # slot untouched
                slot = jnp.mod(
                    s.iterations + iter_offset, history_length
                )
                hist = hist.at[slot].set(
                    jnp.where(keep, row, hist[slot])
                )
                return new_s, hist

            return cond_h, body_h

        hist0 = jnp.full((history_length, 4), jnp.nan, jnp.float32)
        carry = (init, hist0)
        for c_a, b_a in arms:
            c_h, b_h = with_hist(c_a, b_a)
            carry = jax.lax.while_loop(c_h, b_h, carry)
        final, history = carry
    else:
        history = None
        final = init
        for c_a, b_a in arms:
            final = jax.lax.while_loop(c_a, b_a, final)
    return RegistrationResult(
        transform=RigidTransform(
            rotation=final.rotation,
            translation=final.translation,
            scale=final.scale,
        ),
        iterations=final.iterations,
        error=final.sigma2,  # the reference reports sigma^2 as "error"
        history=history,
        em=final,  # the chunked driver's carry (cpd_register_chunked)
    )


@partial(jax.jit, static_argnames=("centroid_init",))
def hybrid_fast_threshold(
    before: Cloud, after: Cloud, centroid_init: bool = False
) -> jnp.ndarray:
    """``0.015 * sigma^2_0`` — the Hybrid fast->slow switch threshold
    (``coherentpointdrift.cpp:158``), computed exactly as
    ``cpd_register``'s in-program init (same arrays, same masked sums)
    so a chunked driver's phase test agrees with the loop's."""
    mask_b, mask_a = before.mask(), after.mask()
    moving, target = before.points, after.points
    m, n = jnp.sum(mask_b), jnp.sum(mask_a)
    if centroid_init:
        t0 = (
            jnp.sum(target * mask_a[:, None], axis=0) / n
            - jnp.sum(moving * mask_b[:, None], axis=0) / m
        )
        moving = moving + t0
    return 0.015 * sigma_squared_init(moving, mask_b, target, mask_a)


def cpd_register_chunked(
    before: Cloud,
    after: Cloud,
    max_iterations: int = -1,
    chunk: int = 5,
    chunk_fast: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    **kwargs,
) -> RegistrationResult:
    """``cpd_register`` dispatched ``chunk`` EM iterations at a time,
    the full loop state warm-started across dispatches (``CPDResume``).

    ``chunk_fast`` (Hybrid-with-FGT only): iterations per dispatch while
    the run is still in the FAST phase (``sigma^2 > 0.015 sigma^2_0``,
    the device FGT — O(N+M), much cheaper per iteration than the exact
    slow phase).  The phase is tested at every boundary from the carried
    ``sigma^2`` against the same threshold the loop uses
    (``hybrid_fast_threshold``).  A dispatch that starts fast and flips
    mid-chunk finishes its remaining iterations in the slow arms of the
    SAME dispatch (trajectory is chunk-size invariant); the next
    boundary then re-sizes.

    Identical trajectory to the single-dispatch run (the boundary state
    IS the while_loop carry; asserted bit-equal in ``tests/test_cpd.py``).
    The chunk boundary is the checkpoint unit: ``checkpoint_path``
    persists every boundary — the final one included — for kill/continue
    (``tpuslam.harness.checkpoint``); a file that does not match this
    run (cloud fingerprints, shapes, or the trajectory-determining EM
    parameters) is ignored with a notice and overwritten, and a
    matching file whose progress already meets ``max_iterations``
    returns its state as-is (idempotent re-run).

    ``record_history`` is not supported here (each dispatch would
    restart the ring); use the single-dispatch path for debugging.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if kwargs.get("record_history"):
        raise ValueError(
            "record_history is unsupported with chunked dispatch"
        )
    if max_iterations < 0:
        # reference quirk: CPD's -1 means ZERO iterations (the loop
        # condition `iterations < -1` is immediately false,
        # coherentpointdrift.cpp:104) — NOT unbounded like ICP's
        return cpd_register(
            before, after, max_iterations=max_iterations, **kwargs
        )
    total = 0
    resume = None
    ckpt_meta = None
    if checkpoint_path is not None:
        from tpuslam.harness.checkpoint import (
            cloud_fingerprint,
            load_resume_or_none,
        )

        # every trajectory-determining EM parameter is validated, so a
        # checkpoint can never resume a state produced under different
        # semantics (weight, scale mode, approximation ladder, FGT)
        approx = kwargs.get("approximation_type", ApproximationType.NONE)
        ckpt_meta = {
            "n_pad": int(before.points.shape[0]),
            "m_pad": int(after.points.shape[0]),
            "n": int(before.count),
            "m": int(after.count),
            "eps": float(kwargs.get("eps", 1e-3)),
            "tolerance": float(kwargs.get("tolerance", 1e-3)),
            "weight": float(kwargs.get("weight", 0.3)),
            "const_scale": bool(kwargs.get("const_scale", False)),
            "approximation_type": str(getattr(approx, "value", approx)),
            "use_fgt": resolve_use_fgt(
                kwargs.get("use_fgt"), approx,
                before.padded_size, after.padded_size,
            ),
            "fgt_k": int(kwargs.get("fgt_k", 128)),
            "order_of_truncation": int(
                kwargs.get("order_of_truncation", 8)
            ),
            "ratio_of_far_field": float(
                kwargs.get("ratio_of_far_field", 10.0)
            ),
            "centroid_init": bool(kwargs.get("centroid_init", False)),
            "fp_before": cloud_fingerprint(before.points, before.mask()),
            "fp_after": cloud_fingerprint(after.points, after.mask()),
        }
        resume = load_resume_or_none(checkpoint_path, "cpd", ckpt_meta)
        if resume is not None:
            total = int(resume.done_before)
        if resume is not None and total >= max_iterations:
            if total > max_iterations:
                print(
                    f"[tpuslam] checkpoint already holds {total} EM "
                    f"iterations (requested {max_iterations}); "
                    f"returning its state"
                )
            return RegistrationResult(
                transform=RigidTransform(
                    rotation=jnp.asarray(resume.rotation, jnp.float32),
                    translation=jnp.asarray(
                        resume.translation, jnp.float32
                    ),
                    scale=jnp.asarray(resume.scale, jnp.float32),
                ),
                iterations=jnp.int32(total),
                error=jnp.asarray(resume.sigma2, jnp.float32),
            )
    approx_t = kwargs.get("approximation_type", ApproximationType.NONE)
    phase_aware = (
        chunk_fast is not None
        and chunk_fast != chunk
        and approx_t == ApproximationType.Hybrid
        and resolve_use_fgt(
            kwargs.get("use_fgt"), approx_t,
            before.padded_size, after.padded_size,
        )
    )
    if phase_aware:
        thr = float(hybrid_fast_threshold(
            before, after,
            centroid_init=bool(kwargs.get("centroid_init", False)),
        ))
    while True:
        in_fast = phase_aware and (
            resume is None or float(resume.sigma2) > thr
        )
        k = min(chunk_fast if in_fast else chunk, max_iterations - total)
        result = cpd_register(
            before, after, max_iterations=k, resume=resume, **kwargs
        )
        did = int(result.iterations)
        total += did
        s = result.em
        resume = CPDResume(
            rotation=s.rotation,
            translation=s.translation,
            scale=s.scale,
            sigma2=s.sigma2,
            log_likelihood=s.log_likelihood,
            ntol=s.ntol,
            done_before=jnp.int32(total),
        )
        if checkpoint_path is not None:
            from tpuslam.harness.checkpoint import save_cpd_checkpoint

            save_cpd_checkpoint(checkpoint_path, resume, ckpt_meta)
        # the loop freezes its counter when it stops (converged /
        # sigma^2 floor / non-finite), so an early stop is exactly
        # "fewer than the allowed k iterations ran"
        if did < k or total >= max_iterations:
            break
    return RegistrationResult(
        transform=result.transform,
        iterations=jnp.int32(total),
        error=result.error,
    )
