"""Multi-chip CPD: EM with the target cloud sharded over the mesh.

The decomposition follows directly from the sufficient-statistics form
(SURVEY §5.7-5.8): each target point's responsibility denominator is a sum
over the REPLICATED moving cloud, so the E-step is embarrassingly parallel
over target shards — each device runs the blocked exact E-step on its
shard and only the moment accumulators cross chips:

* ``p1`` (f32[M]), ``px`` (f32[M,3]), log-likelihood — ``psum`` through NCCL;
* ``pt1`` stays sharded; the M-step needs it only through the reductions
  ``A^T pt1`` (f32[3]) and ``sum pt1 |a|^2`` (f32[]), which are psum'd as
  scalars/3-vectors ("ring attention for GMM responsibilities" without the
  ring — the mixture structure makes the denominator local).

The 3x3 SVD M-step then runs replicated on every chip.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpuslam.algorithms.cpd import (
    CPDState,
    cpd_estep_auto,
    mstep_from_moments,
    uniform_constant,
)
from tpuslam.algorithms.icp import RegistrationResult
from tpuslam.config.configuration import ApproximationType
from tpuslam.core.types import Cloud, RigidTransform
from tpuslam.parallel.mesh import POINTS_AXIS
from tpuslam.ops.geometry import transform_points


@lru_cache(maxsize=16)
def _build(mesh: Mesh, const_scale: bool,
           approximation_type: ApproximationType,
           use_fgt: bool = False, fgt_k: int = 128, fgt_p: int = 8,
           ratio_of_far_field: float = 10.0):
    axis = POINTS_AXIS
    n_dev = mesh.shape[POINTS_AXIS]
    # union of per-shard clusterings: each shard expands its points
    # about its own centers, so the gathered union is a valid global
    # clustering.  Shards are index-contiguous — every shard spans the
    # FULL spatial extent — so Taylor accuracy requires the full center
    # count PER SHARD (cluster radius is centers-per-volume, not
    # points-per-center; k/n_dev centers per shard was measured to
    # collapse the approximation at small sigma^2).  The gathered model
    # is n_dev x larger; a Morton pre-sorted sharding would cut this to
    # k total (future optimization, documented trade).
    k_local = fgt_k

    def loop(moving, mask_b, tgt_shard, tgt_count,
             weight, eps, tolerance, max_iterations,
             has_resume, res_r, res_t, res_scale, res_sigma2,
             res_ll, res_ntol):
        shard_size = tgt_shard.shape[0]
        offset = jax.lax.axis_index(axis) * shard_size
        local_gidx = offset + jnp.arange(shard_size, dtype=jnp.int32)
        mask_a = (local_gidx < tgt_count).astype(jnp.float32)

        m = jnp.sum(mask_b)
        n = jax.lax.psum(jnp.sum(mask_a), axis)

        # sigma^2 init, closed form with psum'd target partials
        sb2 = jnp.sum(jnp.sum(moving * moving, -1) * mask_b)
        sb = jnp.sum(moving * mask_b[:, None], axis=0)
        sa2 = jax.lax.psum(
            jnp.sum(jnp.sum(tgt_shard * tgt_shard, -1) * mask_a), axis
        )
        sa = jax.lax.psum(
            jnp.sum(tgt_shard * mask_a[:, None], axis=0), axis
        )
        hi = jax.lax.Precision.HIGHEST
        sigma2_0 = (n * sb2 + m * sa2 - 2.0 * jnp.dot(sb, sa, precision=hi)) / (
            3.0 * m * n
        )
        c_init = uniform_constant(sigma2_0, weight, m, n)

        def estep_psum(transformed, sigma2, c_used, trunc):
            local = cpd_estep_auto(
                transformed, mask_b, tgt_shard, mask_a, sigma2, c_used,
                trunc,
            )
            p1 = jax.lax.psum(local.p1, axis)
            px = jax.lax.psum(local.px, axis)
            err = jax.lax.psum(local.error, axis)
            # the per-shard error already includes 3*n_local*log(s2)/2,
            # which psums to the global 3*N*log(s2)/2 term — exact
            t_pt1_a2 = jax.lax.psum(
                jnp.sum(local.pt1 * jnp.sum(tgt_shard * tgt_shard, -1)),
                axis,
            )
            s_pt1_a = jax.lax.psum(
                jnp.einsum("n,nr->r", local.pt1, tgt_shard, precision=hi),
                axis,
            )
            return p1, px, err, t_pt1_a2, s_pt1_a

        def estep_fgt_psum(transformed, sigma_e, sigma2_0):
            """Sharded FGT E-step (``cpdutils.cpp:19-73`` decomposition):
            the moving-cloud model is replicated (moving is), the target
            model is a per-shard clustering whose (centers, ak) are
            all-gathered — one collective round per E-step instead of a
            psum per K-center selection step."""
            from tpuslam.algorithms.cpd import uniform_constant as uc
            from tpuslam.ops.fgt import (
                FGTModel,
                compute_fgt_model_multi,
                fgt_predict,
                fgt_predict_multi,
            )

            # adaptive live center count (cpdutils.cpp:35); each shard
            # spans the full extent, so it uses the full live count
            k_rt = jnp.minimum(
                jnp.minimum(m, n),
                50.0 + sigma2_0 / jnp.maximum(sigma_e, 1e-20),
            ).astype(jnp.int32)
            k_rt = jnp.clip(k_rt, 1, fgt_k)
            k_rt_local = k_rt

            hsigma = jnp.sqrt(2.0 * sigma_e)
            model_y = compute_fgt_model_multi(
                transformed, mask_b[:, None], mask_b, hsigma, fgt_k,
                fgt_p, k_rt,
            )
            kt1 = fgt_predict(
                tgt_shard,
                FGTModel(centers=model_y.centers, ak=model_y.ak[..., 0]),
                hsigma, ratio_of_far_field, fgt_p,
            )
            ndi = uc(sigma_e, weight, m, n)
            denom = jnp.maximum(kt1, 0.0) + ndi
            inv_denom = mask_a / denom
            pt1 = (1.0 - ndi / denom) * mask_a

            weights4 = jnp.concatenate(
                [inv_denom[:, None], tgt_shard * inv_denom[:, None]],
                axis=1,
            )
            model_x = compute_fgt_model_multi(
                tgt_shard, weights4, mask_a, hsigma, k_local, fgt_p,
                k_rt_local,
            )
            centers_g = jax.lax.all_gather(
                model_x.centers, axis, tiled=True
            )
            ak_g = jax.lax.all_gather(model_x.ak, axis, tiled=True)
            out = fgt_predict_multi(
                transformed, FGTModel(centers=centers_g, ak=ak_g),
                hsigma, ratio_of_far_field, fgt_p,
            )
            p1 = out[:, 0] * mask_b
            px = out[:, 1:4] * mask_b[:, None]

            n_local = jnp.sum(mask_a)
            err = jax.lax.psum(
                -jnp.sum(jnp.log(denom) * mask_a)
                + 3.0 * n_local * jnp.log(sigma_e) / 2.0,
                axis,
            )
            t_pt1_a2 = jax.lax.psum(
                jnp.sum(pt1 * jnp.sum(tgt_shard * tgt_shard, -1)), axis
            )
            s_pt1_a = jax.lax.psum(
                jnp.einsum("n,nr->r", pt1, tgt_shard, precision=hi), axis
            )
            return p1, px, err, t_pt1_a2, s_pt1_a

        def cond(s: CPDState):
            return jnp.logical_and(
                s.iterations < max_iterations,
                jnp.logical_and(s.ntol > tolerance, s.sigma2 > eps),
            )

        def body(s: CPDState) -> CPDState:
            transformed = transform_points(
                moving, s.rotation, s.translation, s.scale
            )

            if approximation_type == ApproximationType.NONE:
                p1, px, err, t_pt1_a2, s_pt1_a = estep_psum(
                    transformed, s.sigma2, c_init, jnp.asarray(False)
                )
            elif approximation_type == ApproximationType.Full:
                sigma_e = jnp.maximum(s.sigma2, 0.05)
                if use_fgt:
                    p1, px, err, t_pt1_a2, s_pt1_a = estep_fgt_psum(
                        transformed, sigma_e, sigma2_0
                    )
                else:
                    p1, px, err, t_pt1_a2, s_pt1_a = estep_psum(
                        transformed, sigma_e,
                        uniform_constant(sigma_e, weight, m, n),
                        jnp.asarray(False),
                    )
            else:  # Hybrid
                fast_now = s.sigma2 > 0.015 * sigma2_0
                if use_fgt:
                    # fast_now is replicated, so every device takes the
                    # same branch and the collectives stay uniform
                    p1, px, err, t_pt1_a2, s_pt1_a = jax.lax.cond(
                        fast_now,
                        lambda: estep_fgt_psum(
                            transformed, s.sigma2, sigma2_0
                        ),
                        lambda: estep_psum(
                            transformed, s.sigma2, c_init,
                            jnp.asarray(True),
                        ),
                    )
                else:
                    c_used = jnp.where(
                        fast_now,
                        uniform_constant(s.sigma2, weight, m, n),
                        c_init,
                    )
                    p1, px, err, t_pt1_a2, s_pt1_a = estep_psum(
                        transformed, s.sigma2, c_used,
                        jnp.logical_not(fast_now),
                    )
            ntol = jnp.abs((err - s.log_likelihood) / err)

            # replicated M-step from psum'd moments
            np_ = jnp.sum(p1)
            inv_np = 1.0 / np_
            mu_b = inv_np * jnp.einsum("m,mr->r", p1, moving, precision=hi)
            mu_a = inv_np * s_pt1_a
            a_mat = (
                jnp.einsum(
                    "mr,mc->rc", px, moving, precision=hi,
                )
                - np_ * jnp.outer(mu_a, mu_b)
            )
            sigma_sub = t_pt1_a2 - np_ * jnp.dot(mu_a, mu_a, precision=hi)
            scale_den = (
                jnp.sum(p1 * jnp.sum(moving * moving, -1))
                - np_ * jnp.dot(mu_b, mu_b, precision=hi)
            )
            mres = mstep_from_moments(
                np_, mu_b, mu_a, a_mat, sigma_sub, scale_den,
                const_scale, s.scale,
            )

            return CPDState(
                rotation=mres.rotation, translation=mres.translation,
                scale=mres.scale, sigma2=mres.sigma2,
                log_likelihood=err, ntol=ntol,
                iterations=s.iterations + 1,
            )

        # cold start (has_resume=False) initializes from the in-program
        # sigma2_0; a chunk-boundary resume re-enters with the FULL EM
        # carry (sigma2_0/c_init above recompute bit-identically from
        # the unchanged inputs), so chunked dispatch follows the
        # unchunked trajectory step for step
        def pick(cold, res):
            return jnp.where(has_resume, res, cold)

        init = CPDState(
            rotation=pick(jnp.eye(3, dtype=jnp.float32), res_r),
            translation=pick(jnp.zeros((3,), jnp.float32), res_t),
            scale=pick(jnp.float32(1.0), res_scale),
            sigma2=pick(sigma2_0, res_sigma2),
            log_likelihood=pick(jnp.float32(0.0), res_ll),
            ntol=pick(tolerance + 10.0, res_ntol),
            iterations=jnp.int32(0),
        )
        final = jax.lax.while_loop(cond, body, init)
        return (final.rotation, final.translation, final.scale,
                final.iterations, final.sigma2,
                final.log_likelihood, final.ntol)

    sharded = jax.shard_map(
        loop,
        mesh=mesh,
        in_specs=(P(), P(), P(POINTS_AXIS, None), P(), P(), P(), P(), P(),
                  P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def cpd_register_sharded(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    weight: float = 0.3,
    const_scale: bool = False,
    max_iterations: int = -1,
    tolerance: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    use_fgt: bool | None = None,
    fgt_k: int = 128,
    order_of_truncation: int = 8,
    ratio_of_far_field: float = 10.0,
    resume=None,
) -> RegistrationResult:
    """``before`` (moving) replicated, ``after`` (target) sharded.

    ``use_fgt`` follows the single-device tri-state
    (``tpuslam.algorithms.cpd.resolve_use_fgt``): ``None`` applies the
    size crossover on the GLOBAL problem size; ``True`` forces
    the Fast Gauss Transform approximation in the Full/Hybrid fast
    phases, sharded: the target-side model is a per-shard clustering
    all-gathered into a union model (one collective round per E-step),
    with the reference's adaptive live-center count
    (``cpdutils.cpp:35``) split across shards."""
    from tpuslam.algorithms.cpd import resolve_use_fgt

    use_fgt = resolve_use_fgt(
        use_fgt, approximation_type, before.padded_size, after.padded_size
    )
    fn = _build(
        mesh, const_scale, approximation_type, use_fgt, fgt_k,
        order_of_truncation, ratio_of_far_field,
    )
    weight = float(min(max(weight, 1e-6), 1.0 - 1e-6))
    if resume is None:
        res_vals = (
            jnp.asarray(False), jnp.eye(3, dtype=jnp.float32),
            jnp.zeros((3,), jnp.float32), jnp.float32(1.0),
            jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
        )
    else:  # CPDResume — the full EM carry at a chunk boundary
        res_vals = (
            jnp.asarray(True),
            jnp.asarray(resume.rotation, jnp.float32),
            jnp.asarray(resume.translation, jnp.float32),
            jnp.asarray(resume.scale, jnp.float32),
            jnp.asarray(resume.sigma2, jnp.float32),
            jnp.asarray(resume.log_likelihood, jnp.float32),
            jnp.asarray(resume.ntol, jnp.float32),
        )
    (rotation, translation, scale, iterations, sigma2,
     log_likelihood, ntol) = fn(
        before.points,
        before.mask(),
        after.points,
        after.count,
        jnp.float32(weight),
        jnp.float32(eps),
        jnp.float32(tolerance),
        jnp.int32(max_iterations),
        *res_vals,
    )
    final = (rotation, translation, scale, sigma2, log_likelihood, ntol)
    return RegistrationResult(
        transform=RigidTransform(
            rotation=rotation, translation=translation, scale=scale
        ),
        iterations=iterations,
        error=sigma2,
        em=final,
    )


def cpd_register_sharded_chunked(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    max_iterations: int = -1,
    chunk: int = 5,
    **kwargs,
) -> RegistrationResult:
    """``cpd_register_sharded`` dispatched ``chunk`` EM iterations at a
    time — the multi-chip analog of ``cpd_register_chunked`` (the
    production long-registration path over the mesh).  The boundary
    state is the exact while_loop carry, so the trajectory matches the
    single-dispatch sharded run."""
    from tpuslam.algorithms.cpd import CPDResume

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if max_iterations < 0:
        # reference quirk: CPD's -1 means ZERO iterations
        # (coherentpointdrift.cpp:104)
        return cpd_register_sharded(
            before, after, mesh, max_iterations=max_iterations, **kwargs
        )
    total = 0
    resume = None
    while True:
        k = min(chunk, max_iterations - total)
        result = cpd_register_sharded(
            before, after, mesh, max_iterations=k, resume=resume,
            **kwargs,
        )
        did = int(result.iterations)
        total += did
        r, t, s, sigma2, ll, ntol = result.em
        resume = CPDResume(
            rotation=r, translation=t, scale=s, sigma2=sigma2,
            log_likelihood=ll, ntol=ntol, done_before=jnp.int32(total),
        )
        if did < k or total >= max_iterations:
            break
    return RegistrationResult(
        transform=result.transform,
        iterations=jnp.int32(total),
        error=result.error,
    )
