"""Multi-chip ICP: the full while-loop jitted over a device mesh.

Same algorithm as ``tpuslam.algorithms.icp`` (homogeneous composition,
divergence guard, weight-masked Procrustes) with the NN hot loop sharded:
the target cloud lives split across devices, each iteration does one
per-shard argmin + two ``pmin`` / one ``psum`` collective (NCCL), and
everything else (3x3 SVD, state update) runs replicated.  Per SURVEY §3.2's lesson,
nothing crosses the host boundary — the loop, collectives included,
compiles into one XLA program.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpuslam.algorithms.icp import FLT_MAX, ICPState, RegistrationResult
from tpuslam.core.types import Cloud, RigidTransform
from tpuslam.ops.procrustes import weighted_procrustes
from tpuslam.parallel.mesh import POINTS_AXIS
from tpuslam.parallel.nn import sharded_nn_combine
from tpuslam.ops.geometry import transform_points


@lru_cache(maxsize=16)
def _build(mesh: Mesh, divergence_guard: bool, use_pallas=None):
    def loop(before_pts, src_mask, tgt_shard, tgt_count,
             eps, max_d2, max_iterations,
             init_r, init_t, init_err, init_prev):
        def run_nn(transformed):
            _, dist, matched = sharded_nn_combine(
                transformed, tgt_shard, tgt_count, use_pallas=use_pallas
            )
            return dist, matched

        def cond(s: ICPState):
            return jnp.logical_and(
                jnp.logical_not(s.done),
                jnp.logical_or(
                    max_iterations == -1, s.iterations < max_iterations
                ),
            )

        def body(s: ICPState) -> ICPState:
            transformed = transform_points(
                before_pts, s.rotation, s.translation
            )
            dist, matched = run_nn(transformed)
            w = jnp.logical_and(dist < max_d2, src_mask > 0).astype(
                jnp.float32
            )
            n_corr = jnp.sum(w)
            no_corr = n_corr == 0

            r_step, t_step = weighted_procrustes(transformed, matched, w)
            r_new = jnp.matmul(r_step, s.rotation, precision=jax.lax.Precision.HIGHEST)
            t_new = jnp.matmul(
                r_step, s.translation, precision=jax.lax.Precision.HIGHEST
            ) + t_step

            new_transformed = transform_points(before_pts, r_new, t_new)
            diff = matched - new_transformed
            err = jnp.sum(jnp.sum(diff * diff, -1) * w) / jnp.maximum(
                n_corr, 1.0
            )

            converged = err < eps
            diverged = jnp.logical_and(
                jnp.asarray(divergence_guard), err > s.prev_error
            )
            # fail-fast on non-finite error (see algorithms/icp.py): a
            # NaN would otherwise spin the whole mesh forever at
            # max_iterations=-1; it also reverts to the last accepted
            # transform so the NaN step is never committed
            non_finite = jnp.logical_not(jnp.isfinite(err))

            def pick(cur, new):
                return jnp.where(
                    jnp.logical_or(jnp.logical_or(no_corr, diverged),
                                   non_finite),
                    cur, new,
                )

            done = jnp.logical_or(
                jnp.logical_or(no_corr, non_finite),
                jnp.logical_or(converged, diverged),
            )
            keep = jnp.logical_not(done)
            return ICPState(
                rotation=pick(s.rotation, r_new),
                translation=pick(s.translation, t_new),
                error=pick(s.error, err),
                prev_error=jnp.where(keep, err, s.prev_error),
                iterations=jnp.where(done, s.iterations, s.iterations + 1),
                done=done,
            )

        # cold start passes (eye, zero, 1e5, FLT_MAX); a chunked resume
        # passes the accepted boundary state — same values the loop
        # would hold had it continued, so chunked dispatch follows the
        # unchunked trajectory step for step
        init = ICPState(
            rotation=init_r, translation=init_t,
            error=init_err, prev_error=init_prev,
            iterations=jnp.int32(0), done=jnp.asarray(False),
        )
        final = jax.lax.while_loop(cond, body, init)
        return final.rotation, final.translation, final.iterations, final.error

    sharded = jax.shard_map(
        loop,
        mesh=mesh,
        in_specs=(P(), P(), P(POINTS_AXIS, None), P(), P(), P(), P(),
                  P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def icp_register_sharded(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    resume=None,
    use_pallas=None,
) -> RegistrationResult:
    """``before`` replicated, ``after`` sharded along the points axis
    (see ``tpuslam.parallel.mesh.shard_cloud``).  ``use_pallas`` picks
    the per-shard NN arm (None: the kernel on the GPU)."""
    b_points, b_mask = before.points, before.mask()
    a_points, a_count = after.points, after.count
    fn = _build(mesh, divergence_guard, use_pallas)
    if resume is None:
        init_r = jnp.eye(3, dtype=jnp.float32)
        init_t = jnp.zeros((3,), jnp.float32)
        init_err = jnp.float32(1e5)  # basicicp.cpp:26
        init_prev = FLT_MAX
    else:
        # chunk-boundary warm start (ICPResume): prev_error defaults to
        # the accepted error — the divergence-guard state at a boundary
        init_r = jnp.asarray(resume.rotation, jnp.float32)
        init_t = jnp.asarray(resume.translation, jnp.float32)
        init_err = jnp.asarray(resume.error, jnp.float32)
        init_prev = jnp.asarray(
            resume.error if resume.prev_error is None
            else resume.prev_error,
            jnp.float32,
        )
    rotation, translation, iterations, error = fn(
        b_points,
        b_mask,
        a_points,
        a_count,
        jnp.float32(eps),
        jnp.float32(max_distance_squared),
        jnp.int32(max_iterations),
        init_r, init_t, init_err, init_prev,
    )
    return RegistrationResult(
        transform=RigidTransform(
            rotation=rotation,
            translation=translation,
            scale=jnp.float32(1.0),
        ),
        iterations=iterations,
        error=error,
    )


def icp_register_sharded_prealigned(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    subcloud_size: int = 1000,
    seed: int = 0,
) -> RegistrationResult:
    """Sharded ICP seeded by sharded NICP — the ``icp-prealign``
    extension on the points-axis mesh.

    The seed is COMPOSED rather than resumed: ``before`` is
    pre-transformed by the NICP estimate and the cold sharded loop runs
    on the moved cloud (algebraically the same trajectory — ICP from
    identity on ``R0·b + t0`` takes the same Procrustes steps as ICP
    from ``(R0, t0)`` on ``b``), so the sharded driver's loop needs no
    init-transform plumbing.  Final transform composes back:
    ``R = R1·R0``, ``t = R1·t0 + t1``."""
    from tpuslam.parallel.nicp import nicp_register_sharded

    pre = nicp_register_sharded(
        before, after, mesh, subcloud_size=subcloud_size, seed=seed
    )
    r0 = pre.transform.rotation
    t0 = pre.transform.translation
    moved = Cloud(
        # padded rows must stay zeros (Cloud contract) — mask the shift
        points=transform_points(before.points, r0, t0)
        * before.mask()[:, None],
        count=before.count,
    )
    res = icp_register_sharded(
        moved, after, mesh, eps=eps,
        max_distance_squared=max_distance_squared,
        max_iterations=max_iterations,
        divergence_guard=divergence_guard,
    )
    r1 = res.transform.rotation
    t1 = res.transform.translation
    hi = jax.lax.Precision.HIGHEST
    return RegistrationResult(
        transform=RigidTransform(
            rotation=jnp.matmul(r1, r0, precision=hi),
            translation=jnp.matmul(r1, t0, precision=hi) + t1,
            scale=jnp.float32(1.0),
        ),
        iterations=res.iterations,
        error=res.error,
    )


def icp_register_sharded_chunked(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    chunk: int = 10,
    **kwargs,
) -> RegistrationResult:
    """``icp_register_sharded`` dispatched ``chunk`` iterations at a
    time — the multi-chip analog of ``icp_register_chunked``.  Identical
    trajectory to the single-dispatch sharded run: the boundary state is
    the exact while_loop carry."""
    from tpuslam.algorithms.icp import ICPResume

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    total = 0
    resume = None
    while True:
        if max_iterations == -1:
            k = chunk
        else:
            k = min(chunk, max_iterations - total)
        result = icp_register_sharded(
            before, after, mesh, eps=eps,
            max_distance_squared=max_distance_squared,
            max_iterations=k, resume=resume, **kwargs,
        )
        did = int(result.iterations)
        total += did
        resume = ICPResume(
            rotation=result.transform.rotation,
            translation=result.transform.translation,
            error=result.error,
            done_before=jnp.int32(total),
        )
        if did < k or (max_iterations != -1 and total >= max_iterations):
            break
    return RegistrationResult(
        transform=result.transform,
        iterations=jnp.int32(total),
        error=result.error,
    )
