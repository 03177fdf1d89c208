"""Iterative Closest Point — one jitted implementation for the CPU and the GPU.

Redesign of the reference's twin implementations (CPU ``basicicp.cpp:23-61``,
GPU ``icpcuda.cu:8-58``) as a single ``lax.while_loop`` whose whole body —
NN correspondence search, weighted Procrustes, transform, error — compiles
into one XLA program.  Nothing crosses the host boundary per iteration
(the reference GPU round-trips the device 4+ times per iteration,
SURVEY §3.2; here only the final scalars leave the device).

Behavioral notes (SURVEY §2.7):
* Transform composition is homogeneous (``R <- R_step R``,
  ``t <- R_step t + t_step``) like the GPU version (``icpcuda.cu:35``);
  the CPU version's additive ``t`` is a documented approximation we do not
  copy (``basicicp.cpp:43-44``).
* The divergence guard (error increased -> revert and stop,
  ``icpcuda.cu:43-49``) is on by default and toggleable (the CPU version
  lacks it).
* ``max_iterations == -1`` means run until convergence
  (``basicicp.cpp:14,32``).
* Correspondences with squared distance >= ``max_distance_squared`` are
  dropped via {0,1} weights instead of compaction (strict ``<``,
  ``common.cpp:422``); zero correspondences stops the loop
  (``basicicp.cpp:36-37``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from tpuslam.core.types import Cloud, RigidTransform
from tpuslam.ops.nn import nearest_neighbors
from tpuslam.ops.geometry import transform_points
from tpuslam.ops.procrustes import weighted_procrustes

FLT_MAX = jnp.float32(3.4028235e38)


class ICPState(NamedTuple):
    rotation: jnp.ndarray  # f32[3,3]
    translation: jnp.ndarray  # f32[3]
    error: jnp.ndarray  # f32[]
    prev_error: jnp.ndarray  # f32[]
    iterations: jnp.ndarray  # i32[]
    done: jnp.ndarray  # bool[]


class RegistrationResult(NamedTuple):
    transform: RigidTransform
    iterations: jnp.ndarray  # i32[]
    error: jnp.ndarray  # f32[]
    # optional per-iteration trace (CPD: [H, 4] of sigma2/ntol/L/scale),
    # populated only by the record_history paths (SURVEY §5.4 debuggability)
    history: Optional[jnp.ndarray] = None
    # final EM loop state (CPD only) — the chunked driver's carry
    # (tpuslam.algorithms.cpd.CPDState; typed loosely to avoid a cycle)
    em: Optional[tuple] = None


class ICPResume(NamedTuple):
    """Warm-start carry for chunked dispatch (``icp_register_chunked``):
    the accepted transform and its error, exactly as the while_loop would
    hold them at an iteration boundary, plus the iterations already done
    (verbose loop_nr continuity)."""

    rotation: jnp.ndarray  # f32[3,3]
    translation: jnp.ndarray  # f32[3]
    error: jnp.ndarray  # f32[]
    done_before: int = 0
    # divergence-guard seed; None = use ``error`` (chunk boundaries,
    # where the last accepted error IS the guard state).  The prealign
    # path passes FLT_MAX here: its ``error`` is the cold-start
    # *reporting* sentinel (basicicp.cpp:26), and an absolute 1e5 guard
    # threshold would falsely abort iteration 1 on large-unit clouds.
    prev_error: Optional[jnp.ndarray] = None


def _icp_loop(
    src_points: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_points: jnp.ndarray,
    tgt_count: jnp.ndarray,
    use_pallas: Optional[bool],
    eps: jnp.ndarray,
    max_d2: jnp.ndarray,
    max_iterations: jnp.ndarray,
    divergence_guard: bool,
    verbose: bool,
    iter_offset: jnp.ndarray,
    init: ICPState,
    patience: int,
) -> RegistrationResult:
    """The whole-registration ``lax.while_loop``: NN correspondence,
    weighted Procrustes, transform composition, error, stop conditions —
    everything ``icp_register`` runs after input preparation, factored
    out so other in-program drivers (the scanned sequence lowering in
    ``tpuslam.algorithms.sequence``) execute the IDENTICAL per-iteration
    math with their own prepared inputs.  ``use_pallas`` picks the NN
    arm (``tpuslam.ops.nn.nearest_neighbors``; None = by platform)."""

    def cond(s: ICPState):
        return jnp.logical_and(
            jnp.logical_not(s.done),
            jnp.logical_or(max_iterations == -1, s.iterations < max_iterations),
        )

    def body(s: ICPState) -> ICPState:
        new_s = _body(s)
        # freeze finished problems: under vmap the while_loop keeps
        # applying the body until EVERY batch element's cond is false, so
        # an already-converged element must pass through unchanged
        keep = cond(s)
        return jax.tree.map(
            lambda old, new: jnp.where(keep, new, old), s, new_s
        )

    def _body(s: ICPState) -> ICPState:
        transformed = transform_points(
            src_points, s.rotation, s.translation
        )
        idx, dist = nearest_neighbors(
            transformed, tgt_points, tgt_count, use_pallas=use_pallas
        )
        w = jnp.logical_and(dist < max_d2, src_mask > 0).astype(jnp.float32)
        n_corr = jnp.sum(w)
        no_corr = n_corr == 0

        matched = tgt_points[idx]
        r_step, t_step = weighted_procrustes(transformed, matched, w)
        # 3x3/3-vector composition in full f32: a reduced-precision
        # (TF32) pass loses ~2^-10 per entry and the composition
        # compounds it every iteration
        r_new = jnp.matmul(r_step, s.rotation, precision=jax.lax.Precision.HIGHEST)
        t_new = jnp.matmul(r_step, s.translation, precision=jax.lax.Precision.HIGHEST) + t_step

        new_transformed = transform_points(src_points, r_new, t_new)
        diff = matched - new_transformed
        err = jnp.sum(jnp.sum(diff * diff, axis=-1) * w) / jnp.maximum(n_corr, 1.0)

        converged = err < eps
        diverged = jnp.logical_and(
            jnp.asarray(divergence_guard), err > s.prev_error
        )

        # fail fast on non-finite error (SURVEY §5.3): with
        # max_iterations=-1 a NaN would otherwise never satisfy any stop
        # condition and the loop would spin forever
        non_finite = jnp.logical_not(jnp.isfinite(err))

        # zero correspondences, divergence, or a numeric blowup: stop,
        # reverting to the pre-iteration transform — exactly the
        # reference's rollback to the previous accepted state
        # (icpcuda.cu:43-49), since the carried (rotation, translation)
        # IS the last accepted transform.  Without the non_finite guard
        # a NaN step would be committed into the result.
        def pick(cur, new):
            return jnp.where(
                jnp.logical_or(jnp.logical_or(no_corr, diverged),
                               non_finite),
                cur, new,
            )

        rotation = pick(s.rotation, r_new)
        translation = pick(s.translation, t_new)
        error = pick(s.error, err)
        done = jnp.logical_or(
            jnp.logical_or(no_corr, non_finite),
            jnp.logical_or(converged, diverged),
        )
        # the reference increments only when the loop continues
        iterations = jnp.where(done, s.iterations, s.iterations + 1)

        if verbose:
            # the reference's per-iteration printf (basicicp.cpp:50);
            # iter_offset keeps numbering continuous across chunks
            jax.debug.print(
                "loop_nr {i}, error: {e}",
                i=s.iterations + 1 + iter_offset, e=err,
            )
        keep_going = jnp.logical_not(done)
        return ICPState(
            rotation=rotation,
            translation=translation,
            error=error,
            prev_error=jnp.where(keep_going, err, s.prev_error),
            iterations=iterations,
            done=done,
        )

    if patience > 0:
        # best-so-far wrapper around the unchanged body: carry
        # (state, best_R, best_t, best_err, non-improving streak).
        # best_err is seeded with FLT_MAX, NOT the carried init.error:
        # a resume's error field may be a reporting sentinel (1e5,
        # basicicp.cpp:26) that no real correspondence error at large
        # coordinate units would ever beat, and the first EVALUATED
        # error must always become the initial best.  Vmap caveat: the
        # batched while_loop runs until EVERY element's cond_p is
        # false, and an element past its own patience streak keeps
        # iterating (and may still improve its best) until the slowest
        # element finishes — best-so-far never degrades, but the
        # returned best can differ from the solo path's earlier cutoff.
        def cond_p(carry):
            s, _, _, _, streak = carry
            return jnp.logical_and(cond(s), streak < patience)

        def body_p(carry):
            s, br, bt, be, streak = carry
            s2 = body(s)
            improved = s2.error < be
            br = jnp.where(improved, s2.rotation, br)
            bt = jnp.where(improved, s2.translation, bt)
            be = jnp.where(improved, s2.error, be)
            streak = jnp.where(improved, 0, streak + 1)
            return (s2, br, bt, be, streak)

        final, best_r, best_t, best_e, _ = jax.lax.while_loop(
            cond_p, body_p,
            (init, init.rotation, init.translation, FLT_MAX,
             jnp.int32(0)),
        )
        # zero evaluated iterations (max_iterations=0 or an immediately
        # false cond): report the carried-in error, not the seed
        never_evaluated = best_e >= FLT_MAX
        return RegistrationResult(
            transform=RigidTransform(
                rotation=best_r, translation=best_t,
                scale=jnp.float32(1.0),
            ),
            iterations=final.iterations,
            error=jnp.where(never_evaluated, init.error, best_e),
        )
    final = jax.lax.while_loop(cond, body, init)
    return RegistrationResult(
        transform=RigidTransform(
            rotation=final.rotation,
            translation=final.translation,
            scale=jnp.float32(1.0),
        ),
        iterations=final.iterations,
        error=final.error,
    )


@partial(
    jax.jit,
    static_argnames=(
        "use_pallas", "divergence_guard", "verbose", "patience",
    ),
)
def icp_register(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    use_pallas: Optional[bool] = None,
    divergence_guard: bool = True,
    verbose: bool = False,
    resume: Optional[ICPResume] = None,
    patience: int = 0,
) -> RegistrationResult:
    """Register ``before`` onto ``after``; returns (R, t) with
    ``after ≈ R @ before + t`` plus iteration count and final MSE.

    ``use_pallas`` picks the NN arm: None (default) runs the Triton
    kernel on the GPU and the jnp reference on the CPU
    (``tpuslam.core.device.select``); True/False force one.

    ``patience > 0`` replaces the reference's stop-on-first-error-
    increase semantics (pair it with ``divergence_guard=False``) for
    WARM-started registrations: the loop keeps the best-so-far
    transform and stops after ``patience`` consecutive non-improving
    iterations, returning the best state.  A seeded start sits
    immediately in the near-optimum regime where the correspondence
    error fluctuates, so the reference guard would fire on noise after
    ~2 iterations and return seed quality (measured on an earlier
    build: trajectory drift RMS 3.1 vs 0.50 at 20x100k scans); with
    ``patience=0`` the reference contract is bit-unchanged."""
    src_mask = before.mask()
    max_iterations = jnp.asarray(max_iterations, dtype=jnp.int32)
    eps = jnp.asarray(eps, dtype=jnp.float32)
    max_d2 = jnp.asarray(max_distance_squared, dtype=jnp.float32)

    eye = jnp.eye(3, dtype=jnp.float32)
    zero = jnp.zeros((3,), dtype=jnp.float32)
    iter_offset = (
        jnp.int32(0) if resume is None
        else jnp.asarray(resume.done_before, jnp.int32)
    )
    if resume is None:
        init = ICPState(
            rotation=eye,
            translation=zero,
            error=jnp.float32(1e5),  # basicicp.cpp:26
            prev_error=FLT_MAX,
            iterations=jnp.int32(0),
            done=jnp.asarray(False),
        )
    else:
        # warm start at an iteration boundary: the accepted transform is
        # the carry, and prev_error equals the last accepted error — the
        # exact values the while_loop state would hold had it continued,
        # so a chunked run follows the unchunked trajectory step for step
        init = ICPState(
            rotation=jnp.asarray(resume.rotation, jnp.float32),
            translation=jnp.asarray(resume.translation, jnp.float32),
            error=jnp.asarray(resume.error, jnp.float32),
            prev_error=jnp.asarray(
                resume.error if resume.prev_error is None
                else resume.prev_error,
                jnp.float32,
            ),
            iterations=jnp.int32(0),
            done=jnp.asarray(False),
        )
    return _icp_loop(
        before.points, src_mask, after.points, after.count, use_pallas,
        eps, max_d2, max_iterations,
        divergence_guard=divergence_guard, verbose=verbose,
        iter_offset=iter_offset, init=init, patience=patience,
    )


def _icp_ckpt_meta(
    before: Cloud,
    after: Cloud,
    eps: float,
    max_distance_squared: float,
    divergence_guard: bool,
    extra: Optional[dict] = None,
) -> dict:
    """Checkpoint metadata for a chunked ICP run: shapes, cloud
    fingerprints, and every trajectory-determining loop parameter —
    including whether the run was NICP-prealigned (``prealign`` is
    False here and overridden by ``icp_register_prealigned``), so a
    cold-start checkpoint can never be resumed as a prealigned result
    or vice versa.  The NN arm selector (``use_pallas``) is
    deliberately absent: both arms compute the same exact NN, so it does
    not determine the trajectory."""
    from tpuslam.harness.checkpoint import cloud_fingerprint

    meta = {
        "n_pad": int(before.points.shape[0]),
        "m_pad": int(after.points.shape[0]),
        "n": int(before.count),
        "m": int(after.count),
        "eps": float(eps),
        "max_distance_squared": float(max_distance_squared),
        "divergence_guard": bool(divergence_guard),
        "prealign": False,
        "fp_before": cloud_fingerprint(before.points, before.mask()),
        "fp_after": cloud_fingerprint(after.points, after.mask()),
    }
    meta.update(extra or {})
    return meta


def icp_register_chunked(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    chunk: int = 10,
    resume: Optional[ICPResume] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_extra_meta: Optional[dict] = None,
    **kwargs,
) -> RegistrationResult:
    """``icp_register`` dispatched ``chunk`` iterations at a time, the
    transform warm-started across dispatches (``ICPResume``).

    Produces the identical trajectory to a single whole-loop dispatch
    (same per-iteration math, same divergence-guard state at every
    boundary).  Bounded dispatches are the checkpointable unit for
    resumable long registrations (SURVEY §5.4): pass
    ``checkpoint_path`` to persist every chunk boundary — the final one
    included — to disk and to continue a killed run from its last
    boundary in a new process (``tpuslam.harness.checkpoint``).  A file
    that does not match this run (different cloud fingerprints, shapes,
    or loop parameters) is IGNORED with a notice and overwritten — it
    is some other registration's state, never a resumable one — so
    harness sweeps reusing one path stay correct.  A matching file
    whose progress already meets ``max_iterations`` returns its state
    as-is (idempotent re-run), with a notice when it overshoots the
    request."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    total = 0
    ckpt_meta = None
    if checkpoint_path is not None:
        from tpuslam.harness.checkpoint import load_resume_or_none

        ckpt_meta = _icp_ckpt_meta(
            before, after, eps, max_distance_squared,
            divergence_guard=bool(kwargs.get("divergence_guard", True)),
            extra=checkpoint_extra_meta,
        )
        loaded = load_resume_or_none(checkpoint_path, "icp", ckpt_meta)
        if loaded is not None:
            resume = loaded
            total = int(loaded.done_before)
        if (
            resume is not None
            and max_iterations != -1
            and total >= max_iterations
        ):
            if total > max_iterations:
                print(
                    f"[tpuslam] checkpoint already holds {total} "
                    f"iterations (requested {max_iterations}); "
                    f"returning its state"
                )
            return RegistrationResult(
                transform=RigidTransform(
                    rotation=jnp.asarray(resume.rotation, jnp.float32),
                    translation=jnp.asarray(
                        resume.translation, jnp.float32
                    ),
                    scale=jnp.float32(1.0),
                ),
                iterations=jnp.int32(total),
                error=jnp.asarray(resume.error, jnp.float32),
            )
    while True:
        if max_iterations == -1:
            k = chunk
        else:
            k = min(chunk, max_iterations - total)
        result = icp_register(
            before, after, eps=eps,
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
        if checkpoint_path is not None:
            from tpuslam.harness.checkpoint import save_icp_checkpoint

            save_icp_checkpoint(checkpoint_path, resume, ckpt_meta)
        # the loop body freezes the iteration counter when it stops
        # (converged / diverged / no correspondences), so an early stop
        # is exactly "fewer than the allowed k iterations ran"
        if did < k or (max_iterations != -1 and total >= max_iterations):
            break
    return RegistrationResult(
        transform=result.transform,
        iterations=jnp.int32(total),
        error=result.error,
    )


def icp_register_prealigned(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    subcloud_size: int = 1000,
    seed: int = 0,
    chunk: int = 0,
    checkpoint_path: Optional[str] = None,
    **kwargs,
) -> RegistrationResult:
    """ICP seeded by a one-shot NICP estimate (opt-in: ``icp-prealign``).

    No reference counterpart — an extension targeting ICP's known
    weakness: its basin of attraction shrinks with motion size, and the
    reference documents its convergence as "low, drops sharply with
    size" (``documentation.tex:584-591``; our measured grid fails mostly
    at rotation 0.6 rad / translation 30).  A single NICP principal-axes
    shot is cheap next to the ICP loop (it runs on subclouds) and lands
    inside the basin whenever the clouds' principal axes are resolvable;
    the unchanged ICP loop then refines from that transform through the
    same ``ICPResume`` warm-start carry chunked dispatch uses.

    The carried error is the cold-start sentinel (``basicicp.cpp:26``)
    for reporting, but the divergence guard is seeded with FLT_MAX
    exactly as a cold start seeds it: the NICP subcloud error is
    computed over a different point set (incomparable), and any absolute
    guard threshold (1e5 included) would falsely abort the first real
    iteration on large-coordinate-unit clouds.  The guard still
    protects from iteration 2 on — a diverging step reverts to the last
    accepted transform, at worst the NICP seed.
    """
    from tpuslam.algorithms.nicp import nicp_register

    extra_meta = {
        "prealign": True,
        "prealign_subcloud": int(subcloud_size),
        "prealign_seed": int(seed),
    }
    resume = None
    if checkpoint_path is not None:
        # a matching on-disk checkpoint holds post-seed progress that
        # supersedes a fresh NICP shot — load it up front so resumes
        # and idempotent re-runs never pay the seed computation (the
        # chunked driver re-validates the same file and prints any
        # mismatch notice, hence quiet here)
        from tpuslam.harness.checkpoint import load_resume_or_none

        resume = load_resume_or_none(
            checkpoint_path, "icp",
            _icp_ckpt_meta(
                before, after, eps, max_distance_squared,
                divergence_guard=bool(
                    kwargs.get("divergence_guard", True)
                ),
                extra=extra_meta,
            ),
            quiet=True,
        )
    if resume is None:
        pre = nicp_register(
            before, after, eps=eps, subcloud_size=subcloud_size,
            seed=seed, use_pallas=kwargs.get("use_pallas"),
        )
        resume = ICPResume(
            rotation=pre.transform.rotation,
            translation=pre.transform.translation,
            error=jnp.float32(1e5),  # reporting init, basicicp.cpp:26
            prev_error=FLT_MAX,  # cold-start guard seed
        )
    common = dict(
        eps=eps, max_distance_squared=max_distance_squared,
        max_iterations=max_iterations, resume=resume, **kwargs,
    )
    if chunk or checkpoint_path:
        # checkpointing requires the chunked driver (the chunk boundary
        # is the durable unit)
        return icp_register_chunked(
            before, after, chunk=chunk or 10,
            checkpoint_path=checkpoint_path,
            checkpoint_extra_meta=extra_meta, **common,
        )
    return icp_register(before, after, **common)
