"""Batched multi-pair registration — register B cloud pairs in one jitted
call.

New scope vs the reference (single-pair binary; SURVEY §7 step 7 /
BASELINE "multi-pair batched registration"): production registration
workloads align many scan pairs at once, and a ``jax.vmap`` over the
pair axis turns B registrations into one compiled program whose per-pair
work batches onto the same kernels (the NN and CPD E-step kernels gain a
leading grid axis).

The underlying while-loops are vmap-safe: their bodies freeze finished
elements, so each pair's result is identical to a solo run (asserted in
tests), while the batch keeps stepping until the slowest pair converges.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.algorithms.icp import RegistrationResult, icp_register
from tpuslam.algorithms.nicp import nicp_register
from tpuslam.config.configuration import ApproximationType
from tpuslam.core.types import Cloud, pad_cloud, round_up


def stack_clouds(clouds: Sequence[np.ndarray], multiple: int = 128) -> Cloud:
    """Pad a list of host ``f32[N_i, 3]`` arrays to a common lane-aligned
    size and stack into a batched Cloud (``points`` f32[B, Npad, 3],
    ``count`` i32[B])."""
    if not clouds:
        raise ValueError("empty cloud batch")
    npad = max(round_up(max(len(c), 1), multiple) for c in clouds)
    padded = [pad_cloud(c, multiple=npad) for c in clouds]
    return Cloud(
        points=jnp.stack([p.points for p in padded]),
        count=jnp.stack([p.count for p in padded]),
    )


# Lowering choice for icp_register_batch: small pairs vmap the
# while_loop (tiny per-pair kernels batch onto one grid); large pairs
# unroll solo bodies per pair in one program, which also restores
# per-pair early exit (a vmapped batch steps until the slowest pair
# converges).  Program size grows with B, so the AUTO selection is
# capped at _UNROLL_MAX_B; an explicit ``unroll=True`` is honored for
# any B.  The break-even pair size was set on an earlier platform and
# has not been measured on the GPU yet.
_UNROLL_MAX_B = 32
_UNROLL_MIN_PAIRWORK = 8192 * 8192  # N*M per pair (break-even)


@partial(jax.jit, static_argnames=("divergence_guard", "unroll"))
def icp_register_batch(
    befores: Cloud,
    afters: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    unroll: bool | None = None,
) -> RegistrationResult:
    """``icp_register`` over the leading pair axis — ONE jitted program
    either way; ``unroll`` (default: auto by the crossover above) picks
    between vmapping the while_loop and unrolling solo bodies per
    pair."""
    if unroll is None:
        b, n = befores.points.shape[0], befores.points.shape[1]
        m = afters.points.shape[1]
        unroll = b <= _UNROLL_MAX_B and n * m >= _UNROLL_MIN_PAIRWORK
    if unroll:
        outs = []
        for p in range(befores.points.shape[0]):
            r = icp_register(
                Cloud(befores.points[p], befores.count[p]),
                Cloud(afters.points[p], afters.count[p]),
                eps=eps,
                max_distance_squared=max_distance_squared,
                max_iterations=max_iterations,
                use_pallas=None,
                divergence_guard=divergence_guard,
            )
            # strip the optional carries (history/nn/em) so both
            # lowerings return the same structure
            outs.append(
                RegistrationResult(r.transform, r.iterations, r.error)
            )
        return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    fn = partial(
        icp_register,
        eps=eps,
        max_distance_squared=max_distance_squared,
        max_iterations=max_iterations,
        use_pallas=None,
        divergence_guard=divergence_guard,
    )
    return jax.vmap(fn)(befores, afters)


@partial(
    jax.jit, static_argnames=("approximation_type", "subcloud_size")
)
def nicp_register_batch(
    befores: Cloud,
    afters: Cloud,
    eps: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    subcloud_size: int = 1000,
    seed: int = 0,
) -> RegistrationResult:
    """vmapped ``nicp_register`` over the leading pair axis."""
    fn = partial(
        nicp_register,
        eps=eps,
        approximation_type=approximation_type,
        subcloud_size=subcloud_size,
        seed=seed,
        use_pallas=None,  # auto: the kernel on the GPU, batched by vmap
    )
    return jax.vmap(fn)(befores, afters)


@partial(
    jax.jit,
    static_argnames=(
        "const_scale", "approximation_type", "use_fgt", "fgt_k",
        "order_of_truncation", "centroid_init",
    ),
)
def cpd_register_batch(
    befores: Cloud,
    afters: Cloud,
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
    centroid_init: bool = False,
) -> RegistrationResult:
    """vmapped ``cpd_register`` over the leading pair axis — every
    trajectory-determining knob of the solo path is accepted, so each
    pair's result equals its solo run."""
    from tpuslam.algorithms.cpd import cpd_register

    fn = partial(
        cpd_register,
        eps=eps,
        weight=weight,
        const_scale=const_scale,
        max_iterations=max_iterations,
        tolerance=tolerance,
        approximation_type=approximation_type,
        use_fgt=use_fgt,
        fgt_k=fgt_k,
        order_of_truncation=order_of_truncation,
        ratio_of_far_field=ratio_of_far_field,
        centroid_init=centroid_init,
        use_pallas=None,  # auto: the kernel on the GPU, batched by vmap
    )
    return jax.vmap(fn)(befores, afters)


@partial(
    jax.jit,
    static_argnames=("subcloud_size", "divergence_guard", "unroll"),
)
def icp_register_prealigned_batch(
    befores: Cloud,
    afters: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    subcloud_size: int = 1000,
    seed: int = 0,
    divergence_guard: bool = True,
    unroll: bool | None = None,
) -> RegistrationResult:
    """Batched ``icp_register_prealigned``: one NICP shot per pair seeds
    each pair's ICP loop through a batched ``ICPResume`` (rotation
    ``f32[B,3,3]``, translation ``f32[B,3]``, cold-start error sentinel —
    same semantics as the single-pair path, one compiled program)."""
    from tpuslam.algorithms.icp import FLT_MAX, ICPResume

    pre = nicp_register_batch(
        befores, afters, eps=eps, subcloud_size=subcloud_size, seed=seed
    )
    b = befores.points.shape[0]
    resume = ICPResume(
        rotation=pre.transform.rotation,
        translation=pre.transform.translation,
        error=jnp.full((b,), 1e5, jnp.float32),  # reporting init
        done_before=jnp.zeros((b,), jnp.int32),
        # guard seed = cold start; an absolute threshold would freeze
        # large-unit pairs at the raw NICP seed (see single-pair path)
        prev_error=jnp.full((b,), FLT_MAX, jnp.float32),
    )
    fn = partial(
        icp_register,
        eps=eps,
        max_distance_squared=max_distance_squared,
        max_iterations=max_iterations,
        use_pallas=None,
        divergence_guard=divergence_guard,
    )
    # same lowering crossover as icp_register_batch: large pairs
    # unroll the solo bodies into this one jitted program
    if unroll is None:
        n, m = befores.points.shape[1], afters.points.shape[1]
        unroll = b <= _UNROLL_MAX_B and n * m >= _UNROLL_MIN_PAIRWORK
    if unroll:
        outs = []
        for p in range(b):
            r = fn(
                Cloud(befores.points[p], befores.count[p]),
                Cloud(afters.points[p], afters.count[p]),
                resume=jax.tree.map(lambda x: x[p], resume),
            )
            outs.append(
                RegistrationResult(r.transform, r.iterations, r.error)
            )
        return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    return jax.vmap(
        lambda bb, aa, rr: fn(bb, aa, resume=rr)
    )(befores, afters, resume)
