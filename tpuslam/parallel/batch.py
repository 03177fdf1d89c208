"""Mesh-parallel multi-pair registration: shard the PAIR axis.

The second scaling axis (SURVEY §7 step 7 "pmap-of-pairs"): where
``tpuslam.parallel.icp`` shards one big problem's target cloud across
chips, this layer shards a BATCH of independent pairs — each device runs
the full single-device registration for its slice of pairs (vmapped
locally), with no cross-chip communication at all.  Together they cover
both production regimes: few huge clouds (shard points) and many moderate
clouds (shard pairs).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.algorithms.icp import RegistrationResult, icp_register
from tpuslam.core.types import Cloud
from tpuslam.parallel.mesh import POINTS_AXIS


def shard_pairs(batched: Cloud, mesh: Mesh) -> Cloud:
    """Place a stacked Cloud (points f32[B, Npad, 3], count i32[B]) with
    the pair axis sharded over the mesh.  B must divide by the device
    count (pad with duplicate pairs if needed)."""
    n_dev = mesh.devices.size
    if batched.points.shape[0] % n_dev != 0:
        raise ValueError(
            f"pair count {batched.points.shape[0]} must divide the "
            f"{n_dev}-device mesh; pad the batch"
        )
    return Cloud(
        points=jax.device_put(
            batched.points, NamedSharding(mesh, P(POINTS_AXIS, None, None))
        ),
        count=jax.device_put(
            batched.count, NamedSharding(mesh, P(POINTS_AXIS))
        ),
    )


@lru_cache(maxsize=16)
def _build(mesh: Mesh, divergence_guard: bool):
    def local(b_pts, b_cnt, a_pts, a_cnt, eps, max_d2, max_iterations):
        def one(bp, bc, ap, ac):
            res = icp_register(
                Cloud(bp, bc), Cloud(ap, ac),
                eps=eps, max_distance_squared=max_d2,
                max_iterations=max_iterations,
                # auto: the vmapped kernel on the GPU, vmapped jnp
                # tiles on CPU test meshes
                use_pallas=None,
                divergence_guard=divergence_guard,
            )
            return (
                res.transform.rotation, res.transform.translation,
                res.iterations, res.error,
            )

        return jax.vmap(one)(b_pts, b_cnt, a_pts, a_cnt)

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(POINTS_AXIS, None, None), P(POINTS_AXIS),
            P(POINTS_AXIS, None, None), P(POINTS_AXIS),
            P(), P(), P(),
        ),
        out_specs=(
            P(POINTS_AXIS, None, None), P(POINTS_AXIS, None),
            P(POINTS_AXIS), P(POINTS_AXIS),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def icp_register_pairs_sharded(
    befores: Cloud,
    afters: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
) -> RegistrationResult:
    """Batched ICP with pairs sharded over the mesh (inputs from
    ``stack_clouds`` + ``shard_pairs``)."""
    from tpuslam.core.types import RigidTransform

    fn = _build(mesh, divergence_guard)
    rotation, translation, iterations, error = fn(
        befores.points, befores.count, afters.points, afters.count,
        jnp.float32(eps), jnp.float32(max_distance_squared),
        jnp.int32(max_iterations),
    )
    b = rotation.shape[0]
    return RegistrationResult(
        transform=RigidTransform(
            rotation=rotation,
            translation=translation,
            scale=jnp.ones((b,), jnp.float32),
        ),
        iterations=iterations,
        error=error,
    )
