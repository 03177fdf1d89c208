"""Device mesh construction and cloud sharding.

New scope vs the reference (single-GPU, no communication backend —
SURVEY §2.6.5): scale registration across the GPUs of one host by
sharding the TARGET cloud along a 1-D ``"points"`` mesh axis while the
moving cloud and the 3x3 transform state stay replicated.  All cross-card
traffic is XLA collectives (``psum``/``pmin``) issued from ``shard_map``
bodies, which XLA hands to NCCL; NVLink joins every card to every other
at the same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuslam.core.types import Cloud, pad_cloud

POINTS_AXIS = "points"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (POINTS_AXIS,))


def shard_cloud(points: np.ndarray, mesh: Mesh) -> Cloud:
    """Pad a host ``f32[N, 3]`` array so every device gets an equal
    lane-aligned block, and place it sharded along the points axis."""
    n_dev = mesh.devices.size
    cloud = pad_cloud(points, multiple=128 * n_dev)
    sharding = NamedSharding(mesh, P(POINTS_AXIS, None))
    return Cloud(
        points=jax.device_put(cloud.points, sharding),
        count=jax.device_put(
            cloud.count, NamedSharding(mesh, P())
        ),
    )


def replicate_cloud(points: np.ndarray, mesh: Mesh) -> Cloud:
    """Pad and replicate a cloud on every device of the mesh."""
    cloud = pad_cloud(points, multiple=128)
    rep = NamedSharding(mesh, P())
    return Cloud(
        points=jax.device_put(cloud.points, rep),
        count=jax.device_put(cloud.count, rep),
    )
