"""Core array types for the registration engine.

The reference represents clouds as ``std::vector<Point_f>`` (a 3-float POD,
``point.h:5-89``).  Here a cloud is a dense ``f32[N, 3]`` array.  XLA needs
static shapes, so clouds are padded to a fixed multiple and carry the
count of valid points; every reduction threads the validity mask through so
padded rows never perturb centroids, moments, errors or argmins.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Padding granule: clouds are padded to multiples of this so a run's
# shapes (and compiled programs) repeat across nearby cloud sizes.
LANE = 128


class RigidTransform(NamedTuple):
    """A rigid (optionally scaled) transform ``p -> scale * (R @ p) + t``.

    Mirrors the reference's ``pair<glm::mat3, glm::vec3>`` result plus CPD's
    scalar scale (``common.cpp:51-55``).  ``rotation`` is row-major: row r,
    col c of the mathematical matrix R, so points transform as
    ``points @ R.T * scale + t``.
    """

    rotation: jnp.ndarray  # f32[3, 3]
    translation: jnp.ndarray  # f32[3]
    scale: jnp.ndarray  # f32[] scalar

    @staticmethod
    def identity(dtype=jnp.float32) -> "RigidTransform":
        return RigidTransform(
            rotation=jnp.eye(3, dtype=dtype),
            translation=jnp.zeros((3,), dtype=dtype),
            scale=jnp.ones((), dtype=dtype),
        )

    def apply(self, points: jnp.ndarray) -> jnp.ndarray:
        """Transform ``f32[..., 3]`` points: ``scale * (R @ p) + t``."""
        from tpuslam.ops.geometry import transform_points

        # exact-f32 application (see transform_points: a reduced-
        # precision matmul path measurably biases registration optima)
        return transform_points(
            points, self.rotation, self.translation, self.scale
        )

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Return ``self ∘ other`` (apply ``other`` first, then ``self``).

        Homogeneous composition — the correct form the reference's GPU ICP
        uses (mat4 product, ``icpcuda.cu:35``).  The CPU ICP's additive
        translation (``basicicp.cpp:43-44``) is an approximation we do not
        reproduce (documented divergence, SURVEY §2.7).
        """
        hi = jax.lax.Precision.HIGHEST
        return RigidTransform(
            rotation=jnp.matmul(self.rotation, other.rotation, precision=hi),
            translation=self.scale
            * jnp.matmul(self.rotation, other.translation, precision=hi)
            + self.translation,
            scale=self.scale * other.scale,
        )


class Cloud(NamedTuple):
    """A padded point cloud: ``points`` is ``f32[Npad, 3]``, ``count`` the
    number of valid leading rows (padded rows are zeros)."""

    points: jnp.ndarray  # f32[Npad, 3]
    count: jnp.ndarray  # i32[] scalar — number of valid points

    @property
    def padded_size(self) -> int:
        return self.points.shape[0]

    def mask(self, dtype=jnp.float32) -> jnp.ndarray:
        """``dtype[Npad]`` validity mask: 1 for real points, 0 for padding."""
        idx = jnp.arange(self.points.shape[0])
        return (idx < self.count).astype(dtype)


def round_up(n: int, multiple: int = LANE) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pick_block(n: int, prefer=(1024, 512, 256, 128)) -> int:
    """Largest preferred block size dividing ``n`` (``n`` itself when
    none divides) — the tile size of the blocked jnp E-step."""
    for b in prefer:
        if n % b == 0:
            return b
    return n


def pad_cloud(points: np.ndarray, multiple: int = LANE) -> Cloud:
    """Pad an ``f32[N, 3]`` host array to a multiple-of-``multiple`` Cloud."""
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {points.shape}")
    n = points.shape[0]
    npad = max(round_up(max(n, 1), multiple), multiple)
    out = np.zeros((npad, 3), dtype=np.float32)
    out[:n] = points
    return Cloud(points=jnp.asarray(out), count=jnp.asarray(n, dtype=jnp.int32))


def unpad(cloud: Cloud) -> np.ndarray:
    """Return the valid points of a Cloud as a host ``f32[N, 3]`` array."""
    n = int(cloud.count)
    return np.asarray(cloud.points)[:n]
