"""Shared jittable geometry math: transforms, masked statistics, MSE.

These are the jnp equivalents of the reference's shared math in
``source/common/common.cpp`` — trivially fused by XLA, so no hand kernels.
Every reduction takes a validity mask so padded rows never perturb results
(SURVEY §7 "Padding vs statistics").
"""

from __future__ import annotations

import jax.numpy as jnp


def masked_mean(points: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Center of mass of the valid points (``common.cpp:281-284``)."""
    w = mask.astype(points.dtype)
    total = jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sum(points * w[:, None], axis=0) / total


def masked_mse(
    diff: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Mean over valid rows of the squared row norms
    (the elementwise overload, ``common.cpp:270-279``)."""
    w = mask.astype(diff.dtype)
    count = jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sum(jnp.sum(diff * diff, axis=-1) * w) / count


def mse_between(
    a: jnp.ndarray, b: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Masked mean squared distance between row-aligned clouds."""
    return masked_mse(a - b, mask)


def transform_points(
    points: jnp.ndarray,
    rotation: jnp.ndarray,
    translation: jnp.ndarray,
    scale=1.0,
) -> jnp.ndarray:
    """``p -> scale * (R @ p) + t`` (``common.cpp:39-55``).

    Exact f32 by construction: a ``[N,3] @ [3,3]`` matmul at default
    precision may take a reduced-precision (TF32) path, whose relative
    coordinate error biases every registration's optimum.  The
    per-coordinate FMA form is exact f32 and fuses into the downstream
    elementwise work."""
    x = points[..., 0]
    y = points[..., 1]
    z = points[..., 2]

    def entry(r, c):
        # trailing length-1 axis so explicitly-batched rotations
        # broadcast against the points' row axis
        return rotation[..., r, c][..., None]

    out = jnp.stack(
        [
            x * entry(0, 0) + y * entry(0, 1) + z * entry(0, 2),
            x * entry(1, 0) + y * entry(1, 1) + z * entry(1, 2),
            x * entry(2, 0) + y * entry(2, 1) + z * entry(2, 2),
        ],
        axis=-1,
    )
    return scale * out + translation


