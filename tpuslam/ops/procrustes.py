"""Weighted Procrustes (rigid least-squares) via 3x3 SVD.

The TPU-native redesign of the reference's ``LeastSquaresSVD``
(``common.cpp:517-552``) and its CUDA twin (``cudacommon.cu:168-253``):
instead of compacting matched pairs into variable-length vectors, the
cross-covariance is a weighted einsum with weights in {0,1} (and arbitrary
soft weights for CPD) so shapes stay static.  The determinant correction
``R = U diag(1,1,det(U V^T)) V^T`` alone guarantees a proper rotation; no
sign gymnastics on U/V columns are needed (the reference's hand sign-flips,
``cudacommon.cu:229-234``, are a cuSOLVER-vs-Eigen artifact — SURVEY §2.7).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def svd_rotation(h: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Proper rotation nearest to the 3x3 cross-covariance ``h``.

    Returns ``(R, s)`` where ``s`` are the singular values (CPD's M-step
    needs them for the scale update).  ``h[r, c] = sum_i w_i a_i[r] b_i[c]``
    maps ``b`` (before) onto ``a`` (after): ``a ≈ R @ b``.
    """
    u, s, vt = jnp.linalg.svd(h, full_matrices=False)
    det = jnp.linalg.det(jnp.matmul(u, vt, precision=jax.lax.Precision.HIGHEST))
    d = jnp.array([1.0, 1.0, 0.0], dtype=h.dtype) + jnp.array(
        [0.0, 0.0, 1.0], dtype=h.dtype
    ) * det
    r = jnp.matmul(u * d[None, :], vt, precision=jax.lax.Precision.HIGHEST)
    return r, s


def weighted_procrustes(
    before: jnp.ndarray,
    after: jnp.ndarray,
    weights: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rigid (R, t) minimizing ``sum_i w_i |R b_i + t - a_i|^2``.

    ``before``/``after`` are row-aligned ``f32[N, 3]``; ``weights`` is
    ``f32[N]`` (zeros drop correspondences — the masked replacement for the
    reference's pair compaction at ``common.cpp:433-438``).
    """
    w = weights.astype(before.dtype)
    total = jnp.maximum(jnp.sum(w), 1e-12)
    mu_b = jnp.sum(before * w[:, None], axis=0) / total
    mu_a = jnp.sum(after * w[:, None], axis=0) / total
    bc = before - mu_b
    ac = after - mu_a
    # H = sum_i w_i ac_i bc_i^T  — matches alignedAfter * alignedBefore^T
    # (3xN by Nx3) at common.cpp:530
    # full f32 precision: a reduced-precision (TF32) matmul pass is too
    # coarse for a 3x3 cross-covariance feeding an SVD
    h = jnp.einsum(
        "n,nr,nc->rc", w, ac, bc, precision=jax.lax.Precision.HIGHEST
    )
    r, _ = svd_rotation(h)
    t = mu_a - jnp.matmul(r, mu_b, precision=jax.lax.Precision.HIGHEST)
    return r, t
