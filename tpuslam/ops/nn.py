"""Nearest-neighbor correspondence search — the ICP hot loop.

Replacement for the reference's brute-force NN (CPU ``common.cpp:399-515``;
CUDA kernel ``FindCorrespondences``, ``cudacommon.cu:57-77``).
Tie-breaking matches the reference: the FIRST (lowest) target index wins
(strict ``<`` scan, ``common.cpp:416``).

Two implementations behind one signature, chosen by
``tpuslam.core.device.select``:

* ``nearest_neighbors_ref`` — chunked jnp (XLA-fused); the behavioral
  oracle and the CPU path.
* ``pallas_nn.nearest_neighbors_pallas`` — the fused Triton kernel (GPU).

Invalid target rows (index >= count) never win; if a source row is padding,
its result is arbitrary — callers mask by the source validity mask.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpuslam.core.device import select

BIG = jnp.float32(3.4e38)


def _chunk_nn(
    src_chunk: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_invalid: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    # exact f32 per-coordinate form, the same value as the kernel's so
    # argmins agree.  The algebraic shortcut |a|^2+|b|^2-2ab cancels
    # catastrophically (NN distances are far below the norms) and
    # near-tie argmins flip ~10-20% at realistic densities between
    # formulations — the formulation IS the contract.
    d = (src_chunk[:, 0:1] - tgt[:, 0][None, :]) ** 2
    d += (src_chunk[:, 1:2] - tgt[:, 1][None, :]) ** 2
    d += (src_chunk[:, 2:3] - tgt[:, 2][None, :]) ** 2
    d = jnp.where(tgt_invalid[None, :], BIG, d)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.min(d, axis=1)
    return idx, best


def chunked_nn(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_invalid: jnp.ndarray,
    chunk: int = 2048,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``_chunk_nn`` over fixed source chunks so the (chunk, M) distance
    tile stays bounded regardless of N."""
    n = src.shape[0]
    if n <= chunk:
        return _chunk_nn(src, tgt, tgt_invalid)
    pad = (-n) % chunk
    src_p = jnp.pad(src, ((0, pad), (0, 0)))
    src_c = src_p.reshape(n // chunk + (1 if pad else 0), chunk, 3)
    idx, dist = jax.lax.map(lambda s: _chunk_nn(s, tgt, tgt_invalid), src_c)
    return idx.reshape(-1)[:n], dist.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("chunk",))
def nearest_neighbors_ref(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_count: jnp.ndarray,
    chunk: int = 2048,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """For each source row, the index and squared distance of the nearest
    valid target row.  ``src``: f32[N,3], ``tgt``: f32[M,3] (padded),
    ``tgt_count``: i32[] count of valid targets.  Returns (i32[N], f32[N]).

    No-match contract (zero valid targets): ``(idx=0, dist=BIG)`` —
    argmin over an all-``BIG`` row.  The kernel normalizes to the same
    values.
    """
    m = tgt.shape[0]
    tgt_invalid = jnp.arange(m, dtype=jnp.int32) >= tgt_count
    return chunked_nn(src, tgt, tgt_invalid, chunk)


def nearest_neighbors(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_count: jnp.ndarray,
    use_pallas: Optional[bool] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dispatching front: the Triton kernel on the GPU, chunked jnp on the
    CPU (``tpuslam.core.device.select``).  Both batch under ``jax.vmap``."""
    from tpuslam.kernels import pallas_nn

    fn = select(
        pallas_nn.nearest_neighbors_pallas, nearest_neighbors_ref,
        use_pallas,
    )
    return fn(src, tgt, tgt_count)
