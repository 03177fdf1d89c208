"""Sharded nearest-neighbor search: per-shard argmin + global combine.

The multi-chip form of the ICP hot loop (SURVEY §5.8): the target cloud is
sharded along the ``points`` axis; every device computes (min, argmin) of
its shard for ALL source points, then the global winner is resolved with
two ``pmin`` collectives — one on distances, one lexicographic on
global indices so the reference's FIRST-index-wins tie-break
(``common.cpp:416`` strict ``<``) is preserved across shards.  A third
``psum`` replicates the winning target coordinates so the 3x3 Procrustes
that follows runs replicated with no gather from remote shards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpuslam.parallel.mesh import POINTS_AXIS

BIG = jnp.float32(3.4e38)
IMAX = jnp.int32(2**31 - 1)


def lexmin_combine(
    dl: jnp.ndarray,
    il: jnp.ndarray,
    tgt_shard: jnp.ndarray,
    offset: jnp.ndarray,
    axis: str = POINTS_AXIS,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The cross-shard combine — THE cross-path contract of the sharded
    NN.  Runs INSIDE a shard_map body.

    ``dl``/``il``: this shard's exact local (sq_distance, local index) per
    source row, with no-match rows as (BIG, 0) per the NN contract so
    ``il`` always stays in range; ``offset``: this shard's global base
    index.  Among shards attaining the global pmin distance, the LOWEST
    global index wins (the reference's first-index tie-break,
    ``common.cpp:416`` strict ``<``).  A BIG distance can only win when
    every shard reports BIG, and then w=0 masks the pair downstream.
    Returns replicated (global_index i32[N], sq_distance f32[N],
    matched_points f32[N,3] — psum-gathered from the winning shard so no
    remote gather is needed).
    """
    dl = jnp.where(dl >= BIG, BIG, dl)
    gl = il + offset
    dmin = jax.lax.pmin(dl, axis)
    cand = jnp.where(dl == dmin, gl, IMAX)
    gmin = jax.lax.pmin(cand, axis)
    win = gmin == gl
    matched_local = jnp.where(win[:, None], tgt_shard[il], 0.0)
    matched = jax.lax.psum(matched_local, axis)
    return gmin, dmin, matched


def sharded_nn_combine(
    src: jnp.ndarray,
    tgt_shard: jnp.ndarray,
    tgt_count: jnp.ndarray,
    axis: str = POINTS_AXIS,
    use_pallas: Optional[bool] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Runs INSIDE a shard_map body.

    ``src``: replicated f32[N,3]; ``tgt_shard``: this device's f32[M/d,3]
    block; ``tgt_count``: replicated global valid count.  Returns replicated
    (global_index i32[N], sq_distance f32[N], matched_points f32[N,3]).
    The per-shard search is the single-device one
    (``tpuslam.ops.nearest_neighbors``: the kernel on the GPU).
    """
    from tpuslam.ops.nn import nearest_neighbors

    shard_size = tgt_shard.shape[0]
    offset = (jax.lax.axis_index(axis) * shard_size).astype(jnp.int32)
    # valid rows are a global prefix, so each shard's are a local prefix
    count_shard = jnp.clip(tgt_count - offset, 0, shard_size)
    il, dl = nearest_neighbors(
        src, tgt_shard, count_shard, use_pallas=use_pallas
    )
    return lexmin_combine(dl, il, tgt_shard, offset, axis)
