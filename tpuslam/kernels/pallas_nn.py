"""Pallas (Triton route) kernel: fused nearest-neighbor (min, argmin).

The GPU form of the reference's ``FindCorrespondences`` CUDA kernel (one
thread per source point scanning all M targets, ``cudacommon.cu:57-77``):
a 1-D grid over source blocks of ``BLOCK_SRC`` rows.  Each program keeps
its source coordinates in registers and loops over the whole target cloud
in ``BLOCK_TGT``-row tiles read from a coordinate-major ``[3, M]`` copy,
so no distance ever reaches device memory.

Inside the loop the program keeps an elementwise ``[BLOCK_SRC,
BLOCK_TGT]`` running minimum and the tile index that produced it (a
strict ``<`` keeps the earlier tile on ties).  The one cross-column
reduction runs after the loop: the smallest distance, then the lowest
global index attaining it.  That is the reference's first-index
tie-break (strict ``<`` scan, ``common.cpp:416``), with no reduction in
the inner loop.

Numerics: the exact f32 per-coordinate form of ``tpuslam.ops.nn`` (the
``|a|^2+|b|^2-2ab`` matmul shortcut cancels catastrophically at NN
distances, and it would run in TF32 on the tensor cores).

Invalid target rows (index >= count, and the wrapper's own padding) sit
at a far sentinel coordinate, so their distances (~3e38, or inf)
exceed any real one; the wrapper maps that range back to the oracle's
exact no-match value ``(idx=0, dist=BIG)``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpuslam.core.types import round_up

BIG = 3.4e38  # Python literals: jnp scalars would be captured consts
IMAX = 2**31 - 1
SENTINEL = 1e19
_SENTINEL_DIST = 1e37  # any distance this large can only be a sentinel

# 64 x 64 with 4 warps was the fastest of five block configurations on
# an H100 at 102,400 and 1,375,028 points (PERF.md)
BLOCK_SRC = 64
BLOCK_TGT = 64
NUM_WARPS = 4


def _nn_kernel(srcT_ref, tgtT_ref, dist_ref, idx_ref, *, block_tgt):
    sx = srcT_ref[0, :][:, None]
    sy = srcT_ref[1, :][:, None]
    sz = srcT_ref[2, :][:, None]
    bs = sx.shape[0]
    n_tiles = tgtT_ref.shape[1] // block_tgt

    def body(j, carry):
        best_d, best_j = carry
        cols = pl.ds(pl.multiple_of(j * block_tgt, block_tgt), block_tgt)
        tx = tgtT_ref[0, cols][None, :]
        ty = tgtT_ref[1, cols][None, :]
        tz = tgtT_ref[2, cols][None, :]
        d = (sx - tx) ** 2
        d += (sy - ty) ** 2
        d += (sz - tz) ** 2
        better = d < best_d
        return jnp.where(better, d, best_d), jnp.where(better, j, best_j)

    init = (
        jnp.full((bs, block_tgt), jnp.inf, jnp.float32),
        jnp.zeros((bs, block_tgt), jnp.int32),
    )
    best_d, best_j = jax.lax.fori_loop(0, n_tiles, body, init)
    dmin = jnp.min(best_d, axis=1)
    col = jax.lax.broadcasted_iota(jnp.int32, (bs, block_tgt), 1)
    gidx = jnp.where(
        best_d == dmin[:, None], best_j * block_tgt + col, IMAX
    )
    dist_ref[...] = dmin
    idx_ref[...] = jnp.min(gidx, axis=1)


@functools.partial(jax.jit, static_argnames=("interpret",))
def nearest_neighbors_pallas(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    tgt_count: jnp.ndarray,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same contract as ``tpuslam.ops.nn.nearest_neighbors_ref``:
    (i32[N] index of nearest valid target, f32[N] squared distance).
    Any row counts are accepted: inputs are padded internally to block
    multiples and outputs sliced back.  ``jax.vmap`` batches it (the
    pallas_call gains a leading grid axis)."""
    n0, m0 = src.shape[0], tgt.shape[0]
    block_src, block_tgt = BLOCK_SRC, BLOCK_TGT
    n = round_up(max(n0, 1), block_src)
    m = round_up(max(m0, 1), block_tgt)
    src_t = jnp.pad(src, ((0, n - n0), (0, 0))).T
    row_invalid = jnp.arange(m, dtype=jnp.int32) >= jnp.minimum(
        jnp.asarray(tgt_count, jnp.int32), m0
    )
    tgt_t = jnp.where(
        row_invalid[None, :], SENTINEL,
        jnp.pad(tgt, ((0, m - m0), (0, 0))).T,
    )
    dist, idx = pl.pallas_call(
        functools.partial(_nn_kernel, block_tgt=block_tgt),
        grid=(n // block_src,),
        in_specs=[
            pl.BlockSpec((3, block_src), lambda i: (0, i)),
            pl.BlockSpec((3, m), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((block_src,), lambda i: (i,)),
            pl.BlockSpec((block_src,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=2
        ),
        interpret=interpret,
        name="nn_argmin",
    )(src_t, tgt_t)
    no_match = dist >= _SENTINEL_DIST
    dist = jnp.where(no_match, BIG, dist)
    idx = jnp.where(no_match, 0, idx)
    return idx[:n0], dist[:n0]
