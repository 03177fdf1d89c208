"""Pallas (Triton route) kernels: CPD E-step sufficient statistics.

The GPU form of the reference's E-step (a host loop of per-row launches,
``cpdcuda.cu:80-116``) as two fused passes that never write the N x M
responsibility matrix to device memory (the reference's own
sufficient-statistics strategy, ``cudaprobabilities.h:19-30``):

* **Pass 1 (denominators)**: a grid over target blocks.  Each program
  loops over all moving tiles and accumulates
  ``denom[j] = sum_k exp(-d_kj^2 / 2 sigma^2) + c`` for its targets.
* **Pass 2 (moments)**: a grid over moving blocks.  Each program loops
  over all target tiles and accumulates ``[p1, px] = G @ [1/denom,
  x/denom]`` for its moving points.  The Gaussian tile is recomputed
  (flash-attention style), which is cheaper than storing it.

Each program owns its output rows, so neither pass needs atomics or a
carry between blocks.  The loops keep elementwise ``[rows, tile]``
accumulators and reduce across the tile once, after the loop.

Distances use the exact f32 per-coordinate form (the matmul shortcut
cancels catastrophically once ``2 sigma^2`` is small, and would run in
TF32).  Raw ``exp`` is safe: exponents are <= 0, and the denominator is
floored by the uniform constant (``coherentpointdrift.cpp:204``).
Truncation (``coherentpointdrift.cpp:191-196``) zeroes terms whose
exponent is below ``log(truncate)``; it enters as a threshold that is
``-inf`` when truncation is off.

Padded moving rows sit at a far sentinel coordinate (their Gaussian
underflows to exactly 0); padded target rows carry zero weights and are
masked out of pt1 and the error.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpuslam.algorithms.cpd import Sufficient
from tpuslam.core.types import round_up

# moving-cloud padding sentinel: far enough that exp underflows to 0 for
# any plausible sigma, near enough that d^2 stays finite in f32
SENTINEL = 1e15

# 32 rows x 64-column tiles with 4 warps was the fastest of five block
# configurations on an H100 at 20,480 and 376,832 points (PERF.md)
BLOCK_ROWS = 32
BLOCK_TILE = 64
NUM_WARPS = 4


def _gauss(ax, ay, az, bx, by, bz, mult, thresh):
    d = (ax - bx) ** 2
    d += (ay - by) ** 2
    d += (az - bz) ** 2
    expo = mult * d
    return jnp.where(expo < thresh, 0.0, jnp.exp(expo))


def _denom_kernel(sc_ref, xT_ref, yT_ref, denom_ref, *, block_tile):
    """One program: ``denom`` for its target rows over all moving rows."""
    mult, const, thresh = sc_ref[0], sc_ref[1], sc_ref[2]
    ax = xT_ref[0, :][:, None]
    ay = xT_ref[1, :][:, None]
    az = xT_ref[2, :][:, None]
    rows = ax.shape[0]

    def body(k, acc):
        cols = pl.ds(pl.multiple_of(k * block_tile, block_tile), block_tile)
        return acc + _gauss(
            ax, ay, az,
            yT_ref[0, cols][None, :], yT_ref[1, cols][None, :],
            yT_ref[2, cols][None, :], mult, thresh,
        )

    acc = jax.lax.fori_loop(
        0, yT_ref.shape[1] // block_tile, body,
        jnp.zeros((rows, block_tile), jnp.float32),
    )
    denom_ref[...] = jnp.sum(acc, axis=1) + const


def _moments_kernel(sc_ref, yT_ref, xT_ref, w_ref, acc_ref, *, block_tile):
    """One program: ``[p1, px]`` for its moving rows over all targets."""
    mult, thresh = sc_ref[0], sc_ref[2]
    ax = yT_ref[0, :][:, None]
    ay = yT_ref[1, :][:, None]
    az = yT_ref[2, :][:, None]
    rows = ax.shape[0]

    def body(k, accs):
        cols = pl.ds(pl.multiple_of(k * block_tile, block_tile), block_tile)
        g = _gauss(
            ax, ay, az,
            xT_ref[0, cols][None, :], xT_ref[1, cols][None, :],
            xT_ref[2, cols][None, :], mult, thresh,
        )
        return tuple(
            a + g * w_ref[c, cols][None, :] for c, a in enumerate(accs)
        )

    zero = jnp.zeros((rows, block_tile), jnp.float32)
    accs = jax.lax.fori_loop(
        0, xT_ref.shape[1] // block_tile, body, (zero,) * 4
    )
    for c in range(4):
        acc_ref[c, :] = jnp.sum(accs[c], axis=1)


def _call(kernel, grid, in_specs, out_spec, out_shape, interpret, name):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_spec,
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=2
        ),
        interpret=interpret,
        name=name,
    )


@functools.partial(jax.jit, static_argnames=("truncate", "interpret"))
def cpd_estep_pallas(
    transformed: jnp.ndarray,
    moving_mask: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    sigma2: jnp.ndarray,
    constant: jnp.ndarray,
    trunc_active: jnp.ndarray,
    truncate: float = 1e-3,
    interpret: bool = False,
) -> Sufficient:
    """Drop-in replacement for ``tpuslam.algorithms.cpd.cpd_estep``
    (``ComputePMatrix``, ``coherentpointdrift.cpp:167-221``).  Any row
    counts are accepted (padded internally to block multiples); masks
    are arbitrary 0/1 vectors.  ``jax.vmap`` batches it."""
    m0, n0 = transformed.shape[0], target.shape[0]
    rows, tile = BLOCK_ROWS, BLOCK_TILE
    m = round_up(max(m0, 1), max(rows, tile))
    n = round_up(max(n0, 1), max(rows, tile))
    mmask = jnp.pad(moving_mask, (0, m - m0))
    tmask = jnp.pad(target_mask, (0, n - n0))
    y_t = jnp.where(
        mmask[None, :] > 0, jnp.pad(transformed, ((0, m - m0), (0, 0))).T,
        SENTINEL,
    )
    x_t = jnp.pad(target, ((0, n - n0), (0, 0))).T
    sigma2 = jnp.asarray(sigma2, jnp.float32)
    constant = jnp.asarray(constant, jnp.float32)
    thresh = jnp.where(
        jnp.asarray(trunc_active), jnp.float32(math.log(truncate)),
        -jnp.inf,
    )
    scalars = jnp.stack([-0.5 / sigma2, constant, thresh])

    scalar_spec = pl.BlockSpec((3,), lambda i: (0,))
    denom = _call(
        functools.partial(_denom_kernel, block_tile=tile),
        (n // rows,),
        [scalar_spec,
         pl.BlockSpec((3, rows), lambda i: (0, i)),
         pl.BlockSpec((3, m), lambda i: (0, 0))],
        pl.BlockSpec((rows,), lambda i: (i,)),
        jax.ShapeDtypeStruct((n,), jnp.float32),
        interpret, "cpd_estep_denom",
    )(scalars, x_t, y_t)

    pt1 = (1.0 - constant / denom) * tmask
    inv_denom = tmask / denom
    w4 = jnp.concatenate([inv_denom[None, :], x_t * inv_denom[None, :]])

    acc = _call(
        functools.partial(_moments_kernel, block_tile=tile),
        (m // rows,),
        [scalar_spec,
         pl.BlockSpec((3, rows), lambda i: (0, i)),
         pl.BlockSpec((3, n), lambda i: (0, 0)),
         pl.BlockSpec((4, n), lambda i: (0, 0))],
        pl.BlockSpec((4, rows), lambda i: (0, i)),
        jax.ShapeDtypeStruct((4, m), jnp.float32),
        interpret, "cpd_estep_moments",
    )(scalars, y_t, x_t, w4)

    p1 = acc[0] * mmask
    px = acc[1:4].T * mmask[:, None]
    err = (
        -jnp.sum(jnp.log(denom) * tmask)
        + 3.0 * jnp.sum(tmask) * jnp.log(sigma2) / 2.0
    )
    return Sufficient(p1=p1[:m0], pt1=pt1[:n0], px=px[:m0], error=err)
