"""Fast Gauss Transform (Greengard-Strain, truncated Taylor form).

Capability equivalent of the reference's CPU FGT (``fgt.cpp``, adapted
Sebastien Paris code) approximating ``v_m = sum_n w_n exp(-|y_m - x_n|^2 /
sigma^2)`` in O(N + M) instead of O(N M), redesigned for TPU:

* **K-center clustering** (``KCenter``, ``fgt.cpp:147-207``): farthest-
  point selection starting from index 1 (the reference's deterministic
  seed), as a ``lax.fori_loop`` carrying the running (distance-to-nearest-
  center, assignment) arrays; centers are segment means.
* **Monomial products**: the reference builds graded-lexicographic Taylor
  monomials ``dy^alpha`` with an in-place heads/tails pointer recurrence
  (``fgt.cpp:122-137, 209-260``).  Here the multi-index table ``alpha``
  (pd x 3, pd = C(p+2, 3)) is precomputed on the host in the SAME graded-
  lex order, and the products are a static-gather product of per-dimension
  power tables — vectorized over points, no data-dependent control flow.
* **Source expansion** ``A_k`` (``ComputeA_k``, ``fgt.cpp:262-303``):
  ``segment_sum`` of ``w_n * prods_n`` over cluster assignments, scaled by
  the constants ``C_alpha = 2^|alpha| / alpha!`` (``ComputeC_k``).
* **Prediction** (``ComputeFGTPredict``, ``fgt.cpp:84-145``): dense
  (target-chunk x K-centers) evaluation with the far-field cutoff
  ``|dy|^2 > e_param`` applied as a mask instead of a branch skip.

Divergence (documented): the reference resizes K per EM iteration
(``K = min(N, M, 50 + sigma0^2/sigma^2)``, ``cpdutils.cpp:35``); XLA needs
static shapes, so callers pick a static K >= that bound (more centers only
improve the approximation).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DIM = 3


def n_choose_k(n: int, k: int) -> int:
    return math.comb(n, k)


def pd_size(p: int) -> int:
    """Number of Taylor terms: C(p + d - 1, d) (``fgt.cpp:73``)."""
    return n_choose_k(p + DIM - 1, DIM)


def _alpha_table(p: int) -> np.ndarray:
    """Multi-index exponents in the reference's graded-lex emission order.

    The heads/tails recurrence emits, per degree k, for each dimension i,
    the degree-(k-1) terms whose leading dimension is >= i, each multiplied
    by dy[i].  Reproduced index-for-index so ``A_k``/``prods`` line up with
    the reference layout."""
    terms = [np.zeros(DIM, dtype=np.int32)]
    heads = [0, 0, 0, 2**31]
    t, tail = 1, 1
    for _ in range(1, p):
        new_tail = tail
        for i in range(DIM):
            head = heads[i]
            heads[i] = t
            for j in range(head, new_tail):
                alpha = terms[j].copy()
                alpha[i] += 1
                terms.append(alpha)
                t += 1
        tail = t
    table = np.stack(terms)
    assert len(table) == pd_size(p)
    return table


def _c_coefficients(p: int) -> np.ndarray:
    """``C_alpha = 2^|alpha| / alpha!`` (``ComputeC_k``,
    ``fgt.cpp:209-240``)."""
    alpha = _alpha_table(p)
    total = alpha.sum(axis=1)
    fact = np.array(
        [math.factorial(a) for a in range(int(alpha.max()) + 1)],
        dtype=np.float64,
    )
    denom = fact[alpha[:, 0]] * fact[alpha[:, 1]] * fact[alpha[:, 2]]
    return (2.0 ** total / denom).astype(np.float32)


class FGTModel(NamedTuple):
    """The reference's ``FGT_Model`` (``fgt_model.h:7-13``)."""

    centers: jnp.ndarray  # f32[K, 3]
    ak: jnp.ndarray  # f32[K, pd]


def k_center(
    points: jnp.ndarray, mask: jnp.ndarray, k: int,
    k_rt: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Farthest-point clustering (``KCenter``, ``fgt.cpp:147-207``).

    Returns (centers f32[k,3], assignment i32[N]).  Invalid (padded) rows
    never become centers and are assigned cluster 0 with zero weight by
    callers.

    ``k_rt`` (optional, dynamic i32 <= k) emulates the reference's
    per-iteration adaptive center count (``K = min(N, M, 50 +
    sigma0^2/sigma^2)``, ``cpdutils.cpp:35``) under XLA's static shapes:
    selection steps past ``k_rt`` are no-ops, so clusters ``>= k_rt``
    receive no assignments and zero expansion weight downstream —
    behaviorally identical to allocating only ``k_rt`` centers."""
    n = points.shape[0]
    first = points[1 % n]  # deterministic seed, fgt.cpp:160
    d0 = jnp.sum((points - first) ** 2, axis=-1)
    d0 = jnp.where(mask > 0, d0, -1.0)  # padded rows are never farthest

    def step(i, carry):
        dist_c, indx = carry
        center_ind = jnp.argmax(dist_c)
        center = points[center_ind]
        d = jnp.sum((points - center) ** 2, axis=-1)
        better = d < dist_c
        if k_rt is not None:
            better = jnp.logical_and(better, i < k_rt)
        dist_c = jnp.where(better, d, dist_c)
        indx = jnp.where(better, i, indx)
        return dist_c, indx

    dist_c, indx = jax.lax.fori_loop(
        1, k, step, (d0, jnp.zeros((n,), jnp.int32))
    )
    w = mask.astype(jnp.float32)
    counts = jax.ops.segment_sum(w, indx, num_segments=k)
    sums = jax.ops.segment_sum(points * w[:, None], indx, num_segments=k)
    centers = sums / jnp.maximum(counts, 1.0)[:, None]
    return centers, indx


def _monomials(dy: jnp.ndarray, p: int) -> jnp.ndarray:
    """``prods`` without the leading Gaussian: ``dy^alpha`` for every
    multi-index, in reference order.  ``dy``: f32[..., 3] (already divided
    by sigma).  Returns f32[..., pd]."""
    alpha = _alpha_table(p)  # static
    # power tables dy^0..dy^(p-1) per dimension via cumulative product
    max_pow = int(alpha.max())
    pows = [jnp.ones_like(dy)]
    for _ in range(max_pow):
        pows.append(pows[-1] * dy)
    pow_stack = jnp.stack(pows, axis=-2)  # [..., max_pow+1, 3]
    mx = pow_stack[..., alpha[:, 0], 0]
    my = pow_stack[..., alpha[:, 1], 1]
    mz = pow_stack[..., alpha[:, 2], 2]
    return mx * my * mz


@partial(jax.jit, static_argnames=("k", "p"))
def compute_fgt_model(
    points: jnp.ndarray,
    weights: jnp.ndarray,
    sigma: jnp.ndarray,
    k: int,
    p: int,
) -> FGTModel:
    """``ComputeFGTModel`` (``fgt.cpp:66-88``).  ``weights`` must be zero
    on padded rows (they then contribute nothing to any expansion)."""
    model = compute_fgt_model_multi(
        points, weights[:, None], (weights != 0).astype(jnp.float32),
        sigma, k, p,
    )
    return FGTModel(centers=model.centers, ak=model.ak[..., 0])


@partial(jax.jit, static_argnames=("k", "p"))
def compute_fgt_model_multi(
    points: jnp.ndarray,
    weights: jnp.ndarray,
    mask: jnp.ndarray,
    sigma: jnp.ndarray,
    k: int,
    p: int,
    k_rt: jnp.ndarray | None = None,
    clustering: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> FGTModel:
    """Batched-weights model: ``weights`` f32[N, W] -> ``ak`` f32[K, pd, W].

    The reference rebuilds the whole model (including the identical
    K-center clustering) once per weight vector — five times per CPD
    E-step (``cpdutils.cpp:41-66``); clustering is weight-independent, so
    one clustering + one batched expansion replaces all five.
    ``k_rt`` limits the live center count at runtime (see ``k_center``).

    ``clustering``: precomputed ``(centers f32[k,3], indx i32[N])``
    skips the farthest-point selection entirely — the EM loop's
    optimization (``cpd_register``): the target's clustering never
    changes, and the moving cloud's assignments are invariant under the
    similarity transforms EM applies (distances scale uniformly, so the
    farthest-point pick order and nearest-center assignments are
    preserved; the cached segment-mean centers transform exactly, since
    the mean commutes with affine maps).  The selection is 127
    sequential O(N) argmax steps, paid for both clouds."""
    if clustering is None:
        centers, indx = k_center(points, mask, k, k_rt)
    else:
        centers, indx = clustering
    dy = (points - centers[indx]) / sigma
    g = jnp.exp(-jnp.sum(dy * dy, axis=-1)) * mask
    prods = _monomials(dy, p)  # [N, pd]
    contrib = prods[:, :, None] * (g[:, None, None] * weights[:, None, :])
    ak = jax.ops.segment_sum(contrib, indx, num_segments=k)  # [K, pd, W]
    ak = ak * jnp.asarray(_c_coefficients(p))[None, :, None]
    return FGTModel(centers=centers, ak=ak)


@partial(jax.jit, static_argnames=("p", "chunk"))
def fgt_predict(
    targets: jnp.ndarray,
    model: FGTModel,
    sigma: jnp.ndarray,
    e_param: float,
    p: int,
    chunk: int = 256,
) -> jnp.ndarray:
    """``ComputeFGTPredict`` (``fgt.cpp:90-145``): f32[M] approximate
    Gauss-transform values; clusters beyond the far-field radius
    (``|dy|^2 > e_param``) contribute zero."""
    multi = FGTModel(centers=model.centers, ak=model.ak[..., None])
    return fgt_predict_multi(targets, multi, sigma, e_param, p, chunk)[:, 0]


@partial(jax.jit, static_argnames=("p", "chunk"))
def fgt_predict_multi(
    targets: jnp.ndarray,
    model: FGTModel,
    sigma: jnp.ndarray,
    e_param: float,
    p: int,
    chunk: int = 256,
) -> jnp.ndarray:
    """Batched-weights prediction: ``ak`` f32[K, pd, W] -> f32[M, W].

    ``chunk``: targets per ``lax.map`` step.  It bounds the
    ``[chunk, K, pd]`` monomial intermediate; a larger chunk means fewer
    sequential steps but a larger intermediate.  256 was chosen on an
    earlier platform and has not been measured on the GPU yet."""
    m = targets.shape[0]
    e_param = jnp.float32(e_param)

    def one_chunk(tgt):
        dy = (tgt[:, None, :] - model.centers[None, :, :]) / sigma
        s = jnp.sum(dy * dy, axis=-1)  # [chunk, K]
        g = jnp.where(s > e_param, 0.0, jnp.exp(-s))
        prods = _monomials(dy, p)  # [chunk, K, pd]
        return jnp.einsum(
            "mk,mkd,kdw->mw", g, prods, model.ak,
            precision=jax.lax.Precision.HIGHEST,
        )

    if m <= chunk:
        return one_chunk(targets)
    pad = (-m) % chunk
    tp = jnp.pad(targets, ((0, pad), (0, 0)))
    out = jax.lax.map(one_chunk, tp.reshape(-1, chunk, 3))
    return out.reshape(-1, model.ak.shape[-1])[:m]
