"""One timing routine for the 100k ICP measurement (``bench.py``).

Protocol (mirrors the reference benchmark settings,
``documentation.tex:397``): the model-substitute cloud
(``synthetic://`` — the reference's >35k models are missing blobs,
BASELINE.md) normalized to spread 10, transformed by (0.2 rad,
translation 10), permuted; 50 iterations per call (the reference's own
performance-set ``maxIterations``, ``testset.cpp:94``) x 3 timed reps.

Timing: every timed call ends in ``jax.block_until_ready`` (JAX returns
before the device finishes), and one host read of the last result closes
the bracket.
"""

from __future__ import annotations

import time
from typing import Callable

N_POINTS = 102_400  # 100k, lane-aligned (800 * 128)
ITERS_PER_CALL = 50
REPS = 3
BASELINE_ITERS_PER_SEC = 10.0  # reference GPU: <100 ms/iter @100k


def timeit(fn: Callable[[], object], reps: int = 5) -> float:
    """Seconds per call of ``fn`` after one warm-up call (which also
    compiles): each call is waited for with ``block_until_ready``, and
    the last result is read to the host once."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    np.asarray(jax.tree.leaves(out)[0])
    return (time.perf_counter() - t0) / reps


def build_headline_pair(n_points: int = N_POINTS, seed: int = 666):
    """The published-protocol cloud pair: (before Cloud, after Cloud)."""
    import numpy as np

    from tpuslam.core.types import pad_cloud
    from tpuslam.data.loader import load_cloud
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
        normalize_cloud,
    )

    rng = np.random.Generator(np.random.PCG64(seed))
    before = normalize_cloud(
        load_cloud(f"synthetic://{n_points}").astype(np.float64), 10.0
    ).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 10.0)
    after = (before @ r.T + t)[rng.permutation(n_points)].astype(
        np.float32
    )
    return pad_cloud(before), pad_cloud(after)


def measure_icp_100k(
    n_points: int = N_POINTS,
    iters: int = ITERS_PER_CALL,
    reps: int = REPS,
    pair=None,
) -> dict:
    """Time ``iters`` full ICP iterations per call, ``reps`` calls, on
    the headline pair (or a caller-supplied one); returns a dict with
    ``iters_per_sec``, ``ms_per_iter`` and ``vs_baseline``.  eps=0 and
    no divergence guard force exactly ``iters`` iterations — the same
    per-iteration pipeline the reference times (NN + weighted
    Procrustes/SVD + transform + error), minus its 4+ host round-trips
    per iteration."""
    from tpuslam.algorithms.icp import icp_register

    cb, ca = pair if pair is not None else build_headline_pair(n_points)

    def run():
        return icp_register(
            cb, ca,
            eps=0.0,
            max_distance_squared=1e18,
            max_iterations=iters,
            divergence_guard=False,
        )

    dt = timeit(run, reps=reps)
    iters_per_sec = iters / dt
    return {
        "n_points": n_points,
        "iters_per_call": iters,
        "reps": reps,
        "iters_per_sec": round(iters_per_sec, 3),
        "ms_per_iter": round(dt / iters * 1000, 3),
        "vs_baseline": round(iters_per_sec / BASELINE_ITERS_PER_SEC, 3),
    }
