"""Sequential scan registration (odometry): align a stream of clouds
pairwise and compose absolute poses.

Beyond-reference scope (the reference registers exactly one pair per
process, ``mainwrapper.cpp:5-54``): the production SLAM workload is a
SEQUENCE of scans, each close to its predecessor.  Three lowerings:

* **scan** (default): k consecutive pairs run inside ONE compiled
  program — a ``lax.scan`` over stacked scans whose carry is the
  previous pair's relative transform (constant-velocity prior — scan
  k+1 tends to continue scan k's motion), threading the seed entirely
  in-program.  Each scan step executes the IDENTICAL per-iteration
  math as ``icp_register`` (the shared ``_icp_loop`` core) with
  patience best-so-far semantics.  This is the dispatch-amortized
  path: one dispatch per chunk of pairs instead of one per pair, and
  the per-chunk dispatches queue asynchronously, so later clouds'
  host-to-device transfers overlap earlier chunks' compute.
* **per-pair** (``scan=False``): consecutive pairs run through
  ``icp_register`` one by one, seeded through the ``ICPResume`` carry.
  All pairs share one padded shape; note the two static signatures
  (pair 0 cold: divergence_guard on / patience 0; seeded pairs:
  guard off / patience>0) compile two distinct programs.
* **batched** (``batch=True``): all pairs in one
  ``icp_register_batch`` program (vmapped or unrolled by the size
  crossover).  No cross-pair seeding — use when motion is small and
  throughput beats everything.

For scans arriving ONE AT A TIME (the live-sensor case), use
``SequenceStream`` (``tpuslam.sequence_stream``): one seeded dispatch
per arrival, every cloud transferred exactly once.

Absolute poses compose homogeneously: ``T_k = T_{k-1} ∘ rel_k`` with
``rel_k`` mapping scan k to scan k+1's frame (the reference transform
direction: ``before -> after``).
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpuslam.algorithms.icp import (
    FLT_MAX,
    ICPResume,
    ICPState,
    _icp_loop,
    icp_register,
)
from tpuslam.core.types import Cloud, RigidTransform, pad_cloud, round_up

# patience for seeded pairs (scan + per-pair lowerings): a warm start
# sits immediately in the near-optimum regime where the correspondence
# error fluctuates, so the reference's stop-on-first-error-increase
# guard fires on noise after ~2 iterations and returns seed quality
# (measured on an earlier build: drift RMS 3.1 vs 0.50 unseeded at
# 20x100k); an estimated seed can
# also plateau for a few iterations before descending further, so
# patience must ride out the plateau.  Under exact-f32 transforms a
# seeded pair usually converges via eps in about one iteration, so
# patience is a safety margin for eps-unreachable noise floors.
SEED_PATIENCE = 8

# pairs per compiled dispatch of the scan lowering: the per-chunk
# dispatches queue asynchronously (the seed carry is a device array;
# nothing syncs until the final reads), so later clouds' host-to-device
# transfers overlap earlier chunks' compute
PAIRS_PER_DISPATCH = 8


class SequenceResult(NamedTuple):
    """Per-pair relative transforms + composed absolute poses.

    ``relative``: K transforms, scan k -> scan k+1 frame.
    ``absolute``: K+1 poses, scan k -> scan 0 frame (pose 0 = identity).
    ``iterations`` / ``errors``: per-pair registration diagnostics.
    """

    relative: List[RigidTransform]
    absolute: List[RigidTransform]
    iterations: np.ndarray  # i32[K]
    errors: np.ndarray  # f32[K]


def _compose(a: RigidTransform, b: RigidTransform) -> RigidTransform:
    """a ∘ b: apply b, then a (homogeneous composition; unit scale —
    odometry steps are rigid).  Host NumPy in f32, so no reduced-precision
    matmul path can reach it."""
    ra, rb = np.asarray(a.rotation), np.asarray(b.rotation)
    return RigidTransform(
        rotation=ra @ rb,
        translation=ra @ np.asarray(b.translation)
        + np.asarray(a.translation),
        scale=np.float32(1.0),
    )


def _invert(t: RigidTransform) -> RigidTransform:
    rt = np.asarray(t.rotation).T
    return RigidTransform(rotation=rt,
                          translation=-(rt @ np.asarray(t.translation)),
                          scale=np.float32(1.0))


@partial(
    jax.jit, static_argnames=("patience", "seeded"),
)
def _register_pairs_scanned(
    pts: jnp.ndarray,  # f32[S, P, 3]
    counts: jnp.ndarray,  # i32[S]
    seed_r: jnp.ndarray,  # f32[3, 3] — carry entering this chunk
    seed_t: jnp.ndarray,  # f32[3]
    eps: jnp.ndarray,
    max_d2: jnp.ndarray,
    max_iterations: jnp.ndarray,
    patience: int,
    seeded: bool = True,
):
    """Register ``pts[k] -> pts[k+1]`` for all S-1 consecutive pairs in
    ONE program: a ``lax.scan`` whose carry is the previous pair's
    relative transform and whose step runs the shared ``_icp_loop``.
    Returns stacked (rotations, translations, iterations, errors).

    Masks are built IN-program from ``counts`` (valid rows always come
    first), saving an f32[S, P] host->device transfer."""
    msk = (
        jnp.arange(pts.shape[1], dtype=jnp.int32)[None, :]
        < counts[:, None]
    ).astype(jnp.float32)
    xs = (pts[:-1], msk[:-1], pts[1:], counts[1:])

    def step(carry, x):
        if seeded:
            prev_r, prev_t = carry
        else:  # every pair cold-starts from identity
            prev_r = jnp.eye(3, dtype=jnp.float32)
            prev_t = jnp.zeros((3,), jnp.float32)
        src_pts, src_msk, tgt_pts, tgt_count = x
        init = ICPState(
            rotation=prev_r,
            translation=prev_t,
            error=jnp.float32(1e5),  # reporting init, basicicp.cpp:26
            prev_error=FLT_MAX,
            iterations=jnp.int32(0),
            done=jnp.asarray(False),
        )
        res = _icp_loop(
            src_pts, src_msk, tgt_pts, tgt_count, None,
            eps, max_d2, max_iterations,
            # patience=0 restores the reference stop-on-error-increase
            # contract (unseeded mode); patience>0 is the seeded-warm-
            # start semantic (see SEED_PATIENCE)
            divergence_guard=patience == 0,
            verbose=False,
            iter_offset=jnp.int32(0),
            init=init,
            patience=patience,
        )
        out = (
            res.transform.rotation, res.transform.translation,
            res.iterations, res.error,
        )
        return (res.transform.rotation, res.transform.translation), out

    (_, _), outs = jax.lax.scan(step, (seed_r, seed_t), xs)
    return outs


def _register_sequence_scanned(
    arrs: List[np.ndarray],
    npad: int,
    eps: float,
    max_distance_squared: float,
    max_iterations: int,
    seed_with_previous: bool,
    patience: Optional[int],
    pairs_per_dispatch: Optional[int],
):
    """The scan lowering's host driver: pad every cloud once, stack, and
    dispatch ``pairs_per_dispatch`` pairs per compiled program, threading
    the seed carry across dispatches."""
    if patience is None:
        patience = SEED_PATIENCE if seed_with_previous else 0

    s = len(arrs)
    counts_h = np.asarray([len(a) for a in arrs], np.int32)

    def prep_one(a):
        padded = np.zeros((npad, 3), np.float32)
        padded[: len(a)] = a
        return padded

    # device_put is asynchronous: each transfer overlaps the next pad
    pts_dev = [jax.device_put(prep_one(a)) for a in arrs]
    counts = jnp.asarray(counts_h)
    eps_d = jnp.float32(eps)
    max_d2_d = jnp.float32(max_distance_squared)
    max_it_d = jnp.int32(max_iterations)

    n_pairs = s - 1
    chunk = pairs_per_dispatch or PAIRS_PER_DISPATCH
    seed_r = jnp.eye(3, dtype=jnp.float32)
    seed_t = jnp.zeros((3,), jnp.float32)
    rot_l, tr_l, it_l, er_l = [], [], [], []
    for start in range(0, n_pairs, chunk):
        stop = min(start + chunk, n_pairs)
        outs = _register_pairs_scanned(
            jnp.stack(pts_dev[start:stop + 1]),
            counts[start:stop + 1],
            seed_r, seed_t, eps_d, max_d2_d, max_it_d,
            patience=patience, seeded=seed_with_previous,
        )
        rot, tr, it, er = outs
        if seed_with_previous:
            # thread the carry to the next chunk ON DEVICE
            seed_r, seed_t = rot[-1], tr[-1]
        rot_l.append(rot)
        tr_l.append(tr)
        it_l.append(it)
        er_l.append(er)
    rot = np.concatenate([np.asarray(x) for x in rot_l])
    tr = np.concatenate([np.asarray(x) for x in tr_l])
    iters = np.concatenate([np.asarray(x) for x in it_l]).astype(np.int32)
    errs = np.concatenate([np.asarray(x) for x in er_l]).astype(np.float32)
    rels = [
        RigidTransform(rotation=rot[k], translation=tr[k],
                       scale=np.float32(1.0))
        for k in range(n_pairs)
    ]
    return rels, iters, errs


class SequenceStream:
    """Incremental odometry: push scans one at a time as a sensor
    delivers them, get the relative transform (previous scan -> new
    scan frame) and the composed absolute pose back.

    This is the streaming counterpart of the scan lowering: every
    cloud's padded device copy is RETAINED, so a scan is transferred
    exactly once and then serves as the target of one registration and
    the source of the next.  Each ``push`` is ONE jitted dispatch (the
    S=2 scan program — compiled on the first push, reused for every
    subsequent one) seeded with the previous relative motion.

    All scans must fit one padded shape: ``max_points`` bounds them
    (defaults to the first scan's padded size)."""

    def __init__(
        self,
        first_scan,
        eps: float = 1e-3,
        max_distance_squared: float = 1000.0,
        max_iterations: int = 50,
        patience: Optional[int] = None,
        max_points: Optional[int] = None,
    ):
        a = np.asarray(
            first_scan.points[: int(first_scan.count)]
            if isinstance(first_scan, Cloud) else first_scan,
            np.float32,
        )
        self._npad = round_up(max(max_points or len(a), len(a), 1), 128)
        self._eps = jnp.float32(eps)
        self._max_d2 = jnp.float32(max_distance_squared)
        self._max_it = jnp.int32(max_iterations)
        self._patience = (
            SEED_PATIENCE if patience is None else int(patience)
        )
        self._rel_r = jnp.eye(3, dtype=jnp.float32)
        self._rel_t = jnp.zeros((3,), jnp.float32)
        self._first = True
        eye = RigidTransform(
            rotation=np.eye(3, dtype=np.float32),
            translation=np.zeros(3, np.float32),
            scale=np.float32(1.0),
        )
        self.absolute: List[RigidTransform] = [eye]
        self._prev = self._stage(a)

    def _stage(self, a: np.ndarray):
        """Pad + transfer one scan; returns (device points f32[P,3],
        count)."""
        if len(a) > self._npad:
            raise ValueError(
                f"scan has {len(a)} points > max_points={self._npad}"
            )
        padded = np.zeros((self._npad, 3), np.float32)
        padded[: len(a)] = a
        return jax.device_put(padded), np.int32(len(a))

    def push(self, scan) -> RigidTransform:
        """Register ``previous -> scan``; returns the relative
        transform and appends the composed absolute pose."""
        a = np.asarray(
            scan.points[: int(scan.count)]
            if isinstance(scan, Cloud) else scan,
            np.float32,
        )
        new = self._stage(a)
        pts = jnp.stack([self._prev[0], new[0]])
        counts = jnp.asarray(
            [self._prev[1], new[1]], jnp.int32
        )
        outs = _register_pairs_scanned(
            pts, counts, self._rel_r, self._rel_t,
            self._eps, self._max_d2, self._max_it,
            patience=self._patience, seeded=not self._first,
        )
        rot, tr = outs[0][0], outs[1][0]
        # the seed carry stays ON DEVICE; only the composed pose
        # crosses to the host
        self._rel_r, self._rel_t = rot, tr
        self._first = False
        self._prev = new
        rel = RigidTransform(
            rotation=np.asarray(rot), translation=np.asarray(tr),
            scale=np.float32(1.0),
        )
        self.absolute.append(_compose(self.absolute[-1], _invert(rel)))
        return rel


def register_sequence(
    clouds: Sequence[np.ndarray],
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    seed_with_previous: bool = True,
    batch: bool = False,
    scan: Optional[bool] = None,
    patience: Optional[int] = None,
    pairs_per_dispatch: Optional[int] = None,
) -> SequenceResult:
    """Register ``clouds[k] -> clouds[k+1]`` for every consecutive pair
    and compose the absolute trajectory.  Clouds are host arrays (or
    Clouds) of possibly different sizes; all are padded to one common
    lane-aligned shape so every pair reuses the same compiled program.

    ``scan`` (default auto: ON unless ``batch``) picks the
    dispatch-amortized in-program lowering; ``patience`` overrides the
    seeded best-so-far window (None: ``SEED_PATIENCE`` when seeded, 0 —
    the reference divergence-guard contract — when not);
    ``pairs_per_dispatch`` overrides ``PAIRS_PER_DISPATCH``, the scan
    lowering's chunking."""
    if len(clouds) < 2:
        raise ValueError("register_sequence needs at least two clouds")
    arrs = [
        np.asarray(c.points[: int(c.count)] if isinstance(c, Cloud) else c,
                   np.float32)
        for c in clouds
    ]
    npad = max(round_up(max(len(a), 1), 128) for a in arrs)

    if batch:
        from tpuslam.algorithms.batch import icp_register_batch, stack_clouds

        bb = stack_clouds(arrs[:-1], multiple=npad)
        ba = stack_clouds(arrs[1:], multiple=npad)
        out = icp_register_batch(
            bb, ba, eps=eps,
            max_distance_squared=max_distance_squared,
            max_iterations=max_iterations,
        )
        rels = [
            RigidTransform(
                rotation=np.asarray(out.transform.rotation[k]),
                translation=np.asarray(out.transform.translation[k]),
                scale=np.float32(1.0),
            )
            for k in range(len(arrs) - 1)
        ]
        iters = np.asarray(out.iterations)
        errs = np.asarray(out.error)
    elif scan or scan is None:
        rels, iters, errs = _register_sequence_scanned(
            arrs, npad, eps, max_distance_squared, max_iterations,
            seed_with_previous, patience, pairs_per_dispatch,
        )
    else:
        padded = [pad_cloud(a, multiple=npad) for a in arrs]
        if patience is None:
            patience = SEED_PATIENCE
        rels, iters_l, errs_l = [], [], []
        prev_dev = None  # previous pair's (rotation, translation), ON DEVICE
        for k in range(len(arrs) - 1):
            resume = None
            if seed_with_previous and prev_dev is not None:
                # constant-velocity prior: start from the previous
                # pair's relative motion, handed over as the previous
                # result's DEVICE arrays (no host round trip per pair)
                resume = ICPResume(
                    rotation=prev_dev[0],
                    translation=prev_dev[1],
                    error=jnp.float32(1e5),
                    done_before=jnp.int32(0),
                    prev_error=jnp.float32(FLT_MAX),
                )
            # seeded pairs replace the reference's stop-on-first-error-
            # increase guard with patience best-so-far semantics (see
            # SEED_PATIENCE); pair 0 keeps the cold-start reference
            # contract — note the two (divergence_guard, patience)
            # static signatures compile two distinct programs
            r = icp_register(
                padded[k], padded[k + 1], eps=eps,
                max_distance_squared=max_distance_squared,
                max_iterations=max_iterations,
                resume=resume,
                divergence_guard=resume is None,
                patience=0 if resume is None else patience,
            )
            rel = RigidTransform(
                rotation=np.asarray(r.transform.rotation),
                translation=np.asarray(r.transform.translation),
                scale=np.float32(1.0),
            )
            rels.append(rel)
            prev_dev = (r.transform.rotation, r.transform.translation)
            iters_l.append(int(r.iterations))
            errs_l.append(float(r.error))
        iters = np.asarray(iters_l, np.int32)
        errs = np.asarray(errs_l, np.float32)

    # scan k's points in scan 0's frame: T_k = rel_1^-1 ∘ ... — the
    # relative transform maps k INTO k+1's frame, so the pose of frame
    # k+1 expressed in frame 0 composes the INVERSES:
    # x_{k+1} = rel_k(x_k)  =>  x_0 = T_k(x_k), T_{k+1} = T_k ∘ rel_k^-1
    eye = RigidTransform(
        rotation=np.eye(3, dtype=np.float32),
        translation=np.zeros(3, np.float32),
        scale=np.float32(1.0),
    )
    absolute = [eye]
    for rel in rels:
        absolute.append(_compose(absolute[-1], _invert(rel)))
    return SequenceResult(
        relative=rels, absolute=absolute, iterations=iters, errors=errs
    )
