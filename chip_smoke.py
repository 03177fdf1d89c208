"""Smoke run of the registration system on the GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One JAX process drives the card(s).  Each phase goes through the entry
points a user calls (the CLI, ``tpuslam.register``, ``register_pairs``,
``sequence_stream``) or times a kernel against its plain jnp reference,
on clouds generated from ``--seed``, and prints one line: phase name,
sizes, wall time, check result.  The card's ``nvidia-smi`` name and power
limit come first.  The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The script exits non-zero with ``"ok": false`` when JAX's backend is not
the GPU or when any phase fails; a phase's exception is printed with its
traceback on stderr.  The compile cache lives in
``JAX_COMPILATION_CACHE_DIR`` when set, else in ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# ---------------------------------------------------------------------------
# sizes (the reference's ladder, testset.cpp:19-38, and BASELINE config 4)
# ---------------------------------------------------------------------------
ICP_SMALL = 102_400
ICP_LARGE = 1_375_028
ESTEP_SMALL = 20_480
CPD_LARGE = 376_832
NICP_SIZE = 1_048_576
PAIRS, PAIR_SIZE = 16, 16_384
SCANS, SCAN_SIZE = 5, 102_400

# tolerances (PERF.md, "Kernel decisions", says why)
TRANSFORM_TOL = 1e-5      # kernel arm vs reference arm, same pair
ESTEP_RTOL = 1e-4         # p1, pt1, px, relative to each statistic's max
ESTEP_ERROR_RTOL = 1e-5   # the negative log-likelihood
CPD_GT_MSE = 0.1          # ground-truth MSE bound after 15 EM iterations
CPD_ARM_TOL = 1e-3        # CPD transforms, two summation orders: sums of
# ~4e5 f32 terms differ by ~sqrt(N)*eps ~ 4e-5 relative, and 15 EM
# iterations far from convergence carry that into the transform
CPD_SCALE = (1.0, 0.5, 0.2)  # anisotropic box: a uniform cube is
# rotationally featureless, and 15 iterations leave EM far from it
GT_ROT_TOL = 1e-3         # ground truth, max |R - R_true| entry
GT_TRANS_TOL = 1e-2       # ground truth, max |t - t_true| entry
# ICP motion (rotation rad about the origin, translation) of one to three
# NN spacings of the uniform box, and a convergence threshold at f32
# noise: both arms then reach the same fixed point (the exact transform),
# where a 1e-5 comparison is meaningful.  Stopped earlier (or at a
# divergence-guard stop on a longer, tie-ridden path), rounding
# differences between the arms (separate XLA programs) move the stop.
ICP_MOTION = (0.02, 0.1)
ICP_EPS = 1e-9


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_lines() -> str:
    """``nvidia-smi``'s name and power limit of every card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return (out.stdout or out.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def timed(fn, reps: int = 3):
    """(result, first call seconds incl. compile, median seconds of
    ``reps`` further calls); every call waits with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times)) if times else first


def rigid_pair(rng, n, angle, trans, scale=(1.0, 1.0, 1.0)):
    """A seeded cloud (uniform box, spread 10, optionally anisotropic)
    and its exactly moved, permuted copy: (before, after, R, t)."""
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    before = (rng.random((n, 3), dtype=np.float64) * 10.0
              * np.asarray(scale)).astype(np.float32)
    r = get_random_rotation_matrix(rng, angle).astype(np.float32)
    t = get_random_translation_vector(rng, trans).astype(np.float32)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
    return before, after, r, t


def gt_errors(rot, trans, r_true, t_true):
    return (float(np.max(np.abs(np.asarray(rot) - r_true))),
            float(np.max(np.abs(np.asarray(trans) - t_true))))


def arm_diff(a, b):
    """Max abs difference of (rotation, translation) between results."""
    return max(
        float(np.max(np.abs(np.asarray(a.transform.rotation)
                            - np.asarray(b.transform.rotation)))),
        float(np.max(np.abs(np.asarray(a.transform.translation)
                            - np.asarray(b.transform.translation)))),
    )


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_nn_kernel(rng, n):
    import jax.numpy as jnp

    from tpuslam.kernels.pallas_nn import nearest_neighbors_pallas
    from tpuslam.ops.nn import nearest_neighbors_ref

    src = jnp.asarray(rng.random((n, 3), dtype=np.float32) * 10)
    tgt = jnp.asarray(rng.random((n, 3), dtype=np.float32) * 10)
    cnt = jnp.int32(n)
    reps = 2 if n > 500_000 else 3
    (ik, dk), ck, tk = timed(
        lambda: nearest_neighbors_pallas(src, tgt, cnt), reps)
    (ir, dr), cr, tr = timed(
        lambda: nearest_neighbors_ref(src, tgt, cnt), reps)
    ik, dk, ir, dr = map(np.asarray, (ik, dk, ir, dr))
    ulp = np.abs(dk.view(np.int32).astype(np.int64)
                 - dr.view(np.int32).astype(np.int64))
    mism = ik != ir
    tie_rows = int(np.sum(mism & (ulp <= 1)))
    check(int(ulp.max()) <= 1, f"distances differ by {int(ulp.max())} ulp")
    check(int(np.sum(mism & (ulp > 1))) == 0, "index mismatch off a tie")
    return (f"n=m={n} kernel={tk * 1e3:.2f}ms xla={tr * 1e3:.2f}ms "
            f"speedup={tr / tk:.2f} first_call kernel={ck:.2f}s "
            f"xla={cr:.2f}s idx_mismatch={int(mism.sum())} "
            f"tie_rows_1ulp={tie_rows}")


def phase_estep_kernel(rng, n):
    import jax
    import jax.numpy as jnp

    from tpuslam.algorithms.cpd import (
        cpd_estep,
        sigma_squared_init,
        uniform_constant,
    )
    from tpuslam.kernels.pallas_cpd import cpd_estep_pallas

    before, after, _, _ = rigid_pair(rng, n, 0.2, 1.0)
    mov, tgt = jnp.asarray(before), jnp.asarray(after)
    mk = jnp.ones((n,), jnp.float32)
    s2 = sigma_squared_init(mov, mk, tgt, mk)
    c = uniform_constant(s2, jnp.float32(0.3), jnp.float32(n),
                         jnp.float32(n))
    ref = jax.jit(cpd_estep)
    parts = []
    for factor, trunc in ((1.0, False), (0.002, True)):
        args = (mov, mk, tgt, mk, s2 * factor, c, jnp.asarray(trunc))
        g, ck, tk = timed(lambda: cpd_estep_pallas(*args), 2)
        w, cr, tr = timed(lambda: ref(*args), 2)
        errs = {}
        for f in ("p1", "pt1", "px"):
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            scale = max(float(np.max(np.abs(b))), 1e-30)
            errs[f] = float(np.max(np.abs(a - b)) / scale)
            check(errs[f] <= ESTEP_RTOL, f"{f} rel err {errs[f]:.2e}")
        errs["error"] = abs(float(g.error) - float(w.error)) / max(
            abs(float(w.error)), 1e-30)
        check(errs["error"] <= ESTEP_ERROR_RTOL,
              f"error rel err {errs['error']:.2e}")
        parts.append(
            f"[sigma2={factor}x trunc={trunc} kernel={tk * 1e3:.2f}ms "
            f"xla={tr * 1e3:.2f}ms speedup={tr / tk:.2f} relerr="
            + ",".join(f"{k}:{v:.1e}" for k, v in errs.items()) + "]"
        )
    return f"n=m={n} " + " ".join(parts)


def phase_icp_cli(rng, workdir):
    from tpuslam.algorithms.icp import icp_register
    from tpuslam.config.parser import ConfigParser
    from tpuslam.core.types import pad_cloud
    from tpuslam.data.synthesis import get_clouds_from_config
    from tpuslam.harness.cli import main as cli_main

    cfg = {
        "method": "icp",
        "before-path": f"synthetic://{ICP_SMALL}",
        "after-path": f"synthetic://{ICP_SMALL}",
        "cloud-spread": 10.0,
        "rotation-range": ICP_MOTION[0],
        "translation-range": ICP_MOTION[1],
        "max-iterations": 50,
        "convergence-epsilon": ICP_EPS,
        "random-seed": int(rng.integers(1 << 30)),
    }
    path = os.path.join(workdir, "icp_100k.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main([path])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"CLI exit code {rc}")
    check("Results for the icp method" in out.getvalue(), "no CLI result")

    config = ConfigParser([path]).get_configuration()
    before, after, (r_true, t_true) = get_clouds_from_config(config)
    kw = dict(eps=config.convergence_epsilon,
              max_distance_squared=config.max_distance_squared,
              max_iterations=config.max_iterations)
    kern, _, tk = timed(lambda: icp_register(
        pad_cloud(before), pad_cloud(after), **kw), 1)
    ref, _, tr = timed(lambda: icp_register(
        pad_cloud(before), pad_cloud(after), use_pallas=False, **kw), 1)
    return _icp_compare(kern, ref, r_true, t_true, tk, tr,
                        f"n={ICP_SMALL} cli={cli_s:.2f}s")


def _icp_compare(kern, ref, r_true, t_true, tk, tr, head):
    it_k, it_r = int(kern.iterations), int(ref.iterations)
    diff = arm_diff(kern, ref)
    er, et = gt_errors(kern.transform.rotation, kern.transform.translation,
                       r_true, t_true)
    check(it_k == it_r, f"iterations kernel {it_k} vs reference {it_r}")
    check(diff <= TRANSFORM_TOL, f"kernel vs reference arm diff {diff:.2e}")
    check(er <= GT_ROT_TOL and et <= GT_TRANS_TOL,
          f"ground truth rot {er:.2e} trans {et:.2e}")
    return (f"{head} iters={it_k} kernel={tk:.3f}s xla={tr:.3f}s "
            f"speedup={tr / tk:.2f} arm_diff={diff:.1e} "
            f"gt_rot={er:.1e} gt_trans={et:.1e}")


def phase_icp_register_large(rng):
    import tpuslam
    from tpuslam.algorithms.icp import RegistrationResult, icp_register
    from tpuslam.core.types import RigidTransform, pad_cloud

    before, after, r_true, t_true = rigid_pair(
        rng, ICP_LARGE, *ICP_MOTION)
    kw = dict(max_iterations=50, convergence_epsilon=ICP_EPS)
    (rot, trans, iters, _), first, tk = timed(
        lambda: tpuslam.register(before, after, **kw), 1)
    kern = RegistrationResult(
        RigidTransform(rot, trans, np.float32(1.0)), np.int32(iters),
        np.float32(0.0))
    ref, _, tr = timed(lambda: icp_register(
        pad_cloud(before), pad_cloud(after), eps=ICP_EPS,
        max_iterations=50, use_pallas=False), 1)
    return _icp_compare(kern, ref, r_true, t_true, tk, tr,
                        f"n={ICP_LARGE} (kernel first call {first:.2f}s)")


def phase_cpd_hybrid(rng):
    import tpuslam
    from tpuslam import ApproximationType, ComputationMethod
    from tpuslam.algorithms.cpd import cpd_register
    from tpuslam.core.types import pad_cloud

    before, after, r_true, t_true = rigid_pair(
        rng, CPD_LARGE, 0.2, 1.0, scale=CPD_SCALE)
    kw = dict(computation_method=ComputationMethod.Cpd, cpd_weight=0.1,
              cpd_const_scale=False, max_iterations=15, cpd_tolerance=1e-6,
              approximation_type=ApproximationType.Hybrid)
    t0 = time.perf_counter()
    rot, trans, iters, sigma2 = tpuslam.register(before, after, **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpuslam.register(before, after, **kw)
    tk = time.perf_counter() - t0
    gt_mse, start_mse = _cpd_gt_mse(before, rot, trans, r_true, t_true)
    check(gt_mse <= CPD_GT_MSE, f"ground-truth MSE {gt_mse:.2e}")
    ref, _, tr = timed(lambda: cpd_register(
        pad_cloud(before), pad_cloud(after), weight=0.1, tolerance=1e-6,
        max_iterations=15, approximation_type=ApproximationType.Hybrid,
        use_pallas=False), 1)
    ref_rot = np.asarray(ref.transform.scale) * np.asarray(
        ref.transform.rotation)
    diff = float(np.max(np.abs(ref_rot - np.asarray(rot))))
    return (f"n=m={CPD_LARGE} iters={iters} wall={tk:.3f}s "
            f"(first {first:.2f}s) reference_arm={tr:.3f}s "
            f"gt_mse={gt_mse:.2e} (bound {CPD_GT_MSE:g}, identity "
            f"{start_mse:.2e}) arm_rot_diff={diff:.1e} sigma2={sigma2:.3e}")


def _cpd_gt_mse(before, rot, trans, r_true, t_true):
    """(ground-truth MSE of the result, MSE of the identity start)."""
    truth = before @ r_true.T + t_true
    moved = before @ np.asarray(rot).T + np.asarray(trans)
    return (float(np.mean(np.sum((moved - truth) ** 2, axis=1))),
            float(np.mean(np.sum((before - truth) ** 2, axis=1))))


def phase_cpd_estep_arms(rng, n):
    """CPD with the exact E-step in every iteration (Hybrid with the FGT
    fast phase off), kernel arm against reference arm: the E-step
    kernel's end-to-end effect."""
    from tpuslam import ApproximationType
    from tpuslam.algorithms.cpd import cpd_register
    from tpuslam.core.types import pad_cloud

    before, after, r_true, t_true = rigid_pair(
        rng, n, 0.2, 1.0, scale=CPD_SCALE)
    kw = dict(weight=0.1, max_iterations=15, tolerance=1e-6, use_fgt=False,
              approximation_type=ApproximationType.Hybrid)
    kern, ck, tk = timed(lambda: cpd_register(
        pad_cloud(before), pad_cloud(after), use_pallas=True, **kw), 1)
    ref, cr, tr = timed(lambda: cpd_register(
        pad_cloud(before), pad_cloud(after), use_pallas=False, **kw), 1)
    rot = np.asarray(kern.transform.scale) * np.asarray(
        kern.transform.rotation)
    gt_mse, start = _cpd_gt_mse(before, rot, kern.transform.translation,
                                r_true, t_true)
    diff = arm_diff(kern, ref)
    check(int(kern.iterations) == int(ref.iterations), "iterations differ")
    check(diff <= CPD_ARM_TOL, f"kernel vs reference arm diff {diff:.2e}")
    check(gt_mse <= CPD_GT_MSE, f"ground-truth MSE {gt_mse:.2e}")
    return (f"n=m={n} iters={int(kern.iterations)} kernel={tk:.3f}s "
            f"xla={tr:.3f}s speedup={tr / tk:.2f} (first calls "
            f"{ck:.1f}s/{cr:.1f}s) arm_diff={diff:.1e} gt_mse={gt_mse:.2e} "
            f"(identity {start:.2e})")


def phase_nicp(rng):
    import tpuslam
    from tpuslam import ComputationMethod

    before, after, r_true, t_true = rigid_pair(
        rng, NICP_SIZE, 0.5, 2.0, scale=(1.0, 0.5, 0.2))
    kw = dict(computation_method=ComputationMethod.NoniterativeIcp)
    t0 = time.perf_counter()
    rot, trans, _, err = tpuslam.register(before, after, **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpuslam.register(before, after, **kw)
    tk = time.perf_counter() - t0
    er, et = gt_errors(rot, trans, r_true, t_true)
    check(er <= GT_ROT_TOL and et <= GT_TRANS_TOL,
          f"ground truth rot {er:.2e} trans {et:.2e}")
    return (f"n=m={NICP_SIZE} wall={tk:.3f}s (first {first:.2f}s) "
            f"error={err:.2e} gt_rot={er:.1e} gt_trans={et:.1e}")


def phase_register_pairs(rng):
    import tpuslam

    pairs = [rigid_pair(rng, PAIR_SIZE, 0.1, 0.5) for _ in range(PAIRS)]
    bs, as_ = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(max_iterations=50, convergence_epsilon=1e-5)
    tpuslam.register_pairs(bs, as_, **kw)
    t0 = time.perf_counter()
    rots, trans, iters, _ = tpuslam.register_pairs(bs, as_, **kw)
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [tpuslam.register(b, a, **kw) for b, a in zip(bs, as_)]
    ts = time.perf_counter() - t0
    worst = 0.0
    for k, (r, t, it, _) in enumerate(solo):
        check(int(iters[k]) == int(it), f"pair {k} iterations differ")
        worst = max(worst, float(np.max(np.abs(rots[k] - r))),
                    float(np.max(np.abs(trans[k] - t))))
        er, et = gt_errors(rots[k], trans[k], pairs[k][2], pairs[k][3])
        check(er <= GT_ROT_TOL and et <= GT_TRANS_TOL,
              f"pair {k} ground truth rot {er:.2e} trans {et:.2e}")
    check(worst <= TRANSFORM_TOL, f"batch vs solo diff {worst:.2e}")
    return (f"{PAIRS}x{PAIR_SIZE} batch={tb:.3f}s solo_total={ts:.3f}s "
            f"(solo incl. first-call compile) batch_vs_solo={worst:.1e}")


def phase_sequence_stream(rng):
    import tpuslam
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    scan = (rng.random((SCAN_SIZE, 3), dtype=np.float64) * 10).astype(
        np.float32)
    scans, motions = [scan], []
    for _ in range(SCANS - 1):
        r = get_random_rotation_matrix(rng, 0.03).astype(np.float32)
        t = get_random_translation_vector(rng, 0.2).astype(np.float32)
        scan = (scan @ r.T + t)[rng.permutation(SCAN_SIZE)].astype(
            np.float32)
        scans.append(scan)
        motions.append((r, t))
    stream = tpuslam.sequence_stream(
        scans[0], max_iterations=50, eps=1e-5)
    lat = []
    worst = 0.0
    for k, s in enumerate(scans[1:]):
        t0 = time.perf_counter()
        rel = stream.push(s)
        lat.append(time.perf_counter() - t0)
        er, et = gt_errors(rel.rotation, rel.translation, *motions[k])
        worst = max(worst, er, et)
        check(er <= GT_ROT_TOL and et <= GT_TRANS_TOL,
              f"scan {k + 1} ground truth rot {er:.2e} trans {et:.2e}")
    return (f"{SCANS}x{SCAN_SIZE} push_ms first={lat[0] * 1e3:.1f} "
            f"median_rest={np.median(lat[1:]) * 1e3:.1f} "
            f"gt_worst={worst:.1e}")


def phase_chip_tests():
    """The repository's tests marked ``chip`` (among them the precision
    check), in this process."""
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main([
        "-q", "-m", "chip", "--noconftest", "-p", "no:cacheprovider",
        "-p", "no:xdist", os.path.join(root, "tests", "test_chip.py"),
    ])
    check(rc == 0, f"pytest exit code {rc}")
    return "tests/test_chip.py passed"


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def phase_sharded_icp(rng, mesh):
    from tpuslam.algorithms.icp import icp_register
    from tpuslam.core.types import pad_cloud
    from tpuslam.parallel.icp import icp_register_sharded
    from tpuslam.parallel.mesh import replicate_cloud, shard_cloud

    before, after, r_true, t_true = rigid_pair(
        rng, ICP_LARGE, *ICP_MOTION)
    kw = dict(eps=ICP_EPS, max_iterations=50)
    rep, shd = replicate_cloud(before, mesh), shard_cloud(after, mesh)
    sharded, c4, t4 = timed(
        lambda: icp_register_sharded(rep, shd, mesh, **kw), 1)
    single, c1, t1 = timed(lambda: icp_register(
        pad_cloud(before), pad_cloud(after), **kw), 1)
    return _icp_compare(
        sharded, single, r_true, t_true, t4, t1,
        f"n={ICP_LARGE} target over {mesh.devices.size} cards "
        f"(kernel=sharded, xla=single card; first calls {c4:.1f}s/"
        f"{c1:.1f}s)")


def phase_sharded_cpd(rng, mesh):
    """Sharded CPD against one card.  The arms are compared with the
    exact E-step in both phases: with the FGT fast phase the sharded run
    fits a union of per-shard clusterings, a different approximation
    than one card's, so only its ground truth is checked."""
    from tpuslam import ApproximationType
    from tpuslam.algorithms.cpd import cpd_register
    from tpuslam.core.types import pad_cloud
    from tpuslam.parallel.cpd import cpd_register_sharded
    from tpuslam.parallel.mesh import replicate_cloud, shard_cloud

    before, after, r_true, t_true = rigid_pair(
        rng, CPD_LARGE, 0.2, 1.0, scale=CPD_SCALE)
    kw = dict(weight=0.1, max_iterations=15, tolerance=1e-6,
              approximation_type=ApproximationType.Hybrid)
    rep, shd = replicate_cloud(before, mesh), shard_cloud(after, mesh)
    sharded, c4, t4 = timed(lambda: cpd_register_sharded(
        rep, shd, mesh, use_fgt=False, **kw), 1)
    single, c1, t1 = timed(lambda: cpd_register(
        pad_cloud(before), pad_cloud(after), use_fgt=False, **kw), 1)
    fgt, _, tf = timed(lambda: cpd_register_sharded(
        rep, shd, mesh, use_fgt=True, **kw), 1)
    mses = []
    for res in (sharded, fgt):
        rot = np.asarray(res.transform.scale) * np.asarray(
            res.transform.rotation)
        mses.append(_cpd_gt_mse(before, rot, res.transform.translation,
                                r_true, t_true)[0])
    diff = arm_diff(sharded, single)
    check(int(sharded.iterations) == int(single.iterations),
          "iterations differ")
    check(max(mses) <= CPD_GT_MSE, f"ground-truth MSE {max(mses):.2e}")
    check(diff <= CPD_ARM_TOL, f"sharded vs single-card diff {diff:.2e}")
    return (f"n=m={CPD_LARGE} over {mesh.devices.size} cards, exact "
            f"E-step: sharded={t4:.3f}s single={t1:.3f}s (first calls "
            f"{c4:.1f}s/{c1:.1f}s) iters={int(sharded.iterations)} "
            f"diff={diff:.1e} gt_mse={mses[0]:.2e}; sharded FGT fast "
            f"phase: {tf:.3f}s gt_mse={mses[1]:.2e}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    print(card_lines(), flush=True)
    import jax

    from tpuslam.core.device import configure_compile_cache

    configure_compile_cache()
    backend = jax.default_backend()
    if backend != "gpu":
        print(json.dumps({"ok": False,
                          "error": f"JAX backend is {backend!r}, not 'gpu'"}))
        return 1
    devices = jax.devices()
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(json.dumps({"ok": False,
                          "error": f"need {need} cards, have {len(devices)}"}))
        return 1

    rng = np.random.default_rng(args.seed)
    failed = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            detail = fn(*a)
            ok = True
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            detail = f"{type(e).__name__}: {e}"
            ok = False
        wall = time.perf_counter() - t0
        print(f"phase {name}: {'PASS' if ok else 'FAIL'} wall={wall:.1f}s "
              f"{detail}", flush=True)
        if not ok:
            failed.append(name)

    if args.four_cards:
        from tpuslam.parallel.mesh import make_mesh

        mesh = make_mesh(devices[:4])
        phase("sharded_icp_1.375M", phase_sharded_icp, rng, mesh)
        phase("sharded_cpd_hybrid_376k", phase_sharded_cpd, rng, mesh)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            phase("nn_kernel_102k", phase_nn_kernel, rng, ICP_SMALL)
            phase("nn_kernel_1.375M", phase_nn_kernel, rng, ICP_LARGE)
            phase("estep_kernel_20k", phase_estep_kernel, rng, ESTEP_SMALL)
            phase("estep_kernel_376k", phase_estep_kernel, rng, CPD_LARGE)
            phase("icp_cli_102k", phase_icp_cli, rng, workdir)
            phase("icp_register_1.375M", phase_icp_register_large, rng)
            phase("cpd_hybrid_376k", phase_cpd_hybrid, rng)
            phase("cpd_estep_arms_20k", phase_cpd_estep_arms, rng,
                  ESTEP_SMALL)
            phase("cpd_estep_arms_376k", phase_cpd_estep_arms, rng,
                  CPD_LARGE)
            phase("nicp_1M", phase_nicp, rng)
            phase("register_pairs_16x16k", phase_register_pairs, rng)
            phase("sequence_stream_5x102k", phase_sequence_stream, rng)
            phase("chip_tests", phase_chip_tests)

    dev = devices[0]
    print(json.dumps({
        "ok": not failed,
        **({"failed": failed} if failed else {}),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
