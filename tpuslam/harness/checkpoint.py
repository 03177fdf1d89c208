"""Disk checkpoint/resume for long chunked registrations (SURVEY §5.4).

The reference has no checkpointing (its runs are seconds–minutes,
``documentation.tex``); at production scale a million-point ICP run or a
mustang-scale CPD EM is minutes of device time dispatched in
warm-started chunks (``icp_register_chunked`` / ``cpd_register_chunked``),
and each chunk boundary is already the exact loop state.  This module
makes that boundary durable: save after a chunk, load to continue in a
new process — same trajectory, same iteration count.

Format: one ``.npz`` with the resume leaves plus a JSON header
(format version, checkpoint kind, and a metadata blob).  Loading
validates the kind and every caller-expected metadata key — including
cloud *fingerprints* (masked coordinate sums) the chunked drivers put
there — so a checkpoint can never silently resume a different
registration; the drivers treat a mismatch as "not my checkpoint" and
start fresh (see ``icp_register_chunked``).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from tpuslam.algorithms.icp import ICPResume

_VERSION = 1

# everything a checkpoint file can throw at a loader: metadata mismatch
# (ValueError), a truncated/zero-byte file from a killed legacy save
# (BadZipFile / EOFError / OSError), or a well-formed npz missing our
# arrays (KeyError).  All of them mean "not my checkpoint" to a driver.
LOAD_ERRORS = (
    ValueError,
    OSError,
    EOFError,
    KeyError,
    zipfile.BadZipFile,
    json.JSONDecodeError,
)


def cloud_fingerprint(points, mask) -> List[float]:
    """Cheap content fingerprint for checkpoint metadata: masked
    per-axis coordinate sums, the masked sum of squares, and a
    row-order-weighted sum (f32 accumulation — deterministic for
    identical input on the same backend; any perturbation that changes
    the run changes it).

    Each term closes a degeneracy a plain coordinate sum has: per-axis
    sums don't collapse toward 0 under rotation the way a total sum of
    a centered cloud does; the sum of squares separates clouds whose
    sums coincide; and the order-weighted term separates row
    PERMUTATIONS of the same cloud — those change the f32 summation
    order of every reduction, hence the bits of the trajectory, so row
    order is part of the state's identity."""
    import jax.numpy as jnp

    masked = points * mask[:, None]
    sums = jnp.sum(masked, axis=0, dtype=jnp.float32)
    ssq = jnp.sum(masked * masked, dtype=jnp.float32)
    w = (
        jnp.arange(1, points.shape[0] + 1, dtype=jnp.float32)
        / points.shape[0]
    )
    ordered = jnp.sum(masked * w[:, None], dtype=jnp.float32)
    return [
        float(sums[0]),
        float(sums[1]),
        float(sums[2]),
        float(ssq),
        float(ordered),
    ]


def _save(path: str, kind: str, arrays: dict, meta: Optional[dict]) -> None:
    header = json.dumps(
        {"version": _VERSION, "kind": kind, "meta": meta or {}}
    )
    arrays["header"] = np.frombuffer(header.encode(), dtype=np.uint8)
    # atomic: a run killed mid-save (the exact scenario checkpointing
    # exists for) must never leave a truncated file at `path`
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(z, kind: str, expect_meta: Optional[dict]) -> dict:
    header = json.loads(bytes(z["header"]).decode())
    if header.get("version") != _VERSION:
        raise ValueError(
            f"checkpoint version {header.get('version')} != {_VERSION}"
        )
    # files written before the kind tag existed were all ICP
    if header.get("kind", "icp") != kind:
        raise ValueError(
            f"checkpoint mismatch on kind: stored "
            f"{header.get('kind')!r}, expected {kind!r}"
        )
    meta = header.get("meta", {})
    if expect_meta:
        for key, want in expect_meta.items():
            got = meta.get(key)
            if got != want:
                raise ValueError(
                    f"checkpoint mismatch on {key!r}: stored {got!r}, "
                    f"expected {want!r}"
                )
    return meta


def save_icp_checkpoint(
    path: str, resume: ICPResume, meta: Optional[dict] = None
) -> None:
    """Write ``resume`` (transform, guard state, iterations done) and
    ``meta`` to ``path`` as ``.npz``."""
    arrays = {
        "rotation": np.asarray(resume.rotation, np.float32),
        "translation": np.asarray(resume.translation, np.float32),
        "error": np.asarray(resume.error, np.float32),
        "done_before": np.asarray(resume.done_before, np.int32),
    }
    if resume.prev_error is not None:
        arrays["prev_error"] = np.asarray(resume.prev_error, np.float32)
    _save(path, "icp", arrays, meta)


def load_icp_checkpoint(
    path: str, expect_meta: Optional[dict] = None
) -> Tuple[ICPResume, dict]:
    """Load a checkpoint; if ``expect_meta`` is given, every key in it
    must match the stored metadata exactly (shape/parameter/fingerprint
    guard)."""
    with np.load(path) as z:
        meta = _load(z, "icp", expect_meta)
        # files from older builds may also hold NN warm-state arrays;
        # they only ever affected speed, so they are ignored
        resume = ICPResume(
            rotation=z["rotation"],
            translation=z["translation"],
            error=z["error"],
            done_before=int(z["done_before"]),
            prev_error=z["prev_error"] if "prev_error" in z else None,
        )
    return resume, meta


def save_cpd_checkpoint(
    path: str, resume, meta: Optional[dict] = None
) -> None:
    """Write a ``CPDResume`` (full EM loop state at a chunk boundary) to
    ``path`` as ``.npz`` (see ``cpd_register_chunked``)."""
    arrays = {
        "rotation": np.asarray(resume.rotation, np.float32),
        "translation": np.asarray(resume.translation, np.float32),
        "scale": np.asarray(resume.scale, np.float32),
        "sigma2": np.asarray(resume.sigma2, np.float32),
        "log_likelihood": np.asarray(resume.log_likelihood, np.float32),
        "ntol": np.asarray(resume.ntol, np.float32),
        "done_before": np.asarray(resume.done_before, np.int32),
    }
    _save(path, "cpd", arrays, meta)


def load_cpd_checkpoint(path: str, expect_meta: Optional[dict] = None):
    """Load a CPD checkpoint written by :func:`save_cpd_checkpoint`;
    metadata keys in ``expect_meta`` must match exactly."""
    from tpuslam.algorithms.cpd import CPDResume

    with np.load(path) as z:
        meta = _load(z, "cpd", expect_meta)
        resume = CPDResume(
            rotation=z["rotation"],
            translation=z["translation"],
            scale=z["scale"],
            sigma2=z["sigma2"],
            log_likelihood=z["log_likelihood"],
            ntol=z["ntol"],
            done_before=int(z["done_before"]),
        )
    return resume, meta


def load_resume_or_none(
    path: str,
    kind: str,
    expect_meta: Optional[dict],
    quiet: bool = False,
):
    """The chunked drivers' shared load policy: return the resume state
    when ``path`` holds a checkpoint matching ``expect_meta`` exactly,
    else ``None`` — treating a missing, mismatched, truncated, or
    corrupt file identically as "not this registration's state" (start
    fresh and overwrite).  Prints one notice for non-missing failures
    unless ``quiet``."""
    if not os.path.exists(path):
        return None
    loader = load_icp_checkpoint if kind == "icp" else load_cpd_checkpoint
    try:
        resume, _ = loader(path, expect_meta=expect_meta)
        return resume
    except LOAD_ERRORS as exc:
        if not quiet:
            print(
                f"[tpuslam] ignoring checkpoint {path} "
                f"(not this registration's state: {exc!r})"
            )
        return None
