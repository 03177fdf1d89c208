"""Per-iteration communication model of the sharded algorithms.

(a) An exact byte model of every collective each sharded algorithm
issues per iteration, and (b) a verifier that counts those collectives in
the actual traced programs on a mesh (``tests/test_parallel`` compares
model vs jaxpr, so the model can never silently drift from the code).
Neither describes a machine: link rates and times come from measurement
on the cards, not from here.

The models below count PAYLOAD bytes of each collective's output —
exactly what the jaxpr verifier measures.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def icp_comm_bytes(n_padded: int) -> Dict[str, int]:
    """Per ICP iteration (``tpuslam.parallel.nn.lexmin_combine`` /
    ``sharded_nn_combine`` — both arms share the combine): one ``pmin``
    on f32[N] distances, one lexicographic ``pmin`` on i32[N] global
    indices, one ``psum`` replicating the winning f32[N,3] coordinates."""
    return {
        "pmin_dist_f32N": 4 * n_padded,
        "pmin_index_i32N": 4 * n_padded,
        "psum_matched_f32N3": 12 * n_padded,
        "total": 20 * n_padded,
        "n_collectives": 3,
    }


def cpd_comm_bytes(m_padded: int) -> Dict[str, int]:
    """Per CPD EM iteration, exact E-step (``tpuslam.parallel.cpd``):
    ``psum`` of p1 f32[M], px f32[M,3], log-likelihood f32[], the
    pt1-weighted target moments f32[] and f32[3].  The N-sized pt1 never
    crosses chips — each shard consumes its own slice."""
    return {
        "psum_p1_f32M": 4 * m_padded,
        "psum_px_f32M3": 12 * m_padded,
        "psum_scalars": 4 + 4 + 12,
        "total": 16 * m_padded + 20,
        "n_collectives": 5,
    }


def cpd_init_comm_bytes() -> Dict[str, int]:
    """One-time sigma^2 init: psum of count, sum|a|^2, sum a."""
    return {"total": 4 + 4 + 12, "n_collectives": 3}


def nicp_comm_bytes(k_padded: int, n_candidates: int = 8) -> Dict[str, int]:
    """One NICP shot (``tpuslam.parallel.nicp``): psum'd target moments
    (count f32[], centroid partial f32[3], scatter f32[3,3]) plus the
    sharded exact rescore of ``n_candidates`` x ``k_padded`` subcloud
    rows — the same 20-bytes-per-row combine as ICP, batched over
    candidates by vmap (one collective, n_candidates*k rows)."""
    rescore = 20 * n_candidates * k_padded
    return {
        "psum_moments": 4 + 12 + 36,
        "rescore_combine": rescore,
        "total": 52 + rescore,
        "n_collectives": 6,
    }


# ---------------------------------------------------------------------------
# jaxpr verifier
# ---------------------------------------------------------------------------

COLLECTIVE_PRIMITIVES = {
    "psum", "pmin", "pmax", "all_gather", "ppermute", "all_to_all",
    "reduce_scatter",
}


def collective_bytes(jaxpr) -> List[Tuple[str, tuple, int]]:
    """Walk a (closed) jaxpr recursively — while/cond/scan/pjit/shard_map
    sub-jaxprs included — and return every collective primitive's
    (name, output shape, output bytes).  Loop-body collectives are
    counted ONCE (the jaxpr holds one body instance), which is exactly
    the per-iteration accounting the models above use."""
    out: List[Tuple[str, tuple, int]] = []

    def visit(jx):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if name in COLLECTIVE_PRIMITIVES:
                for v in eqn.outvars:
                    aval = v.aval
                    nbytes = int(aval.size) * aval.dtype.itemsize
                    out.append((name, tuple(aval.shape), nbytes))
            for sub in eqn.params.values():
                for j in _subjaxprs(sub):
                    visit(j)

    def _subjaxprs(param):
        if hasattr(param, "jaxpr") and hasattr(param.jaxpr, "eqns"):
            return [param.jaxpr]  # ClosedJaxpr
        if hasattr(param, "eqns"):  # raw Jaxpr
            return [param]
        if isinstance(param, (list, tuple)):
            subs = []
            for p in param:
                subs.extend(_subjaxprs(p))
            return subs
        return []

    visit(jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr)
    return out


def total_collective_bytes(jaxpr) -> int:
    return sum(b for _, _, b in collective_bytes(jaxpr))
