"""ICP iterations/second at 100k points on one GPU.

Prints ONE JSON line:
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"device": {...}}``.

Baseline: the reference's published GPU number — ICP per-iteration time
under 100 ms at 100k points on an RTX 2060 SUPER (documentation.tex:407;
BASELINE.md), i.e. 10 iterations/sec.  ``vs_baseline`` is the speedup
ratio over that.

Protocol: ``tpuslam.harness.measure`` (reference settings: spread 10,
rotation 0.2 rad, translation 10 — documentation.tex:397 — on the
``synthetic://`` model substitute).  Timing covers the full per-iteration
pipeline: the NN kernel, weighted Procrustes with 3x3 SVD, transform and
error — the work the reference times per iteration, minus its 4+ host
round trips.

Exits non-zero, printing no result, unless JAX's backend is the GPU.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import jax

    from tpuslam.core.device import configure_compile_cache

    configure_compile_cache()
    if jax.default_backend() != "gpu":
        print(
            f"bench.py measures the GPU; JAX's backend is "
            f"{jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 1

    from tpuslam.harness.measure import N_POINTS, measure_icp_100k

    m = measure_icp_100k()
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": f"icp_iters_per_sec_{N_POINTS // 1024}k",
                "value": m["iters_per_sec"],
                "unit": "iter/s",
                "vs_baseline": m["vs_baseline"],
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
