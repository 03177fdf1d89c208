"""Multi-process initialization (SURVEY §5.8 — new scope vs the
single-GPU reference, which has no communication backend at all).

One process drives all the GPUs of one host, and ``make_mesh`` over
``jax.devices()`` needs no initialization: the sharded registration entry
points (``icp_register_sharded`` / ``cpd_register_sharded`` /
``nicp_register_sharded``) issue their ``psum``/``pmin`` collectives,
which XLA hands to NCCL over NVLink.

Only a run with several processes (one per host, or one per card) calls
``initialize()`` once per process before any other jax use, with an
explicit coordinator: nothing in the environment describes the cluster.
"""

from __future__ import annotations

from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` passthrough.  Give all three
    arguments (for example ``"localhost:<port>"``, the process count and
    this process's index); there is no cluster auto-detection here."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multi_process() -> bool:
    import jax

    return jax.process_count() > 1
