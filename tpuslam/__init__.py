"""tpuslam — rigid point-set registration in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA design of the capabilities of the CUDA/C++
reference ``Sliwson/cuda-slam`` (see SURVEY.md): three rigid registration
algorithms (ICP, non-iterative CP, Coherent Point Drift) behind one
registration API, the reference's JSON config contract, cloud synthesis
pipeline, benchmark harness and CSV output:

* one algorithm implementation per method (no CPU/GPU twins) that runs on
  the CPU for tests and on the GPU for production,
* the O(N*M) hot loops (NN correspondence argmin, CPD responsibility
  accumulation) as fused Pallas kernels through the Triton route,
  selected by platform in ``tpuslam.core.device``,
* multi-card scaling by sharding the target cloud over a device mesh and
  reducing argmins / moment sums with XLA collectives (NCCL).
"""

__version__ = "0.1.0"

from tpuslam.core.types import RigidTransform, Cloud, pad_cloud, unpad  # noqa: F401
from tpuslam.config.configuration import (  # noqa: F401
    Configuration,
    ComputationMethod,
    ExecutionPolicy,
    ApproximationType,
)


def register(before, after, config=None, **overrides):
    """One-call registration: host ``f32[N,3]`` arrays in, (rotation,
    translation, iterations, error) out — the reference's ``SlamFunc``
    contract (``testrunner.h:8``) as a library call.

    ``config`` defaults to an ICP ``Configuration``; keyword overrides are
    applied on top (e.g. ``register(a, b, computation_method=
    ComputationMethod.Cpd, cpd_weight=0.1)``)."""
    from dataclasses import replace

    from tpuslam.algorithms.registry import run_with_configuration

    if config is None:
        config = Configuration()
    if overrides:
        config = replace(config, **overrides)
    return run_with_configuration(before, after, config)


def register_sequence(clouds, **kwargs):
    """Sequential scan odometry: register consecutive clouds pairwise
    and compose absolute poses (``tpuslam.algorithms.sequence``) —
    beyond-reference scope; see that module's docstring."""
    from tpuslam.algorithms.sequence import register_sequence as _rs

    return _rs(clouds, **kwargs)


def sequence_stream(first_scan, **kwargs):
    """Incremental (streaming) odometry: returns a ``SequenceStream``
    whose ``push(scan)`` registers each arriving scan against the
    previous one in ONE seeded device dispatch, retaining every
    cloud's device artifacts so each scan is transferred and prepared
    exactly once (``tpuslam.algorithms.sequence.SequenceStream``)."""
    from tpuslam.algorithms.sequence import SequenceStream

    return SequenceStream(first_scan, **kwargs)


def register_pairs(befores, afters, config=None, **overrides):
    """Batched multi-pair registration: sequences of host ``f32[N_i,3]``
    arrays in, per-pair (rotations f32[B,3,3], translations f32[B,3],
    iterations i32[B], errors f32[B]) out — B registrations as ONE
    compiled program whose per-pair work batches onto the same kernels
    (new scope vs the single-pair reference binary; the production
    many-scan-pairs regime).

    Same configuration contract as :func:`register`; each pair's result
    equals its solo :func:`register` run."""
    import numpy as np
    from dataclasses import replace

    from tpuslam.algorithms.batch import (
        cpd_register_batch,
        icp_register_batch,
        nicp_register_batch,
        stack_clouds,
    )

    if len(befores) != len(afters):
        raise ValueError(
            f"pair count mismatch: {len(befores)} befores vs "
            f"{len(afters)} afters"
        )
    if config is None:
        config = Configuration()
    if overrides:
        config = replace(config, **overrides)
    b, a = stack_clouds(befores), stack_clouds(afters)
    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None
        else -1
    )
    method = config.computation_method
    if method == ComputationMethod.Icp:
        if config.icp_prealign:
            from tpuslam.algorithms.batch import icp_register_prealigned_batch

            res = icp_register_prealigned_batch(
                b, a,
                eps=config.convergence_epsilon,
                max_distance_squared=config.max_distance_squared,
                max_iterations=max_iterations,
                subcloud_size=config.nicp_subcloud_size,
                seed=(
                    config.random_seed
                    if config.random_seed is not None else 0
                ),
            )
        else:
            res = icp_register_batch(
                b, a,
                eps=config.convergence_epsilon,
                max_distance_squared=config.max_distance_squared,
                max_iterations=max_iterations,
            )
        rotation = np.asarray(res.transform.rotation)
    elif method == ComputationMethod.NoniterativeIcp:
        res = nicp_register_batch(
            b, a,
            eps=config.convergence_epsilon,
            approximation_type=config.approximation_type,
            subcloud_size=config.nicp_subcloud_size,
            seed=config.random_seed if config.random_seed is not None else 0,
        )
        rotation = np.asarray(res.transform.rotation)
    else:
        res = cpd_register_batch(
            b, a,
            eps=config.convergence_epsilon,
            weight=config.cpd_weight,
            const_scale=config.cpd_const_scale,
            max_iterations=max_iterations,
            tolerance=config.cpd_tolerance,
            approximation_type=config.approximation_type,
            use_fgt=config.cpd_use_fgt,
            order_of_truncation=config.order_of_truncation,
            ratio_of_far_field=config.ratio_of_far_field,
            centroid_init=config.cpd_centroid_init,
        )
        # the reference returns (scale * R, t) (coherentpointdrift.cpp:123)
        rotation = np.asarray(res.transform.scale)[:, None, None] * (
            np.asarray(res.transform.rotation)
        )
    return (
        rotation,
        np.asarray(res.transform.translation),
        np.asarray(res.iterations),
        np.asarray(res.error),
    )
