"""Method dispatch: one registration API over all algorithms.

The equivalent of the reference's dispatch switches
(``cpumain.cpp:11-24``, ``gpumain.cpp:12-38``) and its shared ``SlamFunc``
signature (``testrunner.h:8``): ``run_with_configuration(before, after,
config) -> (rotation, translation, iterations, error)``.  There is ONE
implementation per method (no CPU/GPU twins): the same jitted code runs on
the CPU in tests and on the GPU in production (SURVEY §1 "key
architectural idea"); only the kernels differ, chosen in
``tpuslam.core.device``.

Long runs are chunked only on request: an explicit chunk
(``TPUSLAM_ICP_CHUNK`` / ``TPUSLAM_CPD_CHUNK`` = iterations per
dispatch) or a checkpoint path (``TPUSLAM_ICP_CKPT`` /
``TPUSLAM_CPD_CKPT``), since the chunk boundary is the durable unit.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from tpuslam.config.configuration import (
    ComputationMethod,
    Configuration,
)
from tpuslam.core.types import pad_cloud

# (rotation f32[3,3], translation f32[3], iterations, error)
SlamResult = Tuple[np.ndarray, np.ndarray, int, float]
SlamFunc = Callable[[np.ndarray, np.ndarray, Configuration], SlamResult]

_REGISTRY: Dict[ComputationMethod, SlamFunc] = {}


def register(method: ComputationMethod):
    def deco(fn: SlamFunc) -> SlamFunc:
        _REGISTRY[method] = fn
        return fn

    return deco


def get_slam_func(method: ComputationMethod) -> SlamFunc:
    if method not in _REGISTRY:
        raise KeyError(f"no implementation registered for {method}")
    return _REGISTRY[method]


def run_with_configuration(
    before: np.ndarray, after: np.ndarray, config: Configuration
) -> SlamResult:
    return get_slam_func(config.computation_method)(before, after, config)


# iterations per dispatch of a checkpointed run with no explicit chunk
CHECKPOINT_CHUNK = 10


def chunk_size(chunk_env) -> int:
    """Iterations per dispatch requested by a ``TPUSLAM_*_CHUNK`` value
    (0 = whole loop at once).  Unset or malformed means no request."""
    if chunk_env is None:
        return 0
    try:
        return max(0, int(chunk_env))
    except ValueError:
        print(f"[tpuslam] ignoring malformed chunk request {chunk_env!r}")
        return 0


@register(ComputationMethod.Icp)
def _run_icp(
    before: np.ndarray, after: np.ndarray, config: Configuration
) -> SlamResult:
    """Mirrors ``CalculateICPWithConfiguration`` (``basicicp.cpp:12-21``)."""
    import os

    from tpuslam.algorithms.icp import icp_register, icp_register_chunked

    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    common = dict(
        eps=config.convergence_epsilon,
        max_distance_squared=config.max_distance_squared,
        max_iterations=max_iterations,
    )
    # TPUSLAM_ICP_CKPT=path persists every chunk boundary so a killed
    # run (`python -m tpuslam cfg.json`) continues from disk
    # (tpuslam.harness.checkpoint); checkpointing runs the chunked
    # driver (the boundary is the durable unit)
    ckpt = os.environ.get("TPUSLAM_ICP_CKPT")
    chunk = chunk_size(os.environ.get("TPUSLAM_ICP_CHUNK"))
    if ckpt and not chunk:
        chunk = CHECKPOINT_CHUNK
    if config.icp_prealign:
        from tpuslam.algorithms.icp import icp_register_prealigned

        result = icp_register_prealigned(
            pad_cloud(before), pad_cloud(after), chunk=chunk,
            subcloud_size=config.nicp_subcloud_size,
            seed=config.random_seed if config.random_seed is not None else 0,
            checkpoint_path=ckpt,
            **common,
        )
    elif chunk:
        result = icp_register_chunked(
            pad_cloud(before), pad_cloud(after), chunk=chunk,
            checkpoint_path=ckpt,
            **common,
        )
    else:
        result = icp_register(pad_cloud(before), pad_cloud(after), **common)
    return (
        np.asarray(result.transform.rotation),
        np.asarray(result.transform.translation),
        int(result.iterations),
        float(result.error),
    )


@register(ComputationMethod.NoniterativeIcp)
def _run_nicp(
    before: np.ndarray, after: np.ndarray, config: Configuration
) -> SlamResult:
    """Mirrors ``CalculateNonIterativeWithConfiguration``
    (``noniterative.cpp:14-23``)."""
    from tpuslam.algorithms.nicp import degenerate_axes_for, nicp_register

    # degenerate-spectrum hardening (extension):
    # a cheap host-side eigengap pre-pass decides STATICALLY whether the
    # principal axes are ambiguous (near-tied eigenvalues) and widens
    # the candidate set with in-plane rotations when they are.  Config
    # knob nicp-degenerate-widening: absent = this auto pass, 0 = off,
    # N = force N angles per degenerate axis.
    widen = config.nicp_degenerate_widening
    if widen is None:
        axes = degenerate_axes_for(before, after)
        angles = 16 if axes else 0
    elif widen > 1:
        axes = degenerate_axes_for(before, after) or (0,)
        angles = widen
    else:
        axes, angles = (), 0

    result = nicp_register(
        pad_cloud(before),
        pad_cloud(after),
        eps=config.convergence_epsilon,
        approximation_type=config.approximation_type,
        subcloud_size=config.nicp_subcloud_size,
        seed=config.random_seed if config.random_seed is not None else 0,
        degenerate_angles=angles,
        degenerate_axes=axes,
    )
    return (
        np.asarray(result.transform.rotation),
        np.asarray(result.transform.translation),
        int(result.iterations),
        float(result.error),
    )


@register(ComputationMethod.Cpd)
def _run_cpd(
    before: np.ndarray, after: np.ndarray, config: Configuration
) -> SlamResult:
    """Mirrors ``CalculateCpdWithConfiguration``
    (``coherentpointdrift.cpp:43-65``).  NOTE the parser truth: a missing
    ``max-iterations`` maps to -1 and the reference's EM loop condition
    ``iterations < maxIterations`` is then immediately false — zero
    iterations, identity result (``coherentpointdrift.cpp:104``).  We
    reproduce that."""
    import os

    from tpuslam.algorithms.cpd import cpd_register, cpd_register_chunked

    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    common = dict(
        eps=config.convergence_epsilon,
        weight=config.cpd_weight,
        const_scale=config.cpd_const_scale,
        max_iterations=max_iterations,
        tolerance=config.cpd_tolerance,
        approximation_type=config.approximation_type,
        ratio_of_far_field=config.ratio_of_far_field,
        order_of_truncation=config.order_of_truncation,
        use_fgt=config.cpd_use_fgt,
        centroid_init=config.cpd_centroid_init,
    )
    padded_before, padded_after = pad_cloud(before), pad_cloud(after)
    # TPUSLAM_CPD_CKPT=path runs the chunked driver and persists every
    # chunk boundary (same contract as TPUSLAM_ICP_CKPT)
    ckpt = os.environ.get("TPUSLAM_CPD_CKPT")
    chunk = chunk_size(os.environ.get("TPUSLAM_CPD_CHUNK"))
    if ckpt and not chunk:
        chunk = CHECKPOINT_CHUNK
    if chunk:
        result = cpd_register_chunked(
            padded_before, padded_after, chunk=chunk,
            checkpoint_path=ckpt, **common,
        )
    else:
        result = cpd_register(padded_before, padded_after, **common)
    # the reference returns (scale * R, t) (coherentpointdrift.cpp:123)
    rotation = np.asarray(result.transform.scale) * np.asarray(
        result.transform.rotation
    )
    return (
        rotation,
        np.asarray(result.transform.translation),
        int(result.iterations),
        float(result.error),
    )
