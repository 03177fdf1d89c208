"""Platform-keyed kernel selection and the compile-cache location.

The hand-written kernels (``tpuslam.kernels``) go through Pallas's
Triton route, which compiles only for the GPU.  Every call site that has
a kernel and a plain jnp reference picks between them here, keyed on the
platform, so no other module tests the backend.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, TypeVar

import jax

F = TypeVar("F", bound=Callable)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_kernels(platform: Optional[str] = None) -> bool:
    """True on ``"gpu"`` (run the Triton kernels), False on ``"cpu"``
    (run the jnp references).  Any other platform is an error: there is
    no silent fallback.  ``platform`` defaults to JAX's backend."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(f"no kernel selection for platform {platform!r}")


def select(
    kernel: F,
    reference: F,
    use_pallas: Optional[bool] = None,
    platform: Optional[str] = None,
) -> F:
    """The one kernel selection: ``kernel`` or ``reference``.

    ``use_pallas`` True/False forces an arm (tests and the chip smoke run
    compare the two); None picks by platform (``use_kernels``)."""
    if use_pallas is None:
        use_pallas = use_kernels(platform)
    return kernel if use_pallas else reference


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir``
    (entry points call this before their first compile)."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
