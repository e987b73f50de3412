"""What the device this process runs on offers: the one place where
kernel and lowering choices read the platform.

Interpret mode is never chosen here: a Pallas kernel runs compiled on
the device it was written for, and only tests ask for the interpreter,
by argument.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["platform", "triton_kernels", "x64_dot_ok"]


def platform() -> str:
    """JAX's default backend: ``"gpu"`` or ``"cpu"``."""
    return jax.default_backend()


@functools.lru_cache(maxsize=None)
def x64_dot_ok() -> bool:
    """Whether the backend lowers s64/u64 ``dot_general``.  XLA:CPU and
    XLA:GPU both do (the GPU one with its own emitter, as no BLAS
    library has 64-bit integer products).  Where this is False, 64-bit
    integer semirings take the generic elementwise path."""
    return platform() in ("cpu", "gpu")


def triton_kernels() -> bool:
    """Whether the repository's Pallas Triton kernels compile here: on
    the GPU only.  Elsewhere callers take the kernel's XLA form."""
    return platform() == "gpu"
