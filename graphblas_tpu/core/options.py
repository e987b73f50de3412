"""Global / per-call option system.

Reference: three scopes (``Include/GraphBLAS.h:2917-2930``) —
global ``GxB_Global_Option_set/get`` (HYPER ratio, FORMAT, MODE,
NTHREADS), per-matrix ``GxB_Matrix_Option_set``, per-call descriptors.

Mapping here: HYPER ratio drives CSR<->hypersparse conformance
(``sparse.hyper.hyper_conform``, the GB_to_hyper_conform rule) at
container boundaries; FORMAT by-row/by-col survives as the default
transpose orientation; MODE blocking/non-blocking controls whether
``setElement`` folds immediately; NTHREADS becomes the device/
block-size hints the kernels consult.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

__all__ = ["Options", "global_options", "init", "set_option", "get_option",
           "BLOCKING", "NONBLOCKING", "BY_ROW", "BY_COL"]

BLOCKING = "blocking"
NONBLOCKING = "nonblocking"
BY_ROW = "by_row"
BY_COL = "by_col"


@dataclasses.dataclass
class Options:
    mode: str = NONBLOCKING          # GrB_Mode
    format: str = BY_ROW             # GxB_FORMAT
    hyper_ratio: float = 1.0 / 16    # GxB_HYPER: hyper_conform threshold
    nthreads: int = 0                # 0 = all devices / auto block size
    backend: str = "auto"            # 'bitmap' | 'csr' | 'bsr' | 'auto'
    chunk: int = 1 << 14             # edge-chunk for gather kernels


_state = threading.local()


def global_options() -> Options:
    opts = getattr(_state, "opts", None)
    if opts is None:
        opts = Options()
        _state.opts = opts
    return opts


def init(mode: str = NONBLOCKING) -> None:
    """``GrB_init`` analogue: reset global options, set the mode.
    (Device/runtime init is jax's job; this configures the framework.)"""
    _state.opts = Options(mode=mode)


def set_option(name: str, value) -> None:
    opts = global_options()
    if not hasattr(opts, name):
        raise KeyError(f"unknown option {name!r}")
    setattr(opts, name, value)


def get_option(name: str):
    return getattr(global_options(), name)
