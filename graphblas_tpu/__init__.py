"""graphblas_tpu — a GraphBLAS framework on JAX accelerators.

A from-scratch reimagining of the GraphBLAS C API v1.2 (reference:
SuiteSparse:GraphBLAS v2.3.3) for accelerators, built on JAX/XLA/Pallas
and run on NVIDIA GPUs:

* immutable pytree matrices (dense-bitmap for graphs that fit as
  dense operands, padded-CSR in :mod:`graphblas_tpu.sparse` for large
  ones)
* semirings as data — (monoid, binop) pairs of traceable functions —
  replacing the reference's 247 KLoC of generated C workers
* masks and accumulators fused into kernels as epilogues
* distribution via ``jax.sharding`` meshes (:mod:`graphblas_tpu.parallel`)
  instead of MPI

Quick start::

    import graphblas_tpu as gb
    A = gb.Matrix.from_coo(I, J, X, n, n)
    C = gb.mxm(gb.Matrix.new(gb.FP64, n, n), None, None,
               gb.semiring.plus_times[gb.FP64], A, A)
"""

import os as _os

import jax as _jax

# fp64/int64 parity with the reference requires x64 mode; fast paths use
# explicit 32-bit dtypes so this does not slow the perf-critical kernels.
_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the reference has NO compile step at
# all, so cold-start parity demands compiles be paid once per machine,
# not once per process.  Where JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it itself and nothing is set here; otherwise the cache sits at a
# fixed path in the checkout (a path that moves never hits).  Skipped
# under forced-CPU runs: XLA:CPU AOT cache entries record host-feature
# sets that vary across processes and can reload with mismatched
# features.
if "cpu" not in _os.environ.get("JAX_PLATFORMS", "").lower():
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache"))
    # cache every program: a first call traces ~20 programs, most of
    # them below JAX's default size and time thresholds
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

from .core.types import (Type, BOOL, INT8, UINT8, INT16, UINT16, INT32,
                         UINT32, INT64, UINT64, FP32, FP64, FC32, FC64,
                         BUILTIN_TYPES, type_of_dtype)
from .core.ops import (UnaryOp, BinaryOp, SelectOp, unary, binary, select
                       as selectop, binary_op, unary_op)
from .core.monoids import Monoid, monoid, MONOIDS, monoid_new
from .core.semirings import (Semiring, semiring, SEMIRINGS, semiring_new,
                             lookup as semiring_lookup)
from .core.descriptor import (Descriptor, NULL_DESC, REPLACE, SCMP, TRAN0,
                              TRAN1, RT, ST, RST, TT)
from .core.errors import (Info, GraphBLASError, DimensionMismatch,
                          DomainMismatch, IndexOutOfBounds, InvalidValue)
from .core.matrix import Matrix, Vector
from .utils.indices import ALL

from .core.options import (Options, global_options, init, set_option,
                           get_option, BLOCKING, NONBLOCKING, BY_ROW,
                           BY_COL)
from .core.io_export import (import_csr, import_csc, import_hyper_csr,
                             import_hyper_csc, export_hyper_csc,
                             export_csr, export_hyper_csr,
                             export_csc, import_vector,
                             export_vector)
from .core.printing import fprint, check, SILENT, SUMMARY, SHORT, COMPLETE

from .ops.mxm import mxm, mxv, vxm, semiring_mm
from .ops.ewise import eWiseAdd, eWiseMult, apply, select
from .ops.reduce import reduce, reduce_to_vector, reduce_to_scalar
from .ops.transpose import transpose, kron
from .ops.extract import extract, extract_vector, extract_col
from .ops.assign import (assign, subassign, assign_scalar, subassign_scalar,
                         assign_vector, subassign_vector, row_assign,
                         col_assign)

__version__ = "0.1.0"

__all__ = [
    # types
    "Type", "BOOL", "INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32",
    "INT64", "UINT64", "FP32", "FP64", "FC32", "FC64", "BUILTIN_TYPES",
    "type_of_dtype",
    # algebra
    "UnaryOp", "BinaryOp", "SelectOp", "unary", "binary", "selectop",
    "binary_op", "unary_op", "Monoid", "monoid", "MONOIDS", "monoid_new",
    "Semiring", "semiring", "SEMIRINGS", "semiring_new", "semiring_lookup",
    # descriptors / errors
    "Descriptor", "NULL_DESC", "REPLACE", "SCMP", "TRAN0", "TRAN1", "RT",
    "ST", "RST", "TT", "Info", "GraphBLASError", "DimensionMismatch",
    "DomainMismatch", "IndexOutOfBounds", "InvalidValue",
    # containers
    "Matrix", "Vector", "ALL",
    # operations
    "mxm", "mxv", "vxm", "semiring_mm", "eWiseAdd", "eWiseMult", "apply",
    "select", "reduce", "reduce_to_vector", "reduce_to_scalar", "transpose",
    "kron", "extract", "extract_vector", "extract_col", "assign",
    "subassign", "assign_scalar", "subassign_scalar", "assign_vector",
    "subassign_vector", "row_assign", "col_assign",
    # options / io / printing
    "Options", "global_options", "init", "set_option", "get_option",
    "BLOCKING", "NONBLOCKING", "BY_ROW", "BY_COL", "import_csr",
    "import_csc", "import_hyper_csr", "import_hyper_csc", "export_csr",
    "export_hyper_csr", "export_hyper_csc", "export_csc",
    "import_vector", "export_vector", "fprint", "check", "SILENT",
    "SUMMARY", "SHORT", "COMPLETE",
]
