"""Reductions: matrix -> vector (per-row monoid reduce) and -> scalar.

Reference: ``Source/GB_reduce_to_column.c`` (w<m> = accum(w, sum(A)) across
rows) and ``GB_reduce_to_scalar.c`` (linear scan with terminal early-exit).
On the device a reduction is one fused pass; the "terminal" optimization is
moot inside a single fused kernel but monoid terminals are still used by
host-side iteration loops (e.g. BFS convergence tests).
"""

from __future__ import annotations

from dataclasses import replace as _dc_replace
from typing import Any, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector
from ..core.monoids import Monoid
from ..core.ops import BinaryOp
from ..core.types import cast, cast_value
from ..utils import counters

__all__ = ["reduce_to_vector", "reduce_to_scalar", "reduce"]


def _as_monoid(op: Union[Monoid, BinaryOp], *operands) -> Monoid:
    from ..core.resolve import UnsupportedOp, resolve_monoid
    op = resolve_monoid(op, "reduce op", None, *operands)
    if isinstance(op, Monoid):
        return op
    # a bare associative binary op: look up the matching built-in monoid
    from ..core.monoids import monoid as monoid_ns
    try:
        return monoid_ns[op.name.lower()][op.ztype]
    except (KeyError, AttributeError):
        raise UnsupportedOp(
            f"reduce op: {op.name} has no matching built-in monoid; "
            "pass a Monoid (monoid_new) instead") from None


@counters.counted("reduce_to_vector")
def reduce_to_vector(w: Vector, m: Optional[Vector],
                     accum: Optional[BinaryOp],
                     op: Union[Monoid, BinaryOp], A: Matrix,
                     desc: Optional[Descriptor] = None) -> Vector:
    """w<m> = accum(w, reduce-rows(A)); TRAN0 reduces columns instead.

    Sparse containers reduce without densifying: CSR through one device
    segment-reduce (``csr_reduce_rows``), hypersparse through the
    present-row fold (``hyper_reduce_vector``) scattered into the dense
    ``w`` (which bounds nrows at the Vector's own capacity)."""
    from .containers import require_container
    require_container(w, "reduce output w")
    require_container(m, "reduce mask", none_ok=True)
    require_container(A, "reduce input A")
    d = desc_of(desc)
    from ..core.resolve import resolve_accum
    accum = resolve_accum(accum, "reduce accum", None, w, A)
    mon = _as_monoid(op, A, w)
    from ..sparse.container import CsrMatrix, CscMatrix
    from ..sparse.hyper import HyperMatrix
    from ..sparse.vector import SparseVec
    from .containers import UnsupportedContainer, to_csr_operand
    if isinstance(w, SparseVec):
        # sparse output at any dimension: per-row fold is already
        # sparse over A.h; epilogue on the wrapped 1-column matrix
        from ..sparse.hyper import (hyper_accum_mask,
                                    hyper_reduce_vector,
                                    hyper_transpose)
        from .containers import to_hyper_operand, vec_hyper_operand
        Ah = to_hyper_operand(A, d.tran0, "reduce input")
        if Ah.nrows != w.size:
            raise DimensionMismatch(
                f"w has size {w.size}, A has {Ah.nrows} rows")
        ids, vals = hyper_reduce_vector(mon, Ah.wait())
        T = SparseVec.from_coo(ids, vals, w.size, type=mon.type,
                               dup=None).hm
        mh = vec_hyper_operand(m, "mask") if m is not None else None
        return SparseVec(hyper_accum_mask(
            w.hm, mh, T, accum, replace=d.replace,
            complement=d.mask_scmp, structural=d.mask_structure))
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(A, HyperCscMatrix):
        # stored transpose: row-reduce of A = col-reduce of A.tr
        A, d = A.tr, _dc_replace(d, tran0=not d.tran0)
    if isinstance(A, HyperMatrix):
        from ..sparse.hyper import hyper_reduce_vector, hyper_transpose
        A = A.wait()
        if d.tran0:
            A = hyper_transpose(A)
        if A.nrows != w.shape[0]:
            raise DimensionMismatch(
                f"w has size {w.shape[0]}, A has {A.nrows} rows")
        ids, vals = hyper_reduce_vector(mon, A)
        red = jnp.zeros((w.shape[0],), np.dtype(mon.type.dtype)).at[
            jnp.asarray(ids)].set(jnp.asarray(vals))
        tpat = jnp.zeros((w.shape[0],), bool).at[jnp.asarray(ids)].set(
            True)
        T = Vector(red, tpat, mon.type)
        return accum_mask(w, m, T, accum, d)
    if isinstance(A, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_reduce_rows
        A = to_csr_operand(A, d.tran0, "reduce input")
        if A.nrows != w.shape[0]:
            raise DimensionMismatch(
                f"w has size {w.shape[0]}, A has {A.nrows} rows")
        red, tpat = csr_reduce_rows(mon, A)
        T = Vector(red, tpat, mon.type)
        return accum_mask(w, m, T, accum, d)
    A = A.wait()
    vals, pat = A.values, A.pattern
    if d.tran0:
        vals = jax.tree_util.tree_map(lambda a: a.T, vals)
        pat = pat.T
    if not mon.type.is_udt:
        vals = cast(vals, mon.type)
    red = mon.reduce(vals, axis=1, where=pat)
    tpat = jnp.any(pat, axis=1)
    T = Vector(red, tpat, mon.type).canonical()
    return accum_mask(w, m, T, accum, d)


@counters.counted("reduce_to_scalar")
def reduce_to_scalar(accum: Optional[BinaryOp], op: Union[Monoid, BinaryOp],
                     A, c: Any = None):
    """c = accum(c, reduce-all(A)); returns a host scalar.

    Empty A reduces to the monoid identity (``GB_reduce_to_scalar.c:35``).
    """
    from .containers import require_container
    require_container(A, "reduce input A")
    from ..core.resolve import resolve_accum
    accum = resolve_accum(accum, "reduce accum", None, A)
    mon = _as_monoid(op, A)
    from ..sparse.container import CsrMatrix, CscMatrix
    from ..sparse.hyper import HyperMatrix
    from ..sparse.vector import SparseVec
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(A, SparseVec):
        A = A.hm
    if isinstance(A, HyperCscMatrix):
        A = A.tr               # reduce-all is orientation-invariant
    if isinstance(A, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_reduce_scalar
        t = csr_reduce_scalar(mon, (A.tr if isinstance(A, CscMatrix)
                                    else A).wait())
        if accum is not None and c is not None:
            t = jax.device_get(accum(jnp.asarray(c), jnp.asarray(t)))[()]
        return t
    if isinstance(A, HyperMatrix):
        from ..sparse.hyper import hyper_reduce_scalar
        A = A.wait()
        t = hyper_reduce_scalar(mon, A) if A.nvals else mon.identity
        if accum is not None and c is not None:
            t = jax.device_get(accum(jnp.asarray(c), jnp.asarray(t)))[()]
        return t
    A = A.wait()
    vals = A.values if mon.type.is_udt else cast(A.values, mon.type)
    t = mon.reduce(vals, axis=None, where=A.pattern)
    t = jax.device_get(t)
    if accum is not None and c is not None:
        t = jax.device_get(accum(jnp.asarray(c), jnp.asarray(t)))
    if hasattr(t, "item"):
        t = t[()] if getattr(t, "ndim", 0) == 0 else t
    return t


def reduce(*args, **kw):
    """Polymorphic GrB_reduce: dispatches on output like the _Generic macro."""
    if isinstance(args[0], Vector):
        return reduce_to_vector(*args, **kw)
    return reduce_to_scalar(*args, **kw)
