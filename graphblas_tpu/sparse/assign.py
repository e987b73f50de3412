"""Sparse assign / subassign / extract on the CSR container.

Reference: ``Source/GB_assign.c`` (GrB semantics — the mask covers all
of C), ``Source/GB_subassign_kernel.c`` (GxB — the mask covers only
C(I,J)), and ``Template/GB_subref_template.c`` (extraction); executable
specs ``Test/GB_spec_assign.m`` / ``GB_spec_subassign.m``.

The reference's 48-case subassign kernel is a scatter machine with
zombies and pending tuples.  The form here is three coordinate
transforms plus the one sparse epilogue that already exists
(:func:`graphblas_tpu.sparse.mask.csr_accum_mask`):

  * **subref** — remap A's entries through the inverse index maps
    (``GB_I_inverse.c`` analogue) and compact: C = A(I,J).
  * **to-global** — push a region-shaped operand's entries through the
    forward maps ``I``/``J`` into C's frame.
  * **region split** — partition C's lanes into inside/outside the
    I x J region, so region-scoped REPLACE (GxB) and C-scoped REPLACE
    (GrB) each touch exactly the entries the spec says.

GxB_subassign:  C = (C_out) ∪ epilogue(C_in, M→global, A→global)
GrB_assign:     Z = (C_out) ∪ accum(C_in, A→global);  C = mask(C, M, Z)

Everything is device-side sort/gather/segment work on padded buffers;
the only host work is building the O(dim) index maps.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch, InvalidValue
from ..core.ops import BinaryOp
from ..core.types import Type, cast_value
from ..utils.indices import normalize_indices
from .container import CsrMatrix
from .esc import _bucket, _empty_csr
from .mask import csr_accum_mask
from .tri import csr_filter_lanes

__all__ = ["csr_subref", "csr_extract", "csr_assign", "csr_subassign",
           "csr_assign_scalar", "csr_subassign_scalar"]

_tmap = jax.tree_util.tree_map


def _key_dtype(m: int, n: int):
    if (m + 1) * (n + 1) < (1 << 31):
        return jnp.int32
    if (m + 1) * (n + 1) < (1 << 63):
        return jnp.int64
    raise NotImplementedError("dimension product exceeds 2^63")


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _map_compact_jit(nzmax: int, m_out: int, n_out: int, kdt,
                     rowids, indices, values, row_map, col_map, live):
    """Remap lanes through row/col maps (-1 = drop), sort by the new
    coordinate, compact to CSR form."""
    big = jnp.asarray(np.iinfo(np.dtype(kdt)).max, kdt)
    rr = row_map[jnp.minimum(rowids.astype(jnp.int64),
                             row_map.shape[0] - 1)]
    cc = col_map[jnp.minimum(indices.astype(jnp.int64),
                             col_map.shape[0] - 1)]
    keep = live & (rr >= 0) & (cc >= 0)
    key = jnp.where(keep, rr.astype(kdt) * n_out + cc.astype(kdt), big)
    perm = jnp.argsort(key)  # stable; dropped lanes fall to the tail
    ks = key[perm]
    vs = _tmap(lambda v: v[perm], values)
    nnz = jnp.sum(keep).astype(jnp.int32)
    is_live = ks < big
    oi = jnp.where(is_live, ks // n_out, m_out).astype(jnp.int32)
    oj = jnp.where(is_live, ks % n_out, n_out).astype(jnp.int32)
    counts = jax.ops.segment_sum(is_live.astype(jnp.int32), oi,
                                 num_segments=m_out + 1)
    indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts[:m_out]).astype(jnp.int32)])
    return indptr, oj, oi, vs, nnz


def _map_compact(A: CsrMatrix, row_map, col_map, m_out: int,
                 n_out: int) -> CsrMatrix:
    if m_out == 0 or n_out == 0 or A.nvals == 0:
        return _empty_csr(m_out, n_out, A.type)
    kdt = _key_dtype(m_out, n_out)
    live = jnp.arange(A.nzmax) < A.nvals
    indptr, oj, oi, ov, nnz = _map_compact_jit(
        A.nzmax, m_out, n_out, kdt, A.rowids, A.indices, A.values,
        jnp.asarray(row_map, jnp.int64), jnp.asarray(col_map, jnp.int64),
        live)
    n = int(nnz)
    cap = min(_bucket(max(n, 8)), A.nzmax)
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     _tmap(lambda v: v[:cap], ov), n, m_out, n_out, A.type)


def _inverse_map(idx: np.ndarray, n: int, what: str) -> np.ndarray:
    """inv[g] = position of g in idx, or -1 (``GB_I_inverse.c``); the
    one-extra slot keeps padded-lane gathers in range."""
    if len(np.unique(idx)) != len(idx):
        raise InvalidValue(
            f"duplicate {what} indices are not supported on the sparse "
            f"container (undefined for assign per the GraphBLAS spec; "
            f"use the bitmap backend for duplicate extract indices)")
    inv = np.full(n + 1, -1, np.int64)
    inv[idx] = np.arange(len(idx))
    return inv


def _forward_map(idx: np.ndarray) -> np.ndarray:
    """fwd[local] = global index; sentinel slot -1 for padded lanes."""
    return np.concatenate([idx.astype(np.int64), [-1]])


def _region_lanes(C: CsrMatrix, inv_r, inv_c) -> jnp.ndarray:
    """Boolean per-lane membership of C's entries in the I x J region."""
    live = jnp.arange(C.nzmax) < C.nvals
    rr = jnp.asarray(inv_r)[jnp.minimum(C.rowids.astype(jnp.int64),
                                        C.nrows)]
    cc = jnp.asarray(inv_c)[jnp.minimum(C.indices.astype(jnp.int64),
                                        C.ncols)]
    return live & (rr >= 0) & (cc >= 0)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _union_jit(E: int, m: int, n: int, kdt, keys, values):
    big = jnp.asarray(np.iinfo(np.dtype(kdt)).max, kdt)
    perm = jnp.argsort(keys)
    ks = keys[perm]
    vs = _tmap(lambda v: v[perm], values)
    is_live = ks < big
    nnz = jnp.sum(is_live).astype(jnp.int32)
    oi = jnp.where(is_live, ks // n, m).astype(jnp.int32)
    oj = jnp.where(is_live, ks % n, n).astype(jnp.int32)
    counts = jax.ops.segment_sum(is_live.astype(jnp.int32), oi,
                                 num_segments=m + 1)
    indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts[:m]).astype(jnp.int32)])
    return indptr, oj, oi, vs, nnz


def _union_disjoint(X: CsrMatrix, Y: CsrMatrix) -> CsrMatrix:
    """Merge two CsrMatrix with disjoint patterns (one sort, no fold)."""
    m, n = X.shape
    if m == 0 or n == 0:
        return _empty_csr(m, n, X.type)
    if X.nvals == 0:
        return Y
    if Y.nvals == 0:
        return X
    kdt = _key_dtype(m, n)
    big = np.iinfo(np.dtype(kdt)).max

    def keys_of(Z):
        live = jnp.arange(Z.nzmax) < Z.nvals
        k = Z.rowids.astype(kdt) * n + Z.indices.astype(kdt)
        return jnp.where(live, k, jnp.asarray(big, kdt))

    keys = jnp.concatenate([keys_of(X), keys_of(Y)])
    vals = _tmap(lambda a, b: jnp.concatenate([a, b]), X.values, Y.values)
    E = X.nzmax + Y.nzmax
    indptr, oj, oi, ov, nnz = _union_jit(E, m, n, kdt, keys, vals)
    nv = int(nnz)
    cap = min(_bucket(max(nv, 8)), E)
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     _tmap(lambda v: v[:cap], ov), nv, m, n, X.type)


def _scalar_region(scalar, ni: int, nj: int, t: Type) -> CsrMatrix:
    """Scalar expansion: the all-present ni x nj region as CSR
    (``GB_subassign_scalar.c``'s implicit A)."""
    v = cast_value(scalar, t)
    nnz = ni * nj
    cap = _bucket(max(nnz, 8))
    lane = jnp.arange(cap)
    live = lane < nnz
    rows = jnp.where(live, lane // max(nj, 1), ni).astype(jnp.int32)
    cols = jnp.where(live, lane % max(nj, 1), nj).astype(jnp.int32)
    if t.is_udt:
        vals = {k: jnp.full((cap,), v[k]) for k, _ in t.fields}
    else:
        vals = jnp.full((cap,), v, dtype=t.dtype)
    indptr = (jnp.arange(ni + 1, dtype=jnp.int32) * nj)
    return CsrMatrix(indptr, cols, rows, vals, nnz, ni, nj, t)


def csr_subref(A: CsrMatrix, I: Any = None, J: Any = None) -> CsrMatrix:
    """C = A(I,J): the symbolic+numeric subref in one remap-compact."""
    Ii = normalize_indices(I, A.nrows)
    Jj = normalize_indices(J, A.ncols)
    inv_r = _inverse_map(Ii, A.nrows, "row")
    inv_c = _inverse_map(Jj, A.ncols, "column")
    return _map_compact(A, inv_r, inv_c, len(Ii), len(Jj))


def _to_global(A: CsrMatrix, Ii: np.ndarray, Jj: np.ndarray,
               m: int, n: int) -> CsrMatrix:
    """Push the region-shaped A into C's m x n frame via I/J."""
    return _map_compact(A, _forward_map(Ii), _forward_map(Jj), m, n)


def _prep_operand(A, Ii, Jj, ctype: Type, tran: bool, scalar: bool):
    if scalar:
        return _scalar_region(A, len(Ii), len(Jj), ctype)
    if not isinstance(A, CsrMatrix):
        from ..ops.containers import to_csr_operand
        A = to_csr_operand(A, False, "assign input")
    else:
        A = A.wait()
    if tran:
        A = A.T()
    if A.shape != (len(Ii), len(Jj)):
        raise DimensionMismatch(
            f"A is {A.shape}, I x J is {(len(Ii), len(Jj))}")
    return A


def _prep_mask(M, shape):
    if M is None:
        return None
    if not isinstance(M, CsrMatrix):
        from ..ops.containers import to_csr_operand
        M = to_csr_operand(M, False, "mask")
    else:
        M = M.wait()
    if M.shape != shape:
        raise DimensionMismatch(f"mask is {M.shape}, expected {shape}")
    return M


def csr_subassign(C: CsrMatrix, M, accum: Optional[BinaryOp], A,
                  I: Any = None, J: Any = None,
                  desc: Optional[Descriptor] = None, *,
                  scalar: bool = False) -> CsrMatrix:
    """C(I,J)<M> = accum(C(I,J), A) — GxB_subassign on CSR.  M is
    |I| x |J|; REPLACE and the mask never touch entries outside the
    region (``GB_spec_subassign.m``)."""
    d = desc_of(desc)
    C = C.wait()
    Ii = normalize_indices(I, C.nrows, unique=scalar)
    Jj = normalize_indices(J, C.ncols, unique=scalar)
    A = _prep_operand(A, Ii, Jj, C.type, d.tran0, scalar)
    M = _prep_mask(M, (len(Ii), len(Jj)))
    inv_r = _inverse_map(Ii, C.nrows, "row")
    inv_c = _inverse_map(Jj, C.ncols, "column")
    in_region = _region_lanes(C, inv_r, inv_c)
    C_in = csr_filter_lanes(C, in_region)
    C_out = csr_filter_lanes(C, ~in_region)
    T = _to_global(A, Ii, Jj, C.nrows, C.ncols)
    Mg = (_to_global(M, Ii, Jj, C.nrows, C.ncols)
          if M is not None else None)
    Z_in = csr_accum_mask(C_in, Mg, T, accum, d)
    return _union_disjoint(Z_in, C_out)


def csr_assign(C: CsrMatrix, M, accum: Optional[BinaryOp], A,
               I: Any = None, J: Any = None,
               desc: Optional[Descriptor] = None, *,
               scalar: bool = False) -> CsrMatrix:
    """C<M>(I,J) = accum(C(I,J), A) — GrB_assign on CSR.  M is C-sized;
    REPLACE acts over all of C (``GB_spec_assign.m``: Z = C;
    Z(I,J) = accum(C(I,J),A); C<M,replace> = Z)."""
    d = desc_of(desc)
    C = C.wait()
    Ii = normalize_indices(I, C.nrows, unique=scalar)
    Jj = normalize_indices(J, C.ncols, unique=scalar)
    A = _prep_operand(A, Ii, Jj, C.type, d.tran0, scalar)
    M = _prep_mask(M, C.shape)
    inv_r = _inverse_map(Ii, C.nrows, "row")
    inv_c = _inverse_map(Jj, C.ncols, "column")
    in_region = _region_lanes(C, inv_r, inv_c)
    C_in = csr_filter_lanes(C, in_region)
    C_out = csr_filter_lanes(C, ~in_region)
    T = _to_global(A, Ii, Jj, C.nrows, C.ncols)
    # Z(I,J) = accum(C(I,J), A): region-local, no mask, no replace
    Z_in = csr_accum_mask(C_in, None, T, accum, None)
    Z = _union_disjoint(Z_in, C_out)
    # C<M,d> = Z over ALL of C
    return csr_accum_mask(C, M, Z, None, d)


def csr_assign_scalar(C, M, accum, x, I=None, J=None, desc=None):
    return csr_assign(C, M, accum, x, I, J, desc, scalar=True)


def csr_subassign_scalar(C, M, accum, x, I=None, J=None, desc=None):
    return csr_subassign(C, M, accum, x, I, J, desc, scalar=True)


def csr_extract(C: CsrMatrix, M, accum: Optional[BinaryOp], A,
                I: Any = None, J: Any = None,
                desc: Optional[Descriptor] = None) -> CsrMatrix:
    """C<M> = accum(C, A(I,J)) — GrB_Matrix_extract on CSR."""
    d = desc_of(desc)
    from ..ops.containers import to_csr_operand
    A = to_csr_operand(A, d.tran0, "extract input")
    T = csr_subref(A, I, J)
    if T.shape != C.shape:
        raise DimensionMismatch(
            f"C is {C.shape}, A(I,J) is {T.shape}")
    M = _prep_mask(M, C.shape)
    # epilogue descriptor: strip the (already-applied) transpose
    return csr_accum_mask(C, M, T, accum, d)
