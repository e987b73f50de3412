"""Padded-CSR/COO sparse containers for large graphs.

The reference's four storage formats (CSR/CSC/hyper x2,
``Source/Template/GB_matrix.h:41-132``) collapse into one accelerator-friendly
container: CSR arrays **plus** the COO row-ids dual (``rowids``), padded
to a static capacity ``nzmax`` so every kernel sees fixed shapes (XLA's
static-shape requirement; SURVEY.md §7 "hard parts" #1).  Padding
convention: ``indices[k >= nvals] == ncols`` (an out-of-range sentinel)
and ``rowids[k >= nvals] == nrows`` — gathers read a dedicated identity
slot appended to the operand, so padded lanes contribute the monoid
identity with zero branching.

Hypersparsity needs no special format here: empty rows cost 4 bytes of
indptr, and the bitpacked pattern (:mod:`graphblas_tpu.sparse.bitpack`)
covers the dense-ish case the reference's bitmap would.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.matrix import Matrix
from ..core.types import Type, BOOL, FP64, type_of_dtype

__all__ = ["CsrMatrix", "CscMatrix", "csr_from_coo"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
class CsrMatrix:
    """Immutable padded-CSR pytree: indptr[m+1], indices[nzmax],
    rowids[nzmax] (the COO dual), values[nzmax]."""

    __slots__ = ("indptr", "indices", "rowids", "values", "nvals",
                 "nrows", "ncols", "type", "_options", "_pending")

    def __init__(self, indptr, indices, rowids, values, nvals: int,
                 nrows: int, ncols: int, type: Type, pending=None):
        self.indptr = indptr
        self.indices = indices
        self.rowids = rowids
        self.values = values
        self.nvals = int(nvals)
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.type = type
        # per-object options (GxB_Matrix_Option_set scope); metadata
        self._options = {}
        # non-blocking delta buffer: list of (i, j, scalar, accum)
        # (reference GB_pending_add / GB_matrix.h:249-315)
        self._pending = list(pending) if pending else []

    def tree_flatten(self):
        return ((self.indptr, self.indices, self.rowids, self.values),
                (self.nvals, self.nrows, self.ncols, self.type,
                 tuple(self._pending)))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def _shallow(self) -> "CsrMatrix":
        out = CsrMatrix(self.indptr, self.indices, self.rowids,
                        self.values, self.nvals, self.nrows, self.ncols,
                        self.type, pending=self._pending)
        out._options = dict(self._options)
        return out

    # -- pending tuples / element mutation (GB_setElement + GB_wait) ----------
    def wait(self) -> "CsrMatrix":
        """Fold the pending delta buffer (reference ``GB_wait``)."""
        if not self._pending:
            return self
        from .pending import fold_pending_csr
        return fold_pending_csr(self)

    def setElement(self, value, i: int, j: int, *,
                   accum=None, blocking=None) -> "CsrMatrix":
        """Functional setElement -> pending tuple (``GB_setElement.c``)."""
        from .pending import append_pending
        return append_pending(self, i, j, value, accum, blocking)

    def extractElement(self, i: int, j: int):
        """Binary search within row i; returns None for GrB_NO_VALUE
        (``GB_extractElement.c``).  Pulls only indptr scalars + the one
        row slice to the host."""
        from .pending import check_index
        check_index(self, i, j)
        A = self.wait()
        s, e = int(A.indptr[i]), int(A.indptr[i + 1])
        if s == e:
            return None
        row = np.asarray(A.indices[s:e])
        pos = int(np.searchsorted(row, j))
        if pos >= len(row) or row[pos] != j:
            return None
        if A.type.is_udt:
            return jax.tree_util.tree_map(
                lambda v: np.asarray(v[s + pos])[()], A.values)
        return np.asarray(A.values[s + pos])[()]

    def removeElement(self, i: int, j: int) -> "CsrMatrix":
        """Delete one entry — the functional form of a zombie +
        immediate ``GB_wait`` (``GB_FLIP``, GB.h:2513-2543)."""
        from .pending import check_index
        from .tri import csr_filter_lanes
        check_index(self, i, j)
        A = self.wait()
        keep = ~((A.rowids == i) & (A.indices == j))
        return csr_filter_lanes(A, keep)

    def resize(self, nrows_new: int, ncols_new: int) -> "CsrMatrix":
        """GxB_Matrix_resize: prune outside entries, remap on device."""
        from .pending import csr_resize
        return csr_resize(self, nrows_new, ncols_new)

    def clear(self) -> "CsrMatrix":
        from .mask import csr_clear
        return csr_clear(self)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nzmax(self) -> int:
        return int(self.indices.shape[0])

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, nzmax: Optional[int] = None,
                 sum_duplicates: bool = True) -> "CsrMatrix":
        return csr_from_coo(I, J, X, nrows, ncols, type=type, nzmax=nzmax,
                            sum_duplicates=sum_duplicates)

    @staticmethod
    def from_matrix(A: Matrix, nzmax: Optional[int] = None) -> "CsrMatrix":
        """Bitmap Matrix -> padded CSR (host-side O(nnz) conversion).
        UDT values travel as a struct-of-arrays pytree (the reference
        carries any type through every kernel via ``void*`` values,
        ``GB_matrix.h:195-208``)."""
        I, J, X = A.extractTuples()
        return csr_from_coo(I, J, X, A.nrows, A.ncols, type=A.type,
                            nzmax=nzmax, sum_duplicates=False)

    # -- conversions ---------------------------------------------------------
    def to_matrix(self) -> Matrix:
        self = self.wait()
        pat = np.zeros((self.nrows, self.ncols), dtype=np.bool_)
        I = np.asarray(self.rowids)[:self.nvals]
        J = np.asarray(self.indices)[:self.nvals]
        pat[I, J] = True
        if self.type.is_udt:
            def scat(v):
                a = np.asarray(v)
                d = np.zeros((self.nrows, self.ncols), a.dtype)
                d[I, J] = a[:self.nvals]
                return jnp.asarray(d)
            vals = jax.tree_util.tree_map(scat, self.values)
            return Matrix(vals, jnp.asarray(pat), self.type)
        vals = np.zeros((self.nrows, self.ncols), dtype=self.type.dtype)
        X = np.asarray(self.values)[:self.nvals]
        vals[I, J] = X
        return Matrix(jnp.asarray(vals), jnp.asarray(pat), self.type)

    def extractTuples(self):
        self = self.wait()  # reference extractTuples assembles first
        if self.type.is_udt:
            X = jax.tree_util.tree_map(
                lambda v: np.asarray(v)[:self.nvals], self.values)
        else:
            X = np.asarray(self.values)[:self.nvals]
        return (np.asarray(self.rowids)[:self.nvals].astype(np.int64),
                np.asarray(self.indices)[:self.nvals].astype(np.int64),
                X)

    def T(self) -> "CsrMatrix":
        """Transpose = re-sorted COO (host-side; the reference's bucket
        transpose ``GB_transpose_bucket.c`` is a counting sort too)."""
        I, J, X = self.extractTuples()
        return csr_from_coo(J, I, X, self.ncols, self.nrows,
                            type=self.type, nzmax=self.nzmax,
                            sum_duplicates=False)

    def row_degrees(self) -> jnp.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def __repr__(self):  # pragma: no cover
        return (f"CsrMatrix<{self.type.name}> {self.nrows}x{self.ncols}, "
                f"{self.nvals}/{self.nzmax} entries")


def csr_from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, nzmax: Optional[int] = None,
                 sum_duplicates: bool = True) -> CsrMatrix:
    """Host-side CSR build: lexsort (i,j), optional dup-sum, pad to
    capacity.  (The native C++ radix builder is used when available.)"""
    from ..utils import faultinject
    faultinject.checkpoint("csr_from_coo")
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    if type is not None and type.is_udt:
        return _csr_from_coo_udt(I, J, X, nrows, ncols, type, nzmax,
                                 sum_duplicates)
    X = np.asarray(X)
    t = type or type_of_dtype(X.dtype)
    if I.size:
        # same bounds validation as Matrix.from_coo: a negative or
        # out-of-range index would silently corrupt the CSR (and the
        # native radix sort assumes non-negative keys)
        from ..core.errors import IndexOutOfBounds
        imin, imax = I.min(), I.max()
        jmin, jmax = J.min(), J.max()
        if imin < 0 or imax >= nrows or jmin < 0 or jmax >= ncols:
            raise IndexOutOfBounds(
                f"tuple index out of range for {nrows}x{ncols}: "
                f"rows [{imin},{imax}], cols [{jmin},{jmax}]")
    # input already in strictly increasing (i, j) order (generators and
    # loaders emit it so) needs neither the sort nor the dup pass
    presorted = I.size < 2 or bool(np.all(
        (I[1:] > I[:-1]) | ((I[1:] == I[:-1]) & (J[1:] > J[:-1]))))
    if I.size and not presorted:
        from ..io.native import sort_dedup_native, sort_pairs_native
        if sum_duplicates:
            nat = None
            if X.dtype == np.float64:
                nat = sort_dedup_native(I, J, X, "PLUS")
            if nat is not None:
                I, J, X = nat
            else:
                sp = sort_pairs_native(I, J, nrows, ncols)
                if sp is not None:
                    I, J, perm = sp
                    X = X[perm]
                else:
                    order = np.lexsort((J, I))
                    I, J, X = I[order], J[order], X[order]
                lin = I * ncols + J
                first = np.ones(len(lin), bool)
                first[1:] = lin[1:] != lin[:-1]
                starts = np.nonzero(first)[0]
                X = np.add.reduceat(X, starts) if len(starts) < len(X) else X
                I, J = I[starts], J[starts]
        else:
            sp = sort_pairs_native(I, J, nrows, ncols)
            if sp is not None:
                I, J, perm = sp
                X = X[perm]
            else:
                order = np.lexsort((J, I))
                I, J, X = I[order], J[order], X[order]
    nvals = len(I)
    cap = nzmax or _round_up(max(nvals, 8), 128)
    if cap < nvals:
        raise ValueError(f"nzmax {cap} < nvals {nvals}")
    indptr = np.zeros(nrows + 1, np.int32)
    indptr[1:] = np.cumsum(np.bincount(I, minlength=nrows))
    indices = np.full(cap, ncols, np.int32)
    rowids = np.full(cap, nrows, np.int32)
    values = np.zeros(cap, t.dtype)
    indices[:nvals] = J
    rowids[:nvals] = I
    values[:nvals] = X.astype(t.dtype, copy=False)
    A = CsrMatrix(jnp.asarray(indptr), jnp.asarray(indices),
                  jnp.asarray(rowids), jnp.asarray(values),
                  nvals, nrows, ncols, t)
    # stash the host-side pattern (it exists right here anyway): kernel
    # plans (spmv_plan, window and bitdot plans) read it instead of
    # pulling the device arrays back
    A._options["host_pattern"] = (rowids, indices)
    return A


def _csr_from_coo_udt(I, J, X, nrows: int, ncols: int, t: Type,
                      nzmax: Optional[int], sum_duplicates: bool
                      ) -> CsrMatrix:
    """UDT build: values are a struct-of-arrays pytree; every leaf is
    sorted/padded in lockstep with the (i, j) keys.  Duplicate assembly
    needs a dup operator the flat path defaults to PLUS — for structs
    the caller must pre-combine (the reference requires an explicit dup
    op for UDTs too, ``GB_build.c``)."""
    from ..core.errors import IndexOutOfBounds
    tmap = jax.tree_util.tree_map
    if I.size:
        imin, imax = I.min(), I.max()
        jmin, jmax = J.min(), J.max()
        if imin < 0 or imax >= nrows or jmin < 0 or jmax >= ncols:
            raise IndexOutOfBounds(
                f"tuple index out of range for {nrows}x{ncols}: "
                f"rows [{imin},{imax}], cols [{jmin},{jmax}]")
    X = tmap(np.asarray, X)
    if I.size:
        order = np.lexsort((J, I))
        I, J = I[order], J[order]
        X = tmap(lambda a: a[order], X)
        lin = I * ncols + J
        if sum_duplicates and I.size > 1 and np.any(lin[1:] == lin[:-1]):
            raise TypeError("UDT tuples must be duplicate-free "
                            "(no default dup operator for structs)")
    nvals = len(I)
    cap = nzmax or _round_up(max(nvals, 8), 128)
    if cap < nvals:
        raise ValueError(f"nzmax {cap} < nvals {nvals}")
    indptr = np.zeros(nrows + 1, np.int32)
    indptr[1:] = np.cumsum(np.bincount(I, minlength=nrows))
    indices = np.full(cap, ncols, np.int32)
    rowids = np.full(cap, nrows, np.int32)
    indices[:nvals] = J
    rowids[:nvals] = I

    def padleaf(a):
        out = np.zeros(cap, a.dtype)
        out[:nvals] = a
        return jnp.asarray(out)

    values = tmap(padleaf, X)
    return CsrMatrix(jnp.asarray(indptr), jnp.asarray(indices),
                     jnp.asarray(rowids), values,
                     nvals, nrows, ncols, t)


@jax.tree_util.register_pytree_node_class
class CscMatrix:
    """By-column twin of :class:`CsrMatrix` — the reference's
    ``GxB_BY_COL`` format (``GB_matrix.h:394`` ``is_csc``).  Stores the
    transpose's padded-CSR arrays, so column access is O(1), transpose
    is free (``.T()`` returns the underlying CsrMatrix), CSC
    import/export is zero-copy, and ``vxm`` (x'A) is the native fast
    op — mirroring the reference, where the CSC orientation makes the
    column-oriented kernels the cheap ones.  Row-oriented ops convert
    via :meth:`to_csr` (one O(nnz log nnz) resort), exactly the
    explicit-transpose cost the reference pays in ``GB_AxB_meta`` when
    formats disagree."""

    __slots__ = ("tr", "_options")

    def __init__(self, tr: CsrMatrix):
        self.tr = tr
        self._options = {"format": "by_col"}

    def tree_flatten(self):
        return ((self.tr,), ())

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    # -- metadata mirrors ----------------------------------------------------
    @property
    def nrows(self) -> int:
        return self.tr.ncols

    @property
    def ncols(self) -> int:
        return self.tr.nrows

    @property
    def shape(self):
        return (self.tr.ncols, self.tr.nrows)

    @property
    def nvals(self) -> int:
        return self.tr.nvals

    @property
    def nzmax(self) -> int:
        return self.tr.nzmax

    @property
    def type(self) -> Type:
        return self.tr.type

    #: CSC component views (reference export names): colptr / rowidx
    @property
    def colptr(self):
        return self.tr.indptr

    @property
    def rowidx(self):
        return self.tr.indices

    @property
    def values(self):
        return self.tr.values

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, nzmax: Optional[int] = None,
                 sum_duplicates: bool = True) -> "CscMatrix":
        return CscMatrix(csr_from_coo(J, I, X, ncols, nrows, type=type,
                                      nzmax=nzmax,
                                      sum_duplicates=sum_duplicates))

    @staticmethod
    def from_csr(A: CsrMatrix) -> "CscMatrix":
        """CSR -> CSC (one transpose resort)."""
        return CscMatrix(A.T())

    # -- conversions ---------------------------------------------------------
    def to_csr(self) -> CsrMatrix:
        return self.tr.T()

    def T(self) -> CsrMatrix:
        """Transpose — free: A' in CSR is exactly the stored arrays."""
        return self.tr

    def to_matrix(self) -> Matrix:
        M = self.tr.to_matrix()
        import jax as _jax
        vals = _jax.tree_util.tree_map(lambda a: a.T, M.values) \
            if self.type.is_udt else M.values.T
        return Matrix(vals, M.pattern.T, self.type)

    def extractTuples(self):
        """(I, J, X) in column order (the reference's CSC storage
        order)."""
        J, I, X = self.tr.extractTuples()
        return I, J, X

    def col_degrees(self):
        return self.tr.row_degrees()

    # -- pending tuples / element mutation (delegated to the stored
    #    transpose with swapped coordinates) ---------------------------------
    def wait(self) -> "CscMatrix":
        t = self.tr.wait()
        return self if t is self.tr else CscMatrix(t)

    def setElement(self, value, i: int, j: int, *,
                   accum=None, blocking=None) -> "CscMatrix":
        return CscMatrix(self.tr.setElement(value, j, i, accum=accum,
                                            blocking=blocking))

    def extractElement(self, i: int, j: int):
        return self.tr.extractElement(j, i)

    def removeElement(self, i: int, j: int) -> "CscMatrix":
        return CscMatrix(self.tr.removeElement(j, i))

    def resize(self, nrows_new: int, ncols_new: int) -> "CscMatrix":
        return CscMatrix(self.tr.resize(ncols_new, nrows_new))

    def clear(self) -> "CscMatrix":
        return CscMatrix(self.tr.clear())

    def __repr__(self):  # pragma: no cover
        return (f"CscMatrix<{self.type.name}> {self.nrows}x{self.ncols}, "
                f"{self.nvals}/{self.nzmax} entries (by_col)")
