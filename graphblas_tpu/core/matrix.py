"""Sparse matrix / vector containers on JAX arrays.

The reference stores one opaque mutable struct with four formats (CSR, CSC,
hypersparse x2) plus pending-tuple and zombie machinery
(``Source/Template/GB_matrix.h``).  The design here is different by
construction:

* A :class:`Matrix` is an **immutable pytree**: a dense value array plus a
  boolean structure ``pattern`` (the "bitmap" of present entries).  This is
  simultaneously (a) the representation the reference's own executable spec
  uses (``Test/GB_spec_*.m`` carry ``matrix`` + ``pattern`` + ``class``),
  (b) a static-shape object XLA can jit without recompilation, and (c) the
  layout a dense matmul wants for masked mxm.
* Large graphs use the padded-CSR container in ``graphblas_tpu.sparse``;
  conversions between the two are O(nnz) gather/scatters.
* Pending tuples / zombies / the matrix queue (``GB_pending_add.c``,
  ``GB_wait.c``, ``GB_queue_*.c``) exist for *mutation batching*; in a
  functional API they become an explicit host-side delta list that
  :meth:`Matrix.wait` folds in.  ``setElement`` appends to the delta,
  exactly mirroring non-blocking mode.

Canonical invariant: ``values`` holds the type's zero at absent positions,
so plus-times matmuls run straight on the matrix units with no masking
pass.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import types as gbtypes
from ..utils import faultinject
from .errors import DimensionMismatch, EmptyObject, IndexOutOfBounds
from .ops import BinaryOp, binary
from .types import Type, BOOL, FP64, cast, cast_value, type_of_dtype

__all__ = ["Matrix", "Vector"]


def _tree_zeros(t: Type, shape):
    return gbtypes.zeros_like_typed(shape, t)


# sorted-run duplicate assembly: the named built-in dup operators fold
# whole runs with one numpy reduceat; anything else falls back to a
# sequential in-order fold (exact left-to-right semantics either way,
# matching GB_build_factory's "first occurrence seeds, later dups fold").
_REDUCEAT_OPS = {
    "PLUS": np.add, "TIMES": np.multiply, "MIN": np.minimum,
    "MAX": np.maximum, "LOR": np.logical_or, "LAND": np.logical_and,
    "LXOR": np.logical_xor,
}


def _check_pattern_shape(pat_shape, val_shape):
    if tuple(pat_shape) != tuple(val_shape):
        raise DimensionMismatch(
            f"pattern shape {tuple(pat_shape)} != values shape "
            f"{tuple(val_shape)}")


def _cast_array_np(X: np.ndarray, t: Type) -> np.ndarray:
    """Vectorized host-side cast matching cast_value's semantics (a
    Python-level per-element loop is minutes on 10M-edge builds)."""
    if t.is_bool:
        return X != 0
    if t.is_integer and np.issubdtype(X.dtype, np.floating):
        info = np.iinfo(t.dtype)
        x = np.where(np.isnan(X), 0.0, X)
        tr = np.trunc(x)
        hi, lo = float(info.max), float(info.min)
        out = np.where((tr < hi) & (tr > lo), tr, 0).astype(t.dtype)
        out = np.where(tr >= hi, np.asarray(info.max, t.dtype), out)
        out = np.where(tr <= lo, np.asarray(info.min, t.dtype), out)
        return out
    return X.astype(t.dtype)


def _fold_duplicates(dup: BinaryOp, Xs: np.ndarray, starts: np.ndarray,
                     t: Type) -> np.ndarray:
    """Fold each sorted run Xs[starts[k]:starts[k+1]] with the dup op."""
    if len(starts) == len(Xs):
        return Xs  # no duplicates
    name = getattr(dup, "name", None)
    if name == "FIRST":
        return Xs[starts]
    if name == "SECOND":
        ends = np.append(starts[1:], len(Xs)) - 1
        return Xs[ends]
    ufunc = _REDUCEAT_OPS.get(name)
    if ufunc is not None and not t.is_udt:
        out = ufunc.reduceat(Xs, starts)
        return out.astype(t.dtype, copy=False)
    # generic fallback: jax fold per run boundary, batched by position
    # within the run (still O(max run length) dispatches, not O(ndups))
    ends = np.append(starts[1:], len(Xs))
    out = Xs[starts].copy()
    maxrun = int((ends - starts).max())
    for k in range(1, maxrun):
        sel = starts + k < ends
        idx = starts[sel] + k
        res = jax.device_get(dup(jnp.asarray(out[sel]), jnp.asarray(Xs[idx])))
        out[sel] = np.asarray(res, dtype=out.dtype)
    return out


def _tree_where(mask, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(mask, x, y), a, b)


def np_bool(x) -> np.ndarray:
    """Device bool -> host bool via a uint8 staging cast.

    One cheap on-device cast keeps every host transfer of a pattern in
    one dtype, whatever the runtime does with bool buffers.
    """
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(jnp.asarray(x, jnp.uint8)).astype(np.bool_)


class _Base:
    """Shared functional container: values + pattern + type."""

    __slots__ = ("values", "pattern", "type", "_pending", "_options")

    def __init__(self, values, pattern, type: Type,
                 pending: Optional[List[Tuple]] = None,
                 options: Optional[dict] = None):
        self.values = values
        self.pattern = pattern
        self.type = type
        # non-blocking-mode delta buffer: list of (i, j, scalar, accum_op)
        self._pending = list(pending) if pending else []
        # per-object options (reference GxB_Matrix_Option_set: format /
        # hyper ratio live on the matrix, GB_matrix.h:394-399).  Purely
        # metadata here (storage is bitmap): consulted by printing and
        # CSR conversion hints, reported by GxB_get.
        self._options = dict(options) if options else {}

    # -- pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        return (self.values, self.pattern), (
            self.type, tuple(self._pending),
            tuple(sorted(self._options.items())))

    @classmethod
    def tree_unflatten(cls, aux, children):
        values, pattern = children
        obj = cls.__new__(cls)
        _Base.__init__(obj, values, pattern, aux[0], list(aux[1]),
                       dict(aux[2]) if len(aux) > 2 else None)
        return obj

    # -- shape / introspection -------------------------------------------------
    @property
    def shape(self):
        leaf = jax.tree_util.tree_leaves(self.values)[0]
        return leaf.shape

    def nvals(self) -> int:
        """# of entries (reference ``GrB_Matrix_nvals``; waits first)."""
        m = self.wait()
        return int(jnp.sum(m.pattern))

    @property
    def dtype(self):
        return self.type.dtype

    def _replace(self, values=None, pattern=None, type=None, pending=None):
        # the universal new-container site (every op output lands here):
        # the faultable "allocation" of the functional design
        faultinject.checkpoint("Matrix._replace")
        cls = self.__class__
        obj = cls.__new__(cls)
        _Base.__init__(
            obj,
            self.values if values is None else values,
            self.pattern if pattern is None else pattern,
            self.type if type is None else type,
            self._pending if pending is None else pending,
            self._options,
        )
        return obj

    # -- canonicalization -------------------------------------------------------
    def canonical(self):
        """Zero out values at absent positions (the storage invariant)."""
        z = _tree_zeros(self.type, self.shape)
        return self._replace(values=_tree_where(self.pattern, self.values, z))

    # -- pending tuples (non-blocking mode) --------------------------------------
    def wait(self):
        """Assemble pending tuples (reference ``GB_wait`` / ``GrB_wait``).

        Consecutive tuples sharing an accum op are folded host-side
        (duplicates combined in input order, assuming the accum is
        associative like GB_builder's dup assembly) and land in ONE
        batched gather/scatter — not one dispatch per tuple.
        """
        if not self._pending:
            return self
        faultinject.checkpoint("Matrix.wait")
        vals, pat = self.values, self.pattern
        tmap = jax.tree_util.tree_map
        udt = self.type.is_udt
        is_vec = pat.ndim == 1

        # group consecutive same-accum runs
        runs: List[Tuple] = []
        for (idx, scalar, accum) in self._pending:
            if accum is not None and not isinstance(accum, BinaryOp):
                raise TypeError(
                    f"setElement accum must be a BinaryOp, got "
                    f"{accum!r}")
            if runs and runs[-1][0] is accum:
                runs[-1][1].append((idx, scalar))
            else:
                runs.append((accum, [(idx, scalar)]))

        for accum, tuples in runs:
            if udt or len(tuples) == 1:
                # UDT / singleton: the simple per-tuple path
                for idx, scalar in tuples:
                    s = tmap(jnp.asarray, cast_value(scalar, self.type))
                    present = pat[idx]
                    if accum is None:
                        newv = s
                    elif udt:
                        newv = tmap(lambda a, b: jnp.where(present, a, b),
                                    accum(tmap(lambda v: v[idx], vals),
                                          s), s)
                    else:
                        newv = jnp.where(present, accum(vals[idx], s), s)
                    if udt:
                        vals = tmap(lambda v, nv: v.at[idx].set(
                            jnp.asarray(nv, v.dtype)), vals, newv)
                    else:
                        vals = vals.at[idx].set(
                            jnp.asarray(newv, vals.dtype))
                    pat = pat.at[idx].set(True)
                continue
            # batched run: fold duplicates in input order, one scatter
            idxs = [t[0] for t in tuples]
            xs = np.asarray([cast_value(t[1], self.type)
                             for t in tuples], dtype=self.type.dtype)
            if is_vec:
                lin = np.asarray([int(i) for i in idxs], np.int64)
                key = lin
            else:
                ii = np.asarray([int(i) for i, _ in idxs], np.int64)
                jj = np.asarray([int(j) for _, j in idxs], np.int64)
                key = ii * pat.shape[1] + jj
            order = np.argsort(key, kind="stable")
            key_s, xs_s = key[order], xs[order]
            first = np.ones(len(key_s), bool)
            first[1:] = key_s[1:] != key_s[:-1]
            starts = np.nonzero(first)[0]
            if accum is None:
                # last write wins per index
                ends = np.append(starts[1:], len(xs_s)) - 1
                folded = xs_s[ends]
            else:
                folded = _fold_duplicates(accum, xs_s, starts, self.type)
            ku = key_s[starts]
            if is_vec:
                tgt = (jnp.asarray(ku),)
            else:
                tgt = (jnp.asarray(ku // pat.shape[1]),
                       jnp.asarray(ku % pat.shape[1]))
            fold_d = jnp.asarray(folded)
            if accum is None:
                newv = fold_d
            else:
                present = pat[tgt]
                newv = jnp.where(present, accum(vals[tgt], fold_d),
                                 fold_d)
            vals = vals.at[tgt].set(jnp.asarray(newv, vals.dtype))
            pat = pat.at[tgt].set(True)
        return self._replace(values=vals, pattern=pat, pending=[]).canonical()

    # -- element access ------------------------------------------------------------
    def setElement(self, value, *index, accum: Optional[BinaryOp] = None,
                   blocking: Optional[bool] = None):
        """Functional setElement.  With ``blocking=False`` the update is
        appended to the pending-delta buffer (reference ``GB_setElement`` ->
        ``GB_pending_add``) and folded in by :meth:`wait`.  The default
        follows the global mode (``GrB_init(GrB_NONBLOCKING)``)."""
        if blocking is None:
            from .options import BLOCKING, global_options
            blocking = global_options().mode == BLOCKING
        idx = index if len(index) > 1 else index[0]
        self._check_index(idx)
        out = self._replace(pending=self._pending + [(idx, value, accum)])
        return out.wait() if blocking else out

    def _check_index(self, idx):
        """Bounds validation (GrB_INVALID_INDEX): jnp scatters silently
        drop / gathers clamp out-of-range indices, so check up front."""
        shape = self.shape
        parts = idx if isinstance(idx, tuple) else (idx,)
        for dim, i in zip(shape, parts):
            if not (0 <= int(i) < dim):
                raise IndexOutOfBounds(
                    f"index {parts} out of range for shape {shape}")

    def extractElement(self, *index):
        m = self.wait()
        idx = index if len(index) > 1 else index[0]
        self._check_index(idx)
        present = bool(np.asarray(m.pattern[idx]))
        if not present:
            return None  # GrB_NO_VALUE
        if self.type.is_udt:
            return jax.tree_util.tree_map(
                lambda v: np.asarray(v[idx])[()], m.values)
        return np.asarray(m.values[idx])[()]

    def removeElement(self, *index):
        m = self.wait()
        idx = index if len(index) > 1 else index[0]
        self._check_index(idx)
        return m._replace(pattern=m.pattern.at[idx].set(False)).canonical()

    def clear(self):
        """Remove all entries, keep shape/type (``GrB_Matrix_clear``)."""
        return self._replace(
            values=_tree_zeros(self.type, self.shape),
            pattern=jnp.zeros(self.shape, dtype=np.bool_), pending=[])

    def dup(self):
        return self._replace()

    # -- conversion ------------------------------------------------------------------
    def to_dense(self, fill=None):
        m = self.wait()
        if fill is None:
            out = m.values
        else:
            out = jax.tree_util.tree_map(
                lambda a: jnp.where(m.pattern, a,
                                    jnp.asarray(fill, a.dtype)),
                m.values)

        def pull(a):
            if not isinstance(a, np.ndarray) and a.dtype == jnp.bool_:
                return np_bool(a)
            return np.asarray(a)
        return jax.tree_util.tree_map(pull, out)

    def pattern_np(self):
        return np_bool(self.wait().pattern)


@jax.tree_util.register_pytree_node_class
class Matrix(_Base):
    """A GrB_Matrix: dense-bitmap storage (values + pattern), shape [m, n]."""

    # -- constructors -------------------------------------------------------------
    @staticmethod
    def new(type: Type, nrows: int, ncols: int) -> "Matrix":
        faultinject.checkpoint("Matrix.new")
        return Matrix(_tree_zeros(type, (nrows, ncols)),
                      jnp.zeros((nrows, ncols), dtype=np.bool_), type)

    @staticmethod
    def from_dense(arr, type: Optional[Type] = None,
                   pattern=None) -> "Matrix":
        faultinject.checkpoint("Matrix.from_dense")
        if type is not None and type.is_udt:
            leaves = jax.tree_util.tree_map(jnp.asarray, arr)
            shape = jax.tree_util.tree_leaves(leaves)[0].shape
            pat = (jnp.ones(shape, np.bool_) if pattern is None
                   else jnp.asarray(pattern, np.bool_))
            _check_pattern_shape(pat.shape, shape)
            return Matrix(leaves, pat, type).canonical()
        arr = jnp.asarray(arr)
        t = type or type_of_dtype(arr.dtype)
        arr = cast(arr, t)
        pat = (jnp.ones(arr.shape, np.bool_) if pattern is None
               else jnp.asarray(pattern, np.bool_))
        _check_pattern_shape(pat.shape, arr.shape)
        return Matrix(arr, pat, t).canonical()

    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None,
                 dup: Optional[BinaryOp] = None) -> "Matrix":
        """Build from tuples (reference ``GrB_Matrix_build`` ->
        ``GB_builder``: sort + assemble dups with the dup operator).

        Host-side numpy build: sorts by (i, j) then reduces duplicates in
        order, matching the reference's "last-to-first in input order"
        assembly via the dup op (default PLUS).
        """
        faultinject.checkpoint("Matrix.from_coo")
        I = np.asarray(I, dtype=np.int64)
        J = np.asarray(J, dtype=np.int64)
        X = np.asarray(X)
        t = type or type_of_dtype(X.dtype)
        if t.is_udt:
            raise TypeError(
                "Matrix.from_coo does not assemble struct (UDT) tuples; "
                "build with Matrix.new(type, m, n) + setElement(..., "
                "blocking=False) + wait(), or from_dense with a dict of "
                "field arrays")
        if I.size and (I.min() < 0 or I.max() >= nrows or
                       J.min() < 0 or J.max() >= ncols):
            raise IndexOutOfBounds(f"tuple index out of range for "
                                   f"{nrows}x{ncols} matrix")
        dup = dup or binary.plus[t]
        vals = np.zeros((nrows, ncols), dtype=t.dtype)
        pat = np.zeros((nrows, ncols), dtype=np.bool_)
        if I.size:
            # stable sort by (i,j); assemble duplicates in input order
            # (the GB_builder qsort + GB_build_factory dup-fold, vectorized)
            order = np.lexsort((J, I))
            Is, Js, Xs = I[order], J[order], X[order]
            if Xs.dtype != t.dtype:
                Xs = _cast_array_np(Xs, t)
            lin = Is * ncols + Js
            first = np.ones(len(lin), dtype=bool)
            first[1:] = lin[1:] != lin[:-1]
            starts = np.nonzero(first)[0]
            vflat = vals.reshape(-1)
            pflat = pat.reshape(-1)
            folded = _fold_duplicates(dup, Xs, starts, t)
            vflat[lin[starts]] = folded
            pflat[lin[starts]] = True
            vals = vflat.reshape(nrows, ncols)
            pat = pflat.reshape(nrows, ncols)
        return Matrix(jnp.asarray(vals), jnp.asarray(pat), t).canonical()

    @staticmethod
    def from_scipy(sp, type: Optional[Type] = None) -> "Matrix":
        coo = sp.tocoo()
        return Matrix.from_coo(coo.row, coo.col, coo.data,
                               *sp.shape, type=type)

    # -- shape ---------------------------------------------------------------------
    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def resize(self, nrows: int, ncols: int) -> "Matrix":
        """``GxB_Matrix_resize``: grow with empties / shrink pruning."""
        m = self.wait()
        om, on = m.shape

        def fit(a, fillv):
            a = a[:min(om, nrows), :min(on, ncols)]
            pad = ((0, max(0, nrows - om)), (0, max(0, ncols - on)))
            return jnp.pad(a, pad, constant_values=fillv)
        vals = jax.tree_util.tree_map(lambda a: fit(a, 0), m.values)
        pat = fit(m.pattern, False)
        return m._replace(values=vals, pattern=pat)

    def extractTuples(self):
        """Return (I, J, X) numpy arrays in row-major (CSR) order."""
        m = self.wait()
        pat = np_bool(m.pattern)
        I, J = np.nonzero(pat)
        if self.type.is_udt:
            X = jax.tree_util.tree_map(lambda v: np.asarray(v)[I, J],
                                       m.values)
        else:
            X = np.asarray(m.values)[I, J]
        return I.astype(np.int64), J.astype(np.int64), X

    def T(self) -> "Matrix":
        """Structural transpose (no mask/accum; see ops.transpose for full)."""
        m = self.wait()
        return m._replace(
            values=jax.tree_util.tree_map(lambda a: a.T, m.values),
            pattern=m.pattern.T)

    def rows(self):
        """Iterate (i, cols, vals) over nonempty rows — the
        ``GBI_for_each_vector`` iterator analogue."""
        m = self.wait()
        pat = np_bool(m.pattern)
        vals = m.to_dense()
        for i in np.nonzero(pat.any(axis=1))[0]:
            cols = np.nonzero(pat[i])[0]
            if self.type.is_udt:
                yield int(i), cols, jax.tree_util.tree_map(
                    lambda a: a[i][cols], vals)
            else:
                yield int(i), cols, vals[i][cols]

    def cols(self):
        """Iterate (j, rows, vals) over nonempty columns (CSC view)."""
        for j, rows, vals in self.T().rows():
            yield j, rows, vals

    def __repr__(self):  # pragma: no cover
        return (f"Matrix<{self.type.name}> {self.shape[0]}x{self.shape[1]}, "
                f"{int(jnp.sum(self.pattern))} entries"
                + (f", {len(self._pending)} pending" if self._pending else ""))


@jax.tree_util.register_pytree_node_class
class Vector(_Base):
    """A GrB_Vector: shape [n].  (Reference: a vlen x 1 CSC matrix.)"""

    @staticmethod
    def new(type: Type, n: int) -> "Vector":
        return Vector(_tree_zeros(type, (n,)),
                      jnp.zeros((n,), dtype=np.bool_), type)

    @staticmethod
    def from_dense(arr, type: Optional[Type] = None, pattern=None) -> "Vector":
        arr = jnp.asarray(arr)
        t = type or type_of_dtype(arr.dtype)
        arr = cast(arr, t)
        pat = (jnp.ones(arr.shape, np.bool_) if pattern is None
               else jnp.asarray(pattern, np.bool_))
        _check_pattern_shape(pat.shape, arr.shape)
        return Vector(arr, pat, t).canonical()

    @staticmethod
    def from_coo(I, X, n: int, type: Optional[Type] = None,
                 dup: Optional[BinaryOp] = None) -> "Vector":
        I = np.asarray(I, dtype=np.int64)
        X = np.asarray(X)
        m = Matrix.from_coo(I, np.zeros_like(I), X, n, 1, type=type, dup=dup)
        return Vector(jax.tree_util.tree_map(lambda a: a[:, 0], m.values),
                      m.pattern[:, 0], m.type)

    @property
    def size(self) -> int:
        return self.shape[0]

    def extractTuples(self):
        v = self.wait()
        pat = np_bool(v.pattern)
        (I,) = np.nonzero(pat)
        if self.type.is_udt:
            X = {k: np.asarray(val)[I] for k, val in v.values.items()}
        else:
            X = np.asarray(v.values)[I]
        return I.astype(np.int64), X

    def resize(self, n: int) -> "Vector":
        v = self.wait()
        on = v.shape[0]

        def fit(a, fillv):
            a = a[:min(on, n)]
            return jnp.pad(a, (0, max(0, n - on)), constant_values=fillv)
        return v._replace(
            values=jax.tree_util.tree_map(lambda a: fit(a, 0), v.values),
            pattern=fit(v.pattern, False))

    def __repr__(self):  # pragma: no cover
        return (f"Vector<{self.type.name}> n={self.shape[0]}, "
                f"{int(jnp.sum(self.pattern))} entries")
