"""Hypersparse container: huge-dimension matrices at O(nnz + nvec).

The reference stores hypersparse matrices as doubly-compressed CSR —
``h`` lists the non-empty vectors, ``p`` points into them — making
dimension up to 2^60 feasible (``Source/Template/GB_matrix.h:41-132,
216-246``, ``GB.h:314-323``).  The padded-CSR container here keeps an
O(nrows) ``indptr``, so it stops at a few hundred million rows.  This
module removes that cap.

Form here: sorted int64 COO (``rowids``/``indices``/``values``,
padded to a static ``nzmax``) plus the compressed row list ``h`` [hcap]
and row pointers ``hptr`` [hcap+1] over *present* rows only.  Every
kernel is edge-parallel over the nnz lanes:

* there is **no linearized i*ncols+j key anywhere** — at dimension 2^60
  the product overflows int64, so sorts and merges are two-key
  lexicographic (stable argsort by j, then by i) and set membership is
  a tagged combined sort (mask lanes + query lanes sorted together,
  presence propagated per coordinate-segment);
* SpGEMM is the ESC formulation of :mod:`.esc` re-derived for pair
  keys: B-row lookup goes through ``searchsorted`` on ``B.h`` (the
  doubly-compressed analogue of the reference's hyper iterator,
  ``GB.h:3475-3674``), products sort by (i, j), the add monoid folds
  segments, heads compact, and ``h``/``hptr`` are rebuilt on device;
* sparse×sparse-vector SpMV reduces into ``A.h``-indexed segments, so
  the output vector is itself sparse (ids ⊆ A.h) — nothing is ever
  O(dimension).

Capacity planning pulls two scalars per op (flop total, output nnz),
exactly like the CSR ESC engine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.monoids import Monoid
from ..core.ops import BinaryOp
from ..core.semirings import Semiring
from ..core.types import Type, cast, type_of_dtype
from .esc import _bucket, _segmented_fold
from .spmv import segment_reduce, segment_reduce_sorted

__all__ = ["HyperMatrix", "hyper_from_coo", "hyper_spgemm",
           "hyper_ewise", "hyper_mxv", "hyper_reduce_scalar",
           "hyper_reduce_vector", "hyper_apply", "hyper_select",
           "hyper_transpose", "hyper_conform", "nvec_nonempty",
           "GxB_INDEX_MAX", "GxB_HYPER_DEFAULT", "GxB_ALWAYS_HYPER",
           "GxB_NEVER_HYPER"]

_tmap = jax.tree_util.tree_map

#: reference dimension cap (``GB.h:314-323``): indices must stay
#: strictly below 2^60 so sentinel/flip tricks never overflow int64
GxB_INDEX_MAX = 1 << 60

_I64MAX = np.iinfo(np.int64).max


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
class HyperMatrix:
    """Immutable hypersparse pytree (doubly-compressed sorted COO).

    ``h`` [hcap] int64 sorted present-row ids (pad = nrows);
    ``hptr`` [hcap+1] int32 entry pointers over present rows;
    ``rowids``/``indices`` [nzmax] int64 sorted (i, j) (pads = nrows /
    ncols); ``values`` [nzmax].  ``nrows``/``ncols`` may be up to
    ``GxB_INDEX_MAX`` — no array is ever sized by them.
    """

    __slots__ = ("h", "hptr", "rowids", "indices", "values",
                 "nvals", "nvec", "nrows", "ncols", "type", "_options",
                 "_pending")

    def __init__(self, h, hptr, rowids, indices, values, nvals: int,
                 nvec: int, nrows: int, ncols: int, type: Type,
                 pending=None):
        self.h = h
        self.hptr = hptr
        self.rowids = rowids
        self.indices = indices
        self.values = values
        self.nvals = int(nvals)
        self.nvec = int(nvec)
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.type = type
        self._options = {}
        # non-blocking delta buffer (GB_pending_add analogue)
        self._pending = list(pending) if pending else []

    def tree_flatten(self):
        return ((self.h, self.hptr, self.rowids, self.indices,
                 self.values),
                (self.nvals, self.nvec, self.nrows, self.ncols,
                 self.type, tuple(self._pending)))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def _shallow(self) -> "HyperMatrix":
        out = HyperMatrix(self.h, self.hptr, self.rowids, self.indices,
                          self.values, self.nvals, self.nvec,
                          self.nrows, self.ncols, self.type,
                          pending=self._pending)
        out._options = dict(self._options)
        return out

    # -- pending tuples / element mutation (GB_setElement + GB_wait) ----------
    def wait(self) -> "HyperMatrix":
        """Fold the pending delta buffer (reference ``GB_wait``)."""
        if not self._pending:
            return self
        from .pending import fold_pending_hyper
        return fold_pending_hyper(self)

    def setElement(self, value, i: int, j: int, *,
                   accum=None, blocking=None) -> "HyperMatrix":
        from .pending import append_pending
        return append_pending(self, i, j, value, accum, blocking)

    def extractElement(self, i: int, j: int):
        """h-list search then within-row binary search; None for
        GrB_NO_VALUE.  Pulls only scalars + one row slice."""
        from .pending import check_index
        check_index(self, i, j)
        A = self.wait()
        h = np.asarray(A.h[:max(A.nvec, 1)])
        k = int(np.searchsorted(h, i))
        if k >= A.nvec or h[k] != i:
            return None
        s, e = int(A.hptr[k]), int(A.hptr[k + 1])
        row = np.asarray(A.indices[s:e])
        pos = int(np.searchsorted(row, j))
        if pos >= len(row) or row[pos] != j:
            return None
        return np.asarray(A.values[s + pos])[()]

    def removeElement(self, i: int, j: int) -> "HyperMatrix":
        from .pending import check_index
        check_index(self, i, j)
        A = self.wait()
        I, J, X = A.extractTuples()
        keep = ~((I == i) & (J == j))
        return hyper_from_coo(I[keep], J[keep], X[keep], A.nrows,
                              A.ncols, type=A.type, dup=None)

    def resize(self, nrows_new: int, ncols_new: int) -> "HyperMatrix":
        from .pending import hyper_resize
        return hyper_resize(self, nrows_new, ncols_new)

    def clear(self) -> "HyperMatrix":
        return _empty_hyper(self.nrows, self.ncols, self.type)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nzmax(self) -> int:
        return int(self.indices.shape[0])

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None,
                 dup: str = "PLUS") -> "HyperMatrix":
        return hyper_from_coo(I, J, X, nrows, ncols, type=type, dup=dup)

    @staticmethod
    def from_csr(A) -> "HyperMatrix":
        """CsrMatrix -> hypersparse (free: the COO dual is already
        sorted; only h/hptr are derived)."""
        I, J, X = A.extractTuples()
        return hyper_from_coo(I, J, X, A.nrows, A.ncols, type=A.type,
                              dup=None)

    def to_csr(self):
        """Hypersparse -> padded CSR (requires nrows to be small enough
        for an O(nrows) indptr)."""
        if self.nrows > (1 << 28):
            raise ValueError(
                f"nrows {self.nrows} too large for a CSR indptr; "
                "stay hypersparse")
        from .container import csr_from_coo
        I, J, X = self.extractTuples()
        return csr_from_coo(I, J, X, self.nrows, self.ncols,
                            type=self.type, sum_duplicates=False)

    # -- accessors ----------------------------------------------------------
    def extractTuples(self):
        self = self.wait()  # reference extractTuples assembles first
        n = self.nvals
        return (np.asarray(self.rowids)[:n],
                np.asarray(self.indices)[:n],
                np.asarray(self.values)[:n])

    def rows_present(self) -> np.ndarray:
        return np.asarray(self.h)[:self.nvec]

    def row_degrees(self) -> np.ndarray:
        """Degrees of the *present* rows (aligned with ``h``)."""
        p = np.asarray(self.hptr)
        return p[1:self.nvec + 1] - p[:self.nvec]

    def __repr__(self):  # pragma: no cover
        return (f"HyperMatrix<{self.type.name}> "
                f"{self.nrows}x{self.ncols}, {self.nvals} entries in "
                f"{self.nvec} rows")


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

_DUP_FOLDS = {"PLUS": np.add, "TIMES": np.multiply, "MIN": np.minimum,
              "MAX": np.maximum, "FIRST": None, "SECOND": None}


def hyper_from_coo(I, J, X, nrows: int, ncols: int,
                   type: Optional[Type] = None,
                   dup: Optional[str] = "PLUS") -> HyperMatrix:
    """Host-side hypersparse build: int64 lexsort, dup fold, h/hptr.
    ``dup=None`` asserts the tuples are already duplicate-free (the
    import / container-conversion path)."""
    from ..core.errors import IndexOutOfBounds
    from ..utils import faultinject
    faultinject.checkpoint("hyper_from_coo")
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    X = np.asarray(X)
    t = type or type_of_dtype(X.dtype)
    if not (0 < nrows <= GxB_INDEX_MAX and 0 < ncols <= GxB_INDEX_MAX):
        raise ValueError(
            f"dimensions must be in [1, 2^60], got {nrows}x{ncols}")
    if I.size:
        if I.min() < 0 or I.max() >= nrows or J.min() < 0 \
                or J.max() >= ncols:
            raise IndexOutOfBounds(
                f"tuple index out of range for {nrows}x{ncols}")
        order = np.lexsort((J, I))
        I, J, X = I[order], J[order], X[order]
        if dup is not None and I.size > 1:
            same = (I[1:] == I[:-1]) & (J[1:] == J[:-1])
            if same.any():
                nm = dup.upper()
                if nm not in _DUP_FOLDS:
                    raise NotImplementedError(f"dup operator {nm}")
                first = np.concatenate([[True], ~same])
                starts = np.nonzero(first)[0]
                fold = _DUP_FOLDS[nm]
                if nm == "FIRST":
                    X = X[starts]
                elif nm == "SECOND":
                    ends = np.concatenate([starts[1:] - 1, [len(I) - 1]])
                    X = X[ends]
                else:
                    X = fold.reduceat(X, starts)
                I, J = I[starts], J[starts]
    nvals = len(I)
    cap = _round_up(max(nvals, 8), 128)
    rowids = np.full(cap, nrows, np.int64)
    indices = np.full(cap, ncols, np.int64)
    values = np.zeros(cap, t.dtype)
    rowids[:nvals] = I
    indices[:nvals] = J
    values[:nvals] = X.astype(t.dtype, copy=False)
    # compressed row list
    if nvals:
        head = np.concatenate([[True], I[1:] != I[:-1]])
        starts = np.nonzero(head)[0]
        hv = I[starts]
    else:
        starts = np.zeros(0, np.int64)
        hv = np.zeros(0, np.int64)
    nvec = len(hv)
    hcap = _round_up(max(nvec, 8), 128)
    h = np.full(hcap, nrows, np.int64)
    h[:nvec] = hv
    hptr = np.full(hcap + 1, nvals, np.int32)
    hptr[:nvec] = starts
    return HyperMatrix(jnp.asarray(h), jnp.asarray(hptr),
                       jnp.asarray(rowids), jnp.asarray(indices),
                       jnp.asarray(values), nvals, nvec, nrows, ncols, t)


def _empty_hyper(nrows: int, ncols: int, t: Type) -> HyperMatrix:
    return hyper_from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, t.dtype), nrows, ncols, type=t,
                          dup=None)


# ---------------------------------------------------------------------------
# device primitives: pair sort / membership / h-rebuild
# ---------------------------------------------------------------------------

def _pair_argsort(i, j):
    """Stable lexicographic argsort of (i, j) pairs — two stable
    single-key sorts (no linearized key: i*ncols+j overflows int64 at
    hyper dimensions)."""
    p1 = jnp.argsort(j, stable=True)
    p2 = jnp.argsort(i[p1], stable=True)
    return p1[p2]


def _pair_heads(i, j):
    one = jnp.ones((1,), bool)
    return jnp.concatenate(
        [one, (i[1:] != i[:-1]) | (j[1:] != j[:-1])])


def _pair_member(qi, qj, mi, mj, m_live):
    """bool[Eq]: is pair (qi, qj) present among the live mask pairs?
    Combined tagged sort — mask lanes concatenated first so presence
    propagates per coordinate segment.  Dead lanes carry INT64_MAX."""
    nm = mi.shape[0]
    nq = qi.shape[0]
    big = jnp.asarray(_I64MAX, jnp.int64)
    ci = jnp.concatenate([jnp.where(m_live, mi, big), qi])
    cj = jnp.concatenate([jnp.where(m_live, mj, big), qj])
    perm = _pair_argsort(ci, cj)
    si, sj = ci[perm], cj[perm]
    head = _pair_heads(si, sj)
    seg = (jnp.cumsum(head) - 1).astype(jnp.int32)
    is_mask = perm < nm
    has_mask = jax.ops.segment_max(
        is_mask.astype(jnp.int32), seg, num_segments=nm + nq) > 0
    member_sorted = has_mask[seg] & ~is_mask & (si < big)
    qpos = jnp.where(is_mask, nq, perm - nm)
    return jnp.zeros((nq,), bool).at[qpos].set(
        member_sorted, mode="drop")


def _build_h(out_i, nvals, hcap: int, nrows: int):
    """Rebuild the compressed row list from sorted output row ids
    (pad rows == nrows sort to the tail by construction)."""
    cap = out_i.shape[0]
    live = out_i < nrows
    one = jnp.ones((1,), bool)
    row_head = jnp.concatenate([one, out_i[1:] != out_i[:-1]]) & live
    hv = (jnp.cumsum(row_head) - 1).astype(jnp.int32)
    nvec = jnp.sum(row_head).astype(jnp.int32)
    tgt = jnp.where(row_head, hv, hcap)
    h = jnp.full((hcap + 1,), nrows, jnp.int64).at[tgt].set(
        out_i, mode="drop")[:hcap]
    lane = jax.lax.broadcasted_iota(jnp.int32, (cap, 1), 0)[:, 0]
    # hptr scatters past the buffer for non-head lanes (dropped) so
    # slot hcap keeps its end-pointer value nvals
    tgt_p = jnp.where(row_head, hv, hcap + 1)
    hptr = jnp.full((hcap + 1,), nvals, jnp.int32).at[tgt_p].set(
        lane, mode="drop")
    return h, hptr, nvec


# ---------------------------------------------------------------------------
# SpGEMM: hyper x hyper -> hyper, any semiring, O(flops)
# ---------------------------------------------------------------------------

def _hyper_flops(a_indices, b_h, b_hptr):
    """Per-A-entry B-row lengths through the compressed row lookup."""
    hcap = b_h.shape[0]
    k = jnp.searchsorted(b_h[:hcap], a_indices)
    kc = jnp.minimum(k, hcap - 1)
    present = b_h[kc] == a_indices
    lens = jnp.where(present,
                     (b_hptr[kc + 1] - b_hptr[kc]).astype(jnp.int64),
                     jnp.int64(0))
    return lens


_flops_hyper_jit = jax.jit(
    lambda ai, bh, bp: jnp.sum(_hyper_flops(ai, bh, bp)))


def _hyper_esc_core(sr: Semiring, E: int, has_mask: bool,
                    complement: bool, hcap: int, nrows: int, ncols: int,
                    a_rowids, a_indices, a_values,
                    b_h, b_hptr, b_indices, b_values,
                    m_rowids, m_indices, m_live):
    nzmaxA = a_indices.shape[0]
    nzmaxB = b_indices.shape[0]
    big = jnp.asarray(_I64MAX, jnp.int64)

    # expand: lane t -> (A entry e, B position pos)
    lens = _hyper_flops(a_indices, b_h, b_hptr)
    csum = jnp.cumsum(lens)
    total = csum[-1]
    t = jax.lax.broadcasted_iota(jnp.int64, (E, 1), 0)[:, 0]
    e = jnp.searchsorted(csum, t, side="right")
    live = t < total
    ec = jnp.minimum(e, nzmaxA - 1)
    start = csum[ec] - lens[ec]
    l = t - start
    khc = jnp.minimum(
        jnp.searchsorted(b_h, a_indices[ec]), hcap - 1)
    pos = b_hptr[khc].astype(jnp.int64) + l
    posc = jnp.clip(pos, 0, nzmaxB - 1).astype(jnp.int32)
    i = jnp.where(live, a_rowids[ec], big)
    j = jnp.where(live, b_indices[posc], big)

    if has_mask:
        member = _pair_member(i, j, m_rowids, m_indices, m_live)
        keep = (~member if complement else member) & live
        i = jnp.where(keep, i, big)
        j = jnp.where(keep, j, big)
        live = keep

    # multiply surviving lanes only (identity elsewhere)
    a = cast(_tmap(lambda v: v[ec], a_values), sr.xtype) \
        if not sr.xtype.is_udt else _tmap(lambda v: v[ec], a_values)
    b = cast(_tmap(lambda v: v[posc], b_values), sr.ytype) \
        if not sr.ytype.is_udt else _tmap(lambda v: v[posc], b_values)
    z = sr.mult(a, b)
    ident = sr.add.identity
    zt = sr.ztype
    if zt.is_udt:
        z = _tmap(lambda zz, ii: jnp.where(live, zz, jnp.asarray(ii)),
                  z, dict(ident) if not isinstance(ident, dict)
                  else ident)
    else:
        z = jnp.where(live, z.astype(zt.dtype),
                      jnp.asarray(ident, zt.dtype))

    # sort by (i, j); fold segments with the add monoid
    perm = _pair_argsort(i, j)
    si, sj = i[perm], j[perm]
    zs = _tmap(lambda v: v[perm], z)
    head = _pair_heads(si, sj)
    seg = (jnp.cumsum(head) - 1).astype(jnp.int32)
    seg_vals = _segmented_fold(sr.add, zs, head, seg, E, ident, zt)

    # compact one slot per live head
    livek = si < big
    out_head = head & livek
    r = (jnp.cumsum(out_head) - 1).astype(jnp.int32)
    nnzC = jnp.sum(out_head).astype(jnp.int32)
    tgt = jnp.where(out_head, r, E + 1)
    out_i = jnp.full((E + 2,), nrows, jnp.int64).at[tgt].set(
        si, mode="drop")[:E + 1]
    out_j = jnp.full((E + 2,), ncols, jnp.int64).at[tgt].set(
        sj, mode="drop")[:E + 1]
    hv = _tmap(lambda sv: sv[seg], seg_vals)
    if zt.is_udt:
        out_v = _tmap(lambda v: jnp.zeros((E + 2,), v.dtype).at[tgt].set(
            v, mode="drop")[:E + 1], hv)
    else:
        out_v = jnp.zeros((E + 2,), hv.dtype).at[tgt].set(
            hv, mode="drop")[:E + 1]
    h, hptr, nvec = _build_h(out_i, nnzC.astype(jnp.int32), hcap, nrows)
    return out_i, out_j, out_v, nnzC, h, hptr, nvec


_hyper_esc_jit = jax.jit(_hyper_esc_core,
                         static_argnums=(0, 1, 2, 3, 4, 5, 6))


def hyper_spgemm(sr: Semiring, A: HyperMatrix, B: HyperMatrix,
                 mask: Optional[HyperMatrix] = None,
                 complement: bool = False,
                 structural: bool = False) -> HyperMatrix:
    """C<M> = A *.sr* B on hypersparse operands — the ESC engine with
    pair keys.  Dimension-independent: only nnz/nvec-sized arrays."""
    from ..core.errors import DimensionMismatch
    from ..utils import faultinject
    faultinject.checkpoint("hyper_spgemm")
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (m, n):
        raise DimensionMismatch(f"mask {mask.shape} vs output {(m, n)}")
    zt = sr.ztype
    flops = int(_flops_hyper_jit(A.indices, B.h, B.hptr))
    if flops == 0 or (mask is not None and not complement
                      and mask.nvals == 0):
        return _empty_hyper(m, n, zt)
    from .esc import _ESC_LANE_CAP
    if flops > _ESC_LANE_CAP:
        # ESC programs stay under the lane cap (esc.py); when the
        # dimensions admit an O(nrows)
        # indptr, delegate to the lane-capped chunked CSR engine and
        # convert back — huge-dimension AND huge-flop products raise a
        # clear error instead of crashing the device
        from ..ops.containers import _CSR_DIM_CAP
        if max(m, k, n) <= _CSR_DIM_CAP:
            from .esc import csr_spgemm
            Ac, Bc = A.to_csr(), B.to_csr()
            Mc = mask.to_csr() if mask is not None else None
            C = csr_spgemm(sr, Ac, Bc, mask=Mc, complement=complement,
                           structural=structural)
            I, J, X = C.extractTuples()
            return hyper_from_coo(np.asarray(I), np.asarray(J), X,
                                  m, n, type=zt, dup=None)
        raise NotImplementedError(
            f"hyper_spgemm: {flops} expansion lanes exceed the "
            f"single-program lane cap ({_ESC_LANE_CAP}) and the "
            f"dimensions {A.shape} x {B.shape} exceed the CSR "
            f"delegation cap; split the product")
    E = _bucket(flops)
    hcap = _bucket(min(E, max(A.nvec, 8)))

    has_mask = mask is not None
    if has_mask:
        lane = jnp.arange(mask.nzmax)
        m_live = lane < mask.nvals
        if not structural:
            if mask.type.is_udt:
                raise TypeError("mask with UDT values is not valid")
            m_live = m_live & (mask.values != 0)
        m_rowids, m_indices = mask.rowids, mask.indices
    else:
        m_rowids = jnp.zeros((1,), jnp.int64)
        m_indices = jnp.zeros((1,), jnp.int64)
        m_live = jnp.zeros((1,), bool)

    out_i, out_j, out_v, nnzC, h, hptr, nvec = _hyper_esc_jit(
        sr, E, has_mask, complement, hcap, m, n,
        A.rowids, A.indices, A.values,
        B.h, B.hptr, B.indices, B.values,
        m_rowids, m_indices, m_live)
    nnz = int(nnzC)
    nv = int(nvec)
    cap = min(_bucket(max(nnz, 8)), E + 1)
    from ..ops.flopcount import record_axb_method
    record_axb_method("esc:hyper_spgemm")
    return HyperMatrix(h, hptr, out_i[:cap], out_j[:cap],
                       _tmap(lambda v: v[:cap], out_v), nnz, nv, m, n,
                       zt)


# ---------------------------------------------------------------------------
# eWise add/mult: tagged pair-key merge
# ---------------------------------------------------------------------------

def _hyper_merge_core(op: BinaryOp, union: bool, hcap: int, nrows: int,
                      ncols: int, ztype,
                      ai, aj, av, a_live, bi, bj, bv, b_live):
    big = jnp.asarray(_I64MAX, jnp.int64)
    na = ai.shape[0]
    E = na + bi.shape[0]
    ci = jnp.concatenate([jnp.where(a_live, ai, big),
                          jnp.where(b_live, bi, big)])
    cj = jnp.concatenate([jnp.where(a_live, aj, big),
                          jnp.where(b_live, bj, big)])
    # each side's values travel in its own lane array (zeros on the
    # other side's lanes — never read there)
    va = jnp.concatenate([av, jnp.zeros(bi.shape, av.dtype)])
    vb = jnp.concatenate([jnp.zeros((na,), bv.dtype), bv])
    perm = _pair_argsort(ci, cj)   # stable: A lanes first on equal keys
    si, sj = ci[perm], cj[perm]
    tg = perm >= na                # True = B lane
    vas = va[perm]
    vbs = vb[perm]
    head = _pair_heads(si, sj)
    nxt_same = jnp.concatenate(
        [(si[1:] == si[:-1]) & (sj[1:] == sj[:-1]),
         jnp.zeros((1,), bool)])
    live = si < big
    vb_next = jnp.concatenate([vbs[1:], vbs[-1:]])
    is_pair = head & nxt_same & live
    z_pair = cast(op(cast(vas, op.xtype), cast(vb_next, op.ytype)),
                  ztype)
    out_v = jnp.where(is_pair, z_pair,
                      jnp.where(tg, cast(vbs, ztype), cast(vas, ztype)))
    keep = (head & live) if union else is_pair
    r = (jnp.cumsum(keep) - 1).astype(jnp.int32)
    nnz = jnp.sum(keep).astype(jnp.int32)
    tgt = jnp.where(keep, r, E + 1)
    out_i = jnp.full((E + 2,), nrows, jnp.int64).at[tgt].set(
        si, mode="drop")[:E + 1]
    out_j = jnp.full((E + 2,), ncols, jnp.int64).at[tgt].set(
        sj, mode="drop")[:E + 1]
    ov = jnp.zeros((E + 2,), ztype.dtype).at[tgt].set(
        out_v, mode="drop")[:E + 1]
    h, hptr, nvec = _build_h(out_i, nnz, hcap, nrows)
    return out_i, out_j, ov, nnz, h, hptr, nvec


_hyper_merge_jit = jax.jit(_hyper_merge_core,
                           static_argnums=(0, 1, 2, 3, 4, 5))


def hyper_ewise(op: BinaryOp, A: HyperMatrix, B: HyperMatrix,
                union: bool, ztype: Optional[Type] = None
                ) -> HyperMatrix:
    """C = A (+|.*) B: set-union (eWiseAdd, ``GB_add.c``) or
    set-intersection (eWiseMult, ``GB_emult.c``) pair-key merge."""
    from ..core.errors import DimensionMismatch
    if A.shape != B.shape:
        raise DimensionMismatch(f"{A.shape} vs {B.shape}")
    zt = ztype or op.ztype
    lane_a = jnp.arange(A.nzmax)
    lane_b = jnp.arange(B.nzmax)
    hcap = _bucket(max(A.nvec + B.nvec, 8))
    out_i, out_j, ov, nnz, h, hptr, nvec = _hyper_merge_jit(
        op, union, hcap, A.nrows, A.ncols, zt,
        A.rowids, A.indices, A.values, lane_a < A.nvals,
        B.rowids, B.indices, B.values, lane_b < B.nvals)
    nz = int(nnz)
    cap = _round_up(max(nz, 8), 128)
    cap = min(cap, out_i.shape[0])
    return HyperMatrix(h, hptr, out_i[:cap], out_j[:cap], ov[:cap],
                       nz, int(nvec), A.nrows, A.ncols, zt)


# ---------------------------------------------------------------------------
# SpMV with a sparse vector: y<ids ⊆ A.h> = A *.sr* x
# ---------------------------------------------------------------------------

def _hyper_mxv_core(sr: Semiring, hcap: int, a_rowids, a_indices,
                    a_values, a_h, x_ids, x_vals, x_live):
    big = jnp.asarray(_I64MAX, jnp.int64)
    xi = jnp.where(x_live, x_ids, big)
    # sparse gather: position of each A column id in the x id list
    pos = jnp.searchsorted(xi, a_indices)
    posc = jnp.minimum(pos, xi.shape[0] - 1)
    present = (xi[posc] == a_indices) & (a_indices < big)
    xg = x_vals[posc]
    a = cast(a_values, sr.xtype)
    z = sr.mult(a, cast(xg, sr.ytype))
    ident = sr.add.identity
    z = jnp.where(present, z.astype(sr.ztype.dtype),
                  jnp.asarray(ident, sr.ztype.dtype))
    # reduce into present-row segments: rowids appear in h, so the
    # searchsorted rank is exact for live lanes
    seg = jnp.minimum(jnp.searchsorted(a_h, a_rowids), hcap)
    y = segment_reduce(sr.add.op.name, z, seg, hcap + 1, ident)[:hcap]
    ylive = jax.ops.segment_max(present.astype(jnp.int32), seg,
                                num_segments=hcap + 1)[:hcap] > 0
    return y, ylive


_hyper_mxv_jit = jax.jit(_hyper_mxv_core, static_argnums=(0, 1))


def hyper_mxv(sr: Semiring, A: HyperMatrix, x_ids, x_vals
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(y_ids, y_vals) = A *.sr* x for a sparse vector x given as
    sorted int64 ids + values.  Output ids ⊆ A.h — O(nvec), never
    O(dimension)."""
    x_ids = jnp.asarray(x_ids, jnp.int64)
    x_vals = jnp.asarray(x_vals)
    x_live = jnp.ones(x_ids.shape, bool)
    hcap = A.h.shape[0]
    y, ylive = _hyper_mxv_jit(sr, hcap, A.rowids, A.indices, A.values,
                              A.h, x_ids, x_vals, x_live)
    ylive = np.asarray(ylive)
    ids = np.asarray(A.h)[ylive]
    return ids, np.asarray(y)[ylive]


# ---------------------------------------------------------------------------
# reduce / apply / select / transpose
# ---------------------------------------------------------------------------

def hyper_reduce_scalar(monoid: Monoid, A: HyperMatrix):
    """Fold all stored values with the monoid (``GB_reduce_to_scalar``)."""
    lane = jnp.arange(A.nzmax)
    live = lane < A.nvals
    ident = monoid.identity
    z = jnp.where(live, cast(A.values, monoid.type),
                  jnp.asarray(ident, monoid.type.dtype))
    red = segment_reduce(monoid.op.name, z,
                         jnp.zeros(A.nzmax, jnp.int32), 1, ident)
    return np.asarray(red)[0]


def hyper_reduce_vector(monoid: Monoid, A: HyperMatrix
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, vals): per-row monoid fold — a sparse vector over A.h."""
    hcap = A.h.shape[0]
    lane = jnp.arange(A.nzmax)
    live = lane < A.nvals
    ident = monoid.identity
    z = jnp.where(live, cast(A.values, monoid.type),
                  jnp.asarray(ident, monoid.type.dtype))
    seg = jnp.minimum(jnp.searchsorted(A.h, A.rowids), hcap)
    y = segment_reduce(monoid.op.name, z, seg, hcap + 1, ident)[:hcap]
    ids = np.asarray(A.h)[:A.nvec]
    return ids, np.asarray(y)[:A.nvec]


def hyper_apply(op, A: HyperMatrix, ztype: Optional[Type] = None
                ) -> HyperMatrix:
    """C = op(A): value-only map, pattern shared (``GB_apply.c`` via
    the shallow-pattern shortcut ``GB_shallow_op.c``)."""
    zt = ztype or getattr(op, "ztype", None) or A.type
    vals = op(cast(A.values, getattr(op, "xtype", A.type) or A.type))
    vals = cast(vals, zt) if not zt.is_udt else vals
    return HyperMatrix(A.h, A.hptr, A.rowids, A.indices, vals,
                       A.nvals, A.nvec, A.nrows, A.ncols, zt)


def hyper_select(name: str, A: HyperMatrix, k: int = 0,
                 user_fn=None) -> HyperMatrix:
    """C = select(A, k): TRIL/TRIU/DIAG/OFFDIAG/NONZERO or a user
    predicate fn(i, j, x) -> bool (``GxB_select`` / ``GB_select.c``)."""
    nm = name.upper()
    i, j, x = A.rowids, A.indices, A.values
    lane = jnp.arange(A.nzmax)
    live = lane < A.nvals
    if nm == "TRIL":
        keep = (j - i) <= k
    elif nm == "TRIU":
        keep = (j - i) >= k
    elif nm == "DIAG":
        keep = (j - i) == k
    elif nm == "OFFDIAG":
        keep = (j - i) != k
    elif nm == "NONZERO":
        keep = x != 0
    elif nm == "USER":
        keep = user_fn(i, j, x)
    else:
        raise NotImplementedError(f"select op {nm}")
    keep = np.asarray(keep & live)
    I, J, X = A.extractTuples()
    kp = keep[:A.nvals]
    return hyper_from_coo(I[kp], J[kp], X[kp], A.nrows, A.ncols,
                          type=A.type, dup=None)


def hyper_transpose(A: HyperMatrix) -> HyperMatrix:
    """C = A' — pair re-sort (the bucket transpose of
    ``GB_transpose_bucket.c`` is a counting sort too)."""
    I, J, X = A.extractTuples()
    return hyper_from_coo(J, I, X, A.ncols, A.nrows, type=A.type,
                          dup=None)


# ---------------------------------------------------------------------------
# accum/mask epilogue: C<M> = accum(C, T)  (GB_accum_mask / GB_spec_mask)
# ---------------------------------------------------------------------------

def hyper_accum_mask(C: HyperMatrix, M: Optional[HyperMatrix],
                     T: HyperMatrix, accum: Optional[BinaryOp],
                     replace: bool = False, complement: bool = False,
                     structural: bool = False) -> HyperMatrix:
    """The canonical epilogue on hypersparse operands: Z = accum ?
    eWiseAdd(C, T, accum) : T, then the mask merge — entries where the
    (effective) mask is true come from Z, elsewhere from C (dropped
    under REPLACE).  Transcribes ``GB_spec_mask.m`` / ``GB_mask.c``."""
    C = C.wait()  # fold pending deltas (GB_WAIT at op entry)
    if M is not None:
        M = M.wait()
    Z = hyper_ewise(accum, C, T, union=True, ztype=C.type) \
        if accum is not None else T
    if M is None:
        if complement:
            # effective mask all-false: Z invisible; REPLACE clears C
            return _empty_hyper(C.nrows, C.ncols, C.type) if replace \
                else C
        return Z
    # membership of Z and C tuples in the truthy mask
    lane = jnp.arange(M.nzmax)
    m_live = lane < M.nvals
    if not structural:
        if M.type.is_udt:
            raise TypeError("mask with UDT values is not valid")
        m_live = m_live & (M.values != 0)
    z_lane = jnp.arange(Z.nzmax)
    z_in = _pair_member(
        jnp.where(z_lane < Z.nvals, Z.rowids,
                  jnp.asarray(_I64MAX, jnp.int64)),
        jnp.where(z_lane < Z.nvals, Z.indices,
                  jnp.asarray(_I64MAX, jnp.int64)),
        M.rowids, M.indices, m_live)
    c_lane = jnp.arange(C.nzmax)
    c_in = _pair_member(
        jnp.where(c_lane < C.nvals, C.rowids,
                  jnp.asarray(_I64MAX, jnp.int64)),
        jnp.where(c_lane < C.nvals, C.indices,
                  jnp.asarray(_I64MAX, jnp.int64)),
        M.rowids, M.indices, m_live)
    z_in = np.asarray(z_in)[:Z.nvals]
    c_in = np.asarray(c_in)[:C.nvals]
    if complement:
        z_in, c_in = ~z_in, ~c_in
    ZI, ZJ, ZX = Z.extractTuples()
    CI, CJ, CX = C.extractTuples()
    keep_c = (~c_in) & (not replace)
    I = np.concatenate([ZI[z_in], CI[keep_c]])
    J = np.concatenate([ZJ[z_in], CJ[keep_c]])
    X = np.concatenate([cast_host(ZX[z_in], C.type),
                        CX[keep_c]])
    return hyper_from_coo(I, J, X, C.nrows, C.ncols, type=C.type,
                          dup=None)


def cast_host(x, t: Type):
    from ..core.types import cast as _c
    return np.asarray(_c(jnp.asarray(x), t)) if len(x) else \
        np.asarray(x, t.dtype)


# ---------------------------------------------------------------------------
# hypersparsity conformance (GB_to_hyper_conform)
# ---------------------------------------------------------------------------

#: reference sentinels (``Include/GraphBLAS.h`` GxB_HYPER): a ratio of
#: ALWAYS forces hypersparse, NEVER (any negative) forces standard CSR
GxB_HYPER_DEFAULT = 1.0 / 16
GxB_ALWAYS_HYPER = 1e100
GxB_NEVER_HYPER = -1.0


def nvec_nonempty(A) -> int:
    """# of non-empty vectors (the reference caches this on the matrix,
    ``GB_matrix.h:345``; here it is one device reduction on CSR, free
    on hyper)."""
    if isinstance(A, HyperMatrix):
        return A.nvec
    d = A.indptr[1:] - A.indptr[:-1]
    return int(jnp.count_nonzero(d))


def _ratio_of(A, ratio):
    if ratio is not None:
        return float(ratio)
    r = A._options.get("hyper_ratio")
    if r is None:
        from ..core.options import get_option
        r = get_option("hyper_ratio")
    return float(r)


def hyper_conform(A, ratio: Optional[float] = None):
    """Auto-convert between CSR and hypersparse by the reference's
    hysteresis rule (``GB_matrix.h:216-246``): a CsrMatrix becomes
    hypersparse when ``nvec_nonempty <= nrows * ratio``, a HyperMatrix
    becomes CSR when ``nvec > 2 * nrows * ratio``; in between the
    current format is kept (so formats don't thrash).  ``ratio``
    defaults to the per-matrix ``hyper_ratio`` option, then the global
    one (``GxB_HYPER``); the ALWAYS/NEVER sentinels short-circuit.

    The reference conforms implicitly after every operation (its
    handles are pointers); with immutable containers conversion must
    return a new object, so conformance runs at container boundaries —
    import/export, ``from_coo`` — and wherever the caller asks.
    A dimension too large for an O(nrows) indptr is a hard override:
    the matrix stays hypersparse regardless of ratio."""
    r = _ratio_of(A, ratio)
    if isinstance(A, HyperMatrix):
        if A.nrows > (1 << 28):       # indptr would not fit: stay hyper
            return A
        if r >= 1e99:                 # ALWAYS_HYPER
            return A
        if r < 0 or A.nvec > 2.0 * A.nrows * r:
            out = A.to_csr()
            out._options.update(A._options)
            return out
        return A
    # CsrMatrix side
    if r < 0:                         # NEVER_HYPER
        return A
    if r >= 1e99 or nvec_nonempty(A) <= A.nrows * r:
        out = HyperMatrix.from_csr(A)
        out._options.update(A._options)
        return out
    return A
