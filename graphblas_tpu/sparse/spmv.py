"""Sparse matrix-vector multiply over semirings: gather + segment-reduce.

The reference's SpMV is a CSR row walk inside the generated semiring
workers.  The data-parallel form here is edge-parallel: one gather of x
at the column indices, one vectorized multiply, one segment-reduce keyed
by the COO row ids — all static-shape, one fused program.  Padded lanes read the identity
slot appended to x (see container.py's sentinel convention) so no
masking is needed in the hot path.

Monoid -> segment-reduce mapping (the ``GB_assoc_template.c`` switch
factory analogue): PLUS/TIMES/MIN/MAX map to jax.ops segment ops;
LOR/LAND/LXOR/EQ run on int32 lanes.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.semirings import Semiring
from ..core.types import Type
from .container import CsrMatrix

__all__ = ["csr_mxv", "csr_vxm", "segment_reduce",
           "segment_reduce_sorted", "spmv_plan"]


def segment_reduce_sorted(op_fn, identity, vals, seg_ids,
                          num_segments: int):
    """Segment reduction for ANY associative op (incl. UDT pytree
    values) when ``seg_ids`` is sorted ascending — which CSR entry
    order guarantees.  Log-depth segmented ``associative_scan`` +
    last-of-segment pick; the generic fallback the reference reaches
    through its function-pointer workers (``GB_assoc_template.c``
    default case).

    ``vals`` is a pytree of [E] leaves; ``identity`` a matching pytree
    of scalars.  Returns a pytree of [num_segments] leaves (segments
    with no lanes = identity).
    """
    tmap = jax.tree_util.tree_map
    E = seg_ids.shape[0]

    def combine(a, b):
        va, sa = a
        vb, sb = b
        z = op_fn(va, vb)
        same = sa == sb
        return tmap(lambda zz, yy: jnp.where(same, zz, yy), z, vb), sb

    scanned, _ = jax.lax.associative_scan(combine, (vals, seg_ids))
    is_last = jnp.concatenate([seg_ids[1:] != seg_ids[:-1],
                               jnp.ones((1,), bool)])
    tgt = jnp.where(is_last, seg_ids, num_segments)
    return tmap(
        lambda sc, idv: jnp.full((num_segments + 1,), idv, sc.dtype)
        .at[tgt].set(sc, mode="drop")[:num_segments],
        scanned, identity)


def segment_reduce(monoid_name: str, vals, seg_ids, num_segments: int,
                   identity):
    """Segment-reduce with a named monoid (jitted; static shapes)."""
    nm = monoid_name.upper()
    if nm == "PLUS":
        return jax.ops.segment_sum(vals, seg_ids,
                                   num_segments=num_segments)
    if nm == "TIMES":
        # segment_prod with identity padding: padded lanes carry 1
        return jax.ops.segment_prod(vals, seg_ids,
                                    num_segments=num_segments)
    if nm in ("MAX", "LOR"):
        out = jax.ops.segment_max(
            vals if vals.dtype != jnp.bool_ else vals.astype(jnp.int32),
            seg_ids, num_segments=num_segments)
        # empty segments yield INT32_MIN, which must read as the LOR
        # identity False — compare, don't astype (astype gives True)
        return (out > 0) if vals.dtype == jnp.bool_ else out
    if nm in ("MIN", "LAND"):
        out = jax.ops.segment_min(
            vals if vals.dtype != jnp.bool_ else vals.astype(jnp.int32),
            seg_ids, num_segments=num_segments)
        # empty segments yield INT32_MAX > 0 == the LAND identity True
        return (out > 0) if vals.dtype == jnp.bool_ else out
    if nm in ("LXOR",):
        cnt = jax.ops.segment_sum((vals != 0).astype(jnp.int32), seg_ids,
                                  num_segments=num_segments)
        return (cnt % 2 != 0).astype(vals.dtype)
    if nm == "EQ":
        cnt = jax.ops.segment_sum((vals == 0).astype(jnp.int32), seg_ids,
                                  num_segments=num_segments)
        return (cnt % 2 == 0).astype(vals.dtype)
    raise NotImplementedError(f"segment monoid {nm}")


def _mult_apply(sr: Semiring, avals, xvals):
    """z = mult(a, x) elementwise on the gathered lanes."""
    nm = sr.mult.name
    if nm == "TIMES" or nm == "LAND":
        if avals.dtype == jnp.bool_:
            return avals & (xvals != 0) if xvals.dtype != jnp.bool_ \
                else avals & xvals
        return avals * xvals.astype(avals.dtype)
    if nm == "FIRST":
        return avals
    if nm == "SECOND":
        return xvals
    if nm == "PAIR":
        return jnp.ones_like(avals)
    return sr.mult(avals, xvals.astype(avals.dtype)
                   if avals.dtype != jnp.bool_ else xvals)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _csr_mxv_jit(add_name: str, sr: Semiring, nrows: int, zdtype, avals,
                 cols, rows, x_ext, xp_ext, identity):
    xg = jnp.take(x_ext, cols, axis=0)      # padded lanes hit the slot
    xpg = jnp.take(xp_ext, cols, axis=0)    # structural presence of x
    z = _mult_apply(sr, avals, xg)
    # absent-x and padded lanes contribute the add identity (this is
    # what makes the kernel correct for ALL semirings with sparse x,
    # not just those where mult(a, 0) == identity)
    live = xpg & (rows < nrows)
    z = jnp.where(live, z, jnp.asarray(identity, z.dtype))
    seg = jnp.minimum(rows, nrows)
    y = segment_reduce(add_name, z, seg, nrows + 1, identity)[:nrows]
    # output pattern: rows with >= 1 structural contribution — fused
    # here so one dispatch covers the whole SpMV
    ypat = jax.ops.segment_max(live.astype(jnp.int32), seg,
                               num_segments=nrows + 1)[:nrows] > 0
    y = jnp.where(ypat, y.astype(zdtype), jnp.zeros((), zdtype))
    return y, ypat


_UDT_MXV_CACHE = {}


def _udt_mxv_prog(sr: Semiring, nrows: int):
    """Jitted UDT edge-parallel SpMV (cached by semiring identity —
    UDT identities are dict pytrees, unhashable as static args)."""
    key = (id(sr), nrows)
    f = _UDT_MXV_CACHE.get(key)
    if f is not None:
        return f

    def impl(avals, cols, rows, x_ext, xp_ext):
        # No casting — the caller supplies operands already in the
        # semiring's domains (the reference's UDT workers are likewise
        # cast-free, ``dpagerank2.c:83-101``).
        tmap = jax.tree_util.tree_map
        xg = tmap(lambda v: jnp.take(v, cols, axis=0), x_ext)
        z = sr.mult(avals, xg)
        ident = sr.add.identity
        xpg = jnp.take(xp_ext, cols)
        live = xpg & (rows < nrows)
        z = tmap(lambda zz, idv: jnp.where(live, zz,
                                           jnp.asarray(idv, zz.dtype)),
                 z, ident)
        seg = jnp.minimum(rows, nrows)
        y = segment_reduce_sorted(sr.add.op, ident, z, seg, nrows + 1)
        y = tmap(lambda v: v[:nrows], y)
        ypat = jax.ops.segment_max(live.astype(jnp.int32), seg,
                                   num_segments=nrows + 1)[:nrows] > 0
        y = tmap(lambda v, idv: jnp.where(ypat, v,
                                          jnp.asarray(idv, v.dtype)),
                 y, ident)
        return y, ypat

    f = jax.jit(impl)
    _UDT_MXV_CACHE[key] = f
    return f


#: widened accumulator for the cumsum-based row sum: the global prefix
#: accumulates over ALL lanes, so narrow ints widen to int64 (wrapping
#: sums stay congruent, so rows are exact).  Integer lanes only: a float
#: prefix sum turns one non-finite lane into inf - inf = NaN for every
#: later row, so float PLUS takes the segment sum.
_CUMSUM_WIDE = {np.dtype(np.int8): jnp.int64, np.dtype(np.int16): jnp.int64,
                np.dtype(np.int32): jnp.int64, np.dtype(np.uint8): jnp.int64,
                np.dtype(np.uint16): jnp.int64, np.dtype(np.uint32): jnp.int64,
                np.dtype(np.bool_): jnp.int64}

#: monoids with a direct jax.ops segment reduction (``segment_reduce``;
#: the GB_assoc_template switch-factory analogue); everything else folds
#: via the segmented scan
_SEGMENT_MONOIDS = ("PLUS", "TIMES", "MAX", "MIN", "LOR", "LAND", "LXOR",
                    "EQ")


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _csr_mxv_densex_jit(add_name: str, sr: Semiring, nrows: int, zdtype,
                        avals, cols, rows, indptr, x_ext, identity):
    """Dense-x path: exactly ONE per-lane gather (x at the column ids);
    rows reduce via a widened cumulative sum + O(nrows) boundary
    gathers (PLUS monoids, no scatter atomics), the segment reduction
    (named monoids), or the log-depth segmented scan (the rest).  The
    output pattern comes from indptr degrees — no per-lane pattern
    gather."""
    xg = jnp.take(x_ext, cols, axis=0)
    z = _mult_apply(sr, avals, xg)
    live = rows < nrows
    z = jnp.where(live, z, jnp.asarray(identity, z.dtype))
    nm = add_name.upper()
    deg = indptr[1:] - indptr[:-1]
    ypat = deg > 0
    if nm == "PLUS" and np.dtype(z.dtype) in _CUMSUM_WIDE:
        wide = _CUMSUM_WIDE[np.dtype(z.dtype)]
        cs = jnp.cumsum(z.astype(wide))
        cs0 = jnp.concatenate([jnp.zeros((1,), wide), cs])
        nz = z.shape[0]
        y = cs0[jnp.minimum(indptr[1:], nz)] - \
            cs0[jnp.minimum(indptr[:-1], nz)]
    elif nm in _SEGMENT_MONOIDS:
        # named monoids take the segment reduction: the log-depth
        # associative scan below unrolls ~log2(nzmax) HLO levels, which
        # at scale-18 sizes costs minutes of compile
        seg = jnp.minimum(rows, nrows)
        y = segment_reduce(nm, z, seg, nrows + 1, identity)[:nrows]
    else:
        seg = jnp.minimum(rows, nrows)
        y = segment_reduce_sorted(sr.add.op, identity, z, seg,
                                  nrows + 1)[:nrows]
    # off-pattern slots are zero, matching _csr_mxv_jit's convention
    y = jnp.where(ypat, y.astype(zdtype), jnp.zeros((), zdtype))
    return y, ypat


# ---------------------------------------------------------------------------
# Sort-routed SpMV: zero per-lane gathers, for machines where a random
# per-lane gather is slower than a sort of the same lanes:
#   * precompute (once per matrix) the CSC ordering of the padded
#     lanes: values reordered, the original CSR position of each CSC
#     lane ("rank"), and the column-segment starts;
#   * broadcast x to lanes with a difference-scatter at segment starts
#     + an exact bitcast cummax (piecewise-constant fill-forward built
#     from fast primitives);
#   * multiply, then route the PRODUCTS back to CSR order with one
#     payload sort keyed by rank;
#   * reduce rows with the widened cumsum (PLUS) or the segmented scan
#     (other monoids) as usual.
# The sort is then the bottleneck.  Which of the two dense-x kernels is
# faster is a property of the device (bench_spmv.py times both).
# Reference counterpart: the generated SpMV row walks
# (``Generator/GB_AxB.c``).

#: 4-byte dtypes the bitcast broadcast can carry exactly
_SORTABLE_X = {np.dtype(np.float32), np.dtype(np.int32),
               np.dtype(np.uint32), np.dtype(np.int16),
               np.dtype(np.uint16), np.dtype(np.int8),
               np.dtype(np.uint8), np.dtype(np.bool_)}

#: below this lane count the extra sort stages cost more than the one
#: gather they replace (both are dispatch-bound down here anyway)
_SORTED_MIN_LANES = 1 << 14


def spmv_plan(A: CsrMatrix):
    """Host-side once-per-matrix precompute for the sort-routed SpMV
    (cached on the container).  Returns device arrays
    (avals_csc, rank, seg_starts, seg_cols)."""
    plan = A._options.get("_spmv_plan")
    if plan is not None:
        return plan
    host_pat = A._options.get("host_pattern")
    if host_pat is not None:
        rows, cols = host_pat
    else:
        cols = np.asarray(A.indices)
        rows = np.asarray(A.rowids)
    order = np.lexsort((rows, cols))      # CSC ordering of ALL lanes;
    # padded lanes (col == ncols sentinel) sort to the tail and their
    # rank (original position >= nvals) routes them back to the tail
    cols_csc = cols[order]
    E = len(order)
    starts = np.ones(E, bool)
    starts[1:] = cols_csc[1:] != cols_csc[:-1]
    sp = np.nonzero(starts)[0].astype(np.int32)
    sc = cols_csc[sp].astype(np.int32)
    nseg = len(sp)
    segcap = max(8, 1 << int(np.ceil(np.log2(max(nseg, 1)))))
    sp_pad = np.full(segcap, E, np.int32)       # mode="drop" slot
    sp_pad[:nseg] = sp
    sc_pad = np.full(segcap, A.ncols, np.int32)  # identity x slot
    sc_pad[:nseg] = sc
    if A.type.is_udt:
        avals_csc = jax.tree_util.tree_map(
            lambda v: jnp.take(v, jnp.asarray(order), axis=0), A.values)
    else:
        avals_csc = jnp.take(A.values, jnp.asarray(order), axis=0)
    plan = (avals_csc, jnp.asarray(order.astype(np.int32)),
            jnp.asarray(sp_pad), jnp.asarray(sc_pad))
    A._options["_spmv_plan"] = plan
    return plan


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _csr_mxv_sorted_jit(add_name: str, sr: Semiring, nrows: int, zdtype,
                        avals_csc, rank, sp, sc, rows_csr, indptr,
                        x_ext, identity):
    E = avals_csc.shape[0]
    xs = jnp.take(x_ext, sc, axis=0)        # O(nseg) gather only
    # exact piecewise-constant broadcast: pack (segstart+1) << 32 |
    # x-bits into int64 and cummax — the position tag is strictly
    # increasing across segments, so the max at every lane carries its
    # own segment's exact 32 bits
    if xs.dtype == jnp.float32:
        bits = jax.lax.bitcast_convert_type(xs, jnp.uint32)
    else:
        bits = jax.lax.bitcast_convert_type(
            xs.astype(jnp.int32), jnp.uint32)  # two's-complement exact
    tag0 = ((sp.astype(jnp.int64) + 1) << 32) | bits.astype(jnp.int64)
    tag = jnp.zeros((E,), jnp.int64).at[sp].set(tag0, mode="drop")
    carried = jax.lax.cummax(tag)
    lane_bits = (carried & 0xFFFFFFFF).astype(jnp.uint32)
    if x_ext.dtype == jnp.float32:
        xlane = jax.lax.bitcast_convert_type(lane_bits, jnp.float32)
    else:
        xlane = jax.lax.bitcast_convert_type(
            lane_bits, jnp.int32).astype(x_ext.dtype)
    z = _mult_apply(sr, avals_csc, xlane)
    # route products to CSR order: one payload sort by original position
    _, z_csr = jax.lax.sort([rank, z], num_keys=1)
    nm = add_name.upper()
    deg = indptr[1:] - indptr[:-1]
    ypat = deg > 0
    if nm == "PLUS" and np.dtype(z_csr.dtype) in _CUMSUM_WIDE:
        wide = _CUMSUM_WIDE[np.dtype(z_csr.dtype)]
        cs = jnp.cumsum(z_csr.astype(wide))
        cs0 = jnp.concatenate([jnp.zeros((1,), wide), cs])
        y = cs0[jnp.minimum(indptr[1:], E)] - \
            cs0[jnp.minimum(indptr[:-1], E)]
    elif nm in _SEGMENT_MONOIDS:
        live = rows_csr < nrows
        z_csr = jnp.where(live, z_csr, jnp.asarray(identity, z_csr.dtype))
        seg = jnp.minimum(rows_csr, nrows)
        y = segment_reduce(nm, z_csr, seg, nrows + 1, identity)[:nrows]
    else:
        live = rows_csr < nrows
        z_csr = jnp.where(live, z_csr, jnp.asarray(identity, z_csr.dtype))
        seg = jnp.minimum(rows_csr, nrows)
        y = segment_reduce_sorted(sr.add.op, identity, z_csr, seg,
                                  nrows + 1)[:nrows]
    y = jnp.where(ypat, y.astype(zdtype), jnp.zeros((), zdtype))
    return y, ypat


def _sorted_path_ok(sr: Semiring, A: CsrMatrix) -> bool:
    if A.type.is_udt or sr.ztype.is_udt or sr.xtype.is_udt \
            or sr.ytype.is_udt:
        return False
    if np.dtype(sr.ytype.dtype) not in _SORTABLE_X:
        return False
    if A.nzmax < _SORTED_MIN_LANES:
        return False
    # plan precompute pulls the pattern to host — impossible on tracers
    # (e.g. whole-loop jitted solvers call the gather kernels directly)
    return not isinstance(A.indices, jax.core.Tracer)


def csr_mxv(sr: Semiring, A: CsrMatrix, x, x_pattern=None):
    """(yvals, ypat) = A *.sr* x.  x: dense [ncols] value array;
    ``x_pattern`` marks present entries (None = all present).
    UDT semirings (struct x/z) route through the generic pytree kernel.
    Absent entries of A contribute nothing, even against a non-finite
    x.  The dense-x kernel used is recorded in ``last_axb_method``."""
    from ..core.types import cast as gbcast
    from ..ops.flopcount import record_axb_method
    if sr.ztype.is_udt or sr.xtype.is_udt or sr.ytype.is_udt \
            or A.type.is_udt:
        tmap = jax.tree_util.tree_map
        x_ext = tmap(lambda v: jnp.concatenate(
            [jnp.asarray(v), jnp.zeros((1,), jnp.asarray(v).dtype)]), x)
        if x_pattern is None:
            xp = jnp.ones(A.ncols, bool)
        else:
            xp = jnp.asarray(x_pattern, bool)
        xp_ext = jnp.concatenate([xp, jnp.zeros((1,), bool)])
        return _udt_mxv_prog(sr, A.nrows)(A.values, A.indices,
                                          A.rowids, x_ext, xp_ext)
    ident = sr.add.identity
    # cast operands into the semiring's domains (the bitmap path does
    # this in _mxu_path; int-stored A with a float semiring must not
    # truncate x)
    x = gbcast(jnp.asarray(x), sr.ytype)
    avals = gbcast(A.values, sr.xtype)
    if x_pattern is None:
        xp = jnp.ones(A.ncols, bool)
    else:
        xp = jnp.asarray(x_pattern, bool)
    # identity slot for padded column indices (sentinel = ncols)
    x_ext = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
    if x_pattern is None:
        if _sorted_path_ok(sr, A):
            # dense x, large matrix: zero-gather sort-routed kernel
            record_axb_method("spmv:sorted")
            avals_csc, rank, sp, sc = spmv_plan(A)
            return _csr_mxv_sorted_jit(sr.add.op.name, sr, A.nrows,
                                       sr.ztype.dtype,
                                       gbcast(avals_csc, sr.xtype),
                                       rank, sp, sc, A.rowids, A.indptr,
                                       x_ext, ident)
        # dense x: one-gather kernel, no per-lane pattern work
        record_axb_method("spmv:gather")
        return _csr_mxv_densex_jit(sr.add.op.name, sr, A.nrows,
                                   sr.ztype.dtype, avals, A.indices,
                                   A.rowids, A.indptr, x_ext, ident)
    xp_ext0 = jnp.concatenate([xp, jnp.zeros((1,), bool)])
    return _csr_mxv_jit(sr.add.op.name, sr, A.nrows, sr.ztype.dtype,
                        avals, A.indices, A.rowids, x_ext, xp_ext0,
                        ident)


def csr_vxm(sr: Semiring, x, AT: CsrMatrix, x_pattern=None):
    """w = x' *.sr* A given AT = A.T in CSR (i.e. A in CSC).  Same
    edge-parallel kernel; the caller caches the transpose."""
    return csr_mxv(sr, AT, x, x_pattern)
