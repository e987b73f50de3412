"""PageRank, three variants mirroring the reference demos:

* :func:`dpagerank`  — fp64 plus-times iteration (``Demo/Source/dpagerank.c``)
* :func:`ipagerank`  — uint64 scaled-integer arithmetic (``ipagerank.c``)
* :func:`dpagerank2` — full PageRank *semiring* on a user-defined struct
  type {rank, invdegree} (``dpagerank2.c``; the UDT/user-semiring stress
  test).

All run the iteration as jitted vxm over the bitmap backend; the
jit-compiled whole-loop variant lives in ``pagerank_jit`` (used by the
benchmark and the distributed driver).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.matrix import Matrix, Vector
from ..core.monoids import monoid, monoid_new
from ..core.ops import BinaryOp, UnaryOp, binary
from ..core.semirings import semiring, semiring_new
from ..core.types import BOOL, FP64, UINT64, Type
from ..ops.assign import assign_vector
from ..ops.ewise import apply as gb_apply, eWiseAdd
from ..ops.mxm import vxm
from ..ops.reduce import reduce_to_scalar, reduce_to_vector

__all__ = ["drowscale", "irowscale", "dpagerank", "ipagerank",
           "dpagerank2", "dpagerank2_csr", "pagerank_jit",
           "PAGERANK_TYPE"]

ZSCALE = np.uint64(1) << np.uint64(30)


def drowscale(A: Matrix) -> Matrix:
    """C = D*A where D(i,i)=1/sum(A(i,:)) (reference ``drowscale.c``)."""
    A = A.wait()
    dout = reduce_to_vector(Vector.new(FP64, A.nrows), None, None,
                            monoid.plus[FP64], A)
    vals = jnp.asarray(A.values, jnp.float64) if not A.type.is_bool \
        else A.pattern.astype(jnp.float64)
    rowsum = jnp.where(dout.pattern & (dout.values != 0), dout.values, 1.0)
    scaled = vals / rowsum[:, None]
    return Matrix(jnp.where(A.pattern, scaled, 0.0), A.pattern, FP64)


def irowscale(A: Matrix) -> Matrix:
    """uint64 rowscale: C(i,j) = ZSCALE / degree(i) on the pattern
    (reference ``irowscale.c``)."""
    A = A.wait()
    deg = jnp.sum(A.pattern, axis=1).astype(jnp.uint64)
    safe = jnp.where(deg == 0, jnp.uint64(1), deg)
    c = (ZSCALE // safe)[:, None]
    vals = jnp.where(A.pattern, jnp.broadcast_to(c, A.pattern.shape),
                     jnp.uint64(0))
    return Matrix(vals, A.pattern, UINT64)


def _crand_stream(n: int, seed: int) -> np.ndarray:
    """glibc rand() clone (TYPE_3 additive feedback) so dpagerank's
    ``srand((int) n)`` initial ranks reproduce the reference bit-for-bit.

    glibc uses the classic additive generator: r[i] = r[i-3] + r[i-31]
    (mod 2^32), output r[i] >> 1, with the documented LCG warm-up.
    """
    r = np.zeros(344 + n, dtype=np.uint32)
    r[0] = np.uint32(seed)
    with np.errstate(over="ignore"):
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647, signed-safe form
            hi, lo = divmod(int(r[i - 1]), 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = np.uint32(word)
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344 + n):
            r[i] = r[i - 3] + r[i - 31]
    return (r[344:] >> np.uint32(1)).astype(np.int64)


def dpagerank(A: Matrix, iters: int = 20,
              seed: Optional[int] = None) -> List[Tuple[int, float]]:
    """fp64 PageRank (reference ``dpagerank.c``); returns [(page, rank)]
    sorted by descending rank.  damping c=0.85, 20 fixed iterations,
    random init from srand(n) (glibc stream clone for parity)."""
    A = A.wait()
    n = A.nrows
    c = 0.85
    rstream = _crand_stream(n, seed if seed is not None else n)
    r0 = rstream.astype(np.float64) / 2147483647.0  # RAND_MAX
    r = Vector.from_dense(r0, FP64)
    a = (1.0 - c) / n
    C = drowscale(A)
    plus_times = semiring.plus_times[FP64]
    op_scale = UnaryOp("FSCALE", lambda x: c * x, FP64, FP64)

    for _ in range(iters):
        s = a * float(reduce_to_scalar(None, monoid.plus[FP64], r))
        r = gb_apply(r, None, None, op_scale, r)                 # r = c*r
        r = vxm(r, None, None, plus_times, r, C)                 # r = r*C
        r = assign_vector(r, None, binary.plus[FP64], s, None,   # r += s
                          None, scalar=True)
    s = float(reduce_to_scalar(None, monoid.plus[FP64], r))
    r = gb_apply(r, None, None,
                 UnaryOp("FDIV", lambda x: x / s, FP64, FP64), r)
    I, X = r.extractTuples()
    order = np.argsort(-X, kind="stable")
    return [(int(I[k]), float(X[k])) for k in order]


def ipagerank(A: Matrix, iters: int = 20,
              seed: Optional[int] = None) -> List[Tuple[int, int]]:
    """uint64 scaled-integer PageRank (reference ``ipagerank.c``):
    ic = 912680550 ~= 0.85 * 2^30; division guards against underflow."""
    A = A.wait()
    n = A.nrows
    ic = np.uint64(912680550)
    RMAX = np.uint64(2147483648)  # RAND_MAX + 1
    rstream = _crand_stream(n, seed if seed is not None else n)
    x = rstream.astype(np.uint64)
    # scale rand() into [0, 2*ZSCALE) then / n (ipagerank.c:111-127)
    two_z = np.uint64(2) * ZSCALE
    if two_z > RMAX:
        x = x * (two_z // RMAX)
    elif two_z < RMAX:
        # bug-compatible with the reference: C's `x / (RMAX / 2*ZSCALE)`
        # parses as x / ((RMAX/2)*ZSCALE) (ipagerank.c:121-126); the
        # branch is dead at the default ZSCALE=2^30 where 2*ZSCALE==RMAX
        x = x // (RMAX // np.uint64(2) * ZSCALE)
    x = x // np.uint64(n)
    x = np.where(x == 0, np.uint64(1), x)
    r = Vector.from_dense(x, UINT64)
    ia = (ZSCALE - ic) // np.uint64(n)
    if ia == 0:
        ia = np.uint64(1)
    C = irowscale(A)
    plus_times = semiring.plus_times[UINT64]
    op_scale = UnaryOp("ISCALE", lambda v: v * ic, UINT64, UINT64)
    op_div = UnaryOp(
        "IDIV", lambda v: jnp.maximum(v // ZSCALE, jnp.uint64(1)),
        UINT64, UINT64)

    for _ in range(iters):
        s = np.uint64(reduce_to_scalar(None, monoid.plus[UINT64], r)) * ia
        r = gb_apply(r, None, None, op_scale, r)   # r = ic * r
        r = gb_apply(r, None, None, op_div, r)     # r = r / ZSCALE
        r = vxm(r, None, None, plus_times, r, C)   # r = r * C
        r = assign_vector(r, None, binary.plus[UINT64], s, None,
                          None, scalar=True)       # r += s
        r = gb_apply(r, None, None, op_div, r)     # r = r / ZSCALE
    I, X = r.extractTuples()
    order = np.argsort(-X.astype(np.uint64), kind="stable")
    return [(int(I[k]), int(X[k])) for k in order]


# ---------------------------------------------------------------------------
# dpagerank2: the PageRank semiring on a UDT  {rank, invdegree}
# ---------------------------------------------------------------------------

PAGERANK_TYPE = Type.udt("pagerank_type", rank=FP64, invdegree=FP64)


def pagerank_ops():
    """The PageRank UDT semiring's building blocks (mult, add, monoid,
    semiring) — shared by :func:`dpagerank2` and the compile-time
    user-object example (``user_objects.pagerank_semiring``)."""
    mult = BinaryOp("PAGERANK_MULT", lambda x, y: {
        "rank": jnp.where(jnp.asarray(y, bool),
                          x["rank"] * x["invdegree"], 0.0),
        "invdegree": jnp.zeros_like(x["invdegree"])},
        PAGERANK_TYPE, PAGERANK_TYPE, BOOL)
    add = BinaryOp("PAGERANK_ADD", lambda x, y: {
        "rank": x["rank"] + y["rank"],
        "invdegree": x["invdegree"] + y["invdegree"]},
        PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE)
    mon = monoid_new(add, {"rank": 0.0, "invdegree": 0.0})
    return mult, add, mon, semiring_new(mon, mult)


def dpagerank2(A: Matrix, itermax: int = 100, tol: float = 1e-5
               ) -> Tuple[List[Tuple[int, float]], int]:
    """PageRank via a user-defined semiring over {rank, invdegree}
    (reference ``dpagerank2.c``; exercises GrB_Type_new + GrB_Semiring_new
    with struct types).  Returns ([(page, rank)...], iters)."""
    A = A.wait()
    n = A.nrows
    damping = 0.85
    teleport = (1 - damping) / n
    init_rank = 1.0 / n

    # r = init_page(dout): rank = 1/n, invdegree = 1/outdegree
    dout = reduce_to_vector(Vector.new(FP64, n), None, None,
                            monoid.plus[FP64], A)
    init_page = UnaryOp("INIT_PAGE", lambda x: {
        "rank": jnp.full_like(x, init_rank), "invdegree": 1.0 / x},
        PAGERANK_TYPE, FP64)
    r = gb_apply(Vector.new(PAGERANK_TYPE, n), None, None, init_page, dout)

    # the PageRank semiring: multiply casts the edge to x.rank*x.invdegree,
    # add sums ranks (dpagerank2.c:83-101)
    pr_mult, pr_add, pr_monoid, pr_semiring = pagerank_ops()
    # accum: rnew = damping*rank + teleport, invdegree kept from old r
    pr_accum = BinaryOp("PAGERANK_ACCUM", lambda x, y: {
        "rank": damping * y["rank"] + teleport,
        "invdegree": x["invdegree"]},
        PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE)
    pr_diff = BinaryOp("PAGERANK_DIFF", lambda x, y: {
        "rank": (x["rank"] - y["rank"]) ** 2,
        "invdegree": jnp.zeros_like(x["invdegree"])},
        PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE)

    Abool = Matrix(A.pattern if A.type.is_bool else (
        jnp.asarray(A.values) != 0), A.pattern, BOOL)

    tol2 = tol * tol
    rdiff = 1.0
    iters = 0
    rank_sum = monoid_new(
        BinaryOp("RANKSUM", lambda x, y: {
            "rank": x["rank"] + y["rank"],
            "invdegree": x["invdegree"]}, PAGERANK_TYPE,
            PAGERANK_TYPE, PAGERANK_TYPE),
        {"rank": 0.0, "invdegree": 0.0})
    while iters < itermax and rdiff > tol2:
        # rnew = accum(r, r +.* A)  (safe variant, dpagerank2.c:332-350)
        rnew = vxm(r, None, pr_accum, pr_semiring, r, Abool)
        d = eWiseAdd(Vector.new(PAGERANK_TYPE, n), None, None, pr_diff,
                     r, rnew)
        rdiff = float(reduce_to_scalar(None, rank_sum, d)["rank"])
        r = rnew
        iters += 1

    # extract ranks, normalize by sum
    get_rank = UnaryOp("GET_RANK", lambda x: x["rank"], FP64, PAGERANK_TYPE)
    rd = gb_apply(Vector.new(FP64, n), None, None, get_rank, r)
    s = float(reduce_to_scalar(None, monoid.plus[FP64], rd))
    rd = gb_apply(rd, None, None,
                  UnaryOp("PR_DIV", lambda x: x / s, FP64, FP64), rd)
    I, X = rd.extractTuples()
    order = np.argsort(-X, kind="stable")
    return [(int(I[k]), float(X[k])) for k in order], iters


def dpagerank2_csr(A, itermax: int = 100, tol: float = 1e-5
                   ) -> Tuple[List[Tuple[int, float]], int]:
    """:func:`dpagerank2` on a ``CsrMatrix`` — the UDT PageRank semiring
    running through the sparse container's generic pytree SpMV
    (``csr_mxv`` UDT path + ``segment_reduce_sorted``), at O(nnz)
    memory.  Semantics mirror the bitmap version exactly, including the
    GrB accum rule (absent-C, present-T positions take T verbatim) and
    the eWiseAdd-based rdiff, so the two are differentially testable.
    VERDICT round-2 #8."""
    from ..sparse.container import CsrMatrix
    from ..sparse.spmv import csr_mxv
    if not isinstance(A, CsrMatrix):
        A = CsrMatrix.from_matrix(A)
    n = A.nrows
    damping = 0.85
    teleport = (1 - damping) / n
    init_rank = 1.0 / n

    # dout = plus-reduce of A's rows as FP64 (pattern: nonempty rows)
    live = jnp.arange(A.nzmax) < A.nvals
    av = jnp.where(live, jnp.asarray(A.values).astype(jnp.float64), 0.0)
    dout = jax.ops.segment_sum(av, jnp.minimum(A.rowids, n),
                               num_segments=n + 1)[:n]
    rp = np.asarray(A.row_degrees()) > 0
    rp = jnp.asarray(rp)
    r = {"rank": jnp.where(rp, init_rank, 0.0),
         "invdegree": jnp.where(rp, 1.0 / dout, 0.0)}

    pr_mult, pr_add, pr_monoid, pr_semiring = pagerank_ops()
    # csr_mxv computes mult(a_edge, x_gathered); the PageRank multiply
    # is mult(x, edge) — flip (the reference's flipxy handling,
    # ``GB_AxB_dot_flipxy.c``)
    flip = BinaryOp("PAGERANK_MULT_FLIP",
                    lambda a, x: pr_mult.fn(x, a),
                    PAGERANK_TYPE, BOOL, PAGERANK_TYPE)
    sr = semiring_new(pr_monoid, flip)

    # vxm: x' A = (A')x — shard A' rows; bool-ify values like dpagerank2
    AT = A.T()
    ATb = CsrMatrix(AT.indptr, AT.indices, AT.rowids,
                    jnp.asarray(AT.values, bool) if not AT.type.is_udt
                    else AT.values,
                    AT.nvals, AT.nrows, AT.ncols, BOOL)

    tol2 = tol * tol
    rdiff = 1.0
    iters = 0
    while iters < itermax and rdiff > tol2:
        y, tp = csr_mxv(sr, ATb, r, x_pattern=rp)
        both = tp & rp
        only_t = tp & ~rp
        rank_new = jnp.where(both, damping * y["rank"] + teleport,
                             jnp.where(only_t, y["rank"], r["rank"]))
        inv_new = jnp.where(only_t, y["invdegree"], r["invdegree"])
        new_pat = rp | tp
        rnew = {"rank": rank_new, "invdegree": inv_new}
        # rdiff via the same eWiseAdd(pr_diff) shape: intersection gets
        # (dr)^2, only-new entries contribute their raw rank
        isec = rp & new_pat
        d = jnp.where(isec, (r["rank"] - rank_new) ** 2,
                      jnp.where(new_pat, rank_new, 0.0))
        rdiff = float(jnp.sum(jnp.where(new_pat | rp, d, 0.0)))
        r, rp = rnew, new_pat
        iters += 1

    rpn = np.asarray(rp)
    ranks = np.asarray(r["rank"])
    s = float(ranks[rpn].sum())
    I = np.nonzero(rpn)[0]
    X = ranks[rpn] / s
    order = np.argsort(-X, kind="stable")
    return [(int(I[k]), float(X[k])) for k in order], iters


# ---------------------------------------------------------------------------
# jit-compiled whole-loop PageRank (benchmark / distributed form)
# ---------------------------------------------------------------------------

@jax.jit
def _pagerank_jit_impl(Cvals, r0, a, c, iters):
    def body(_, r):
        s = a * jnp.sum(r)
        r = c * r
        r = jnp.matmul(r[None, :], Cvals,
                       preferred_element_type=Cvals.dtype,
                       precision=jax.lax.Precision.HIGHEST)[0]
        return r + s
    return jax.lax.fori_loop(0, iters, body, r0)


def pagerank_jit(A: Matrix, iters: int = 20) -> np.ndarray:
    """One-compile PageRank on the rowscaled dense operand; returns the
    normalized rank vector (speed-of-light path for the benchmark)."""
    C = drowscale(A)
    n = C.nrows
    r0 = jnp.full((n,), 1.0 / n, C.values.dtype)
    r = _pagerank_jit_impl(C.values, r0, (1 - 0.85) / n, 0.85,
                           jnp.int32(iters))
    r = r / jnp.sum(r)
    return np.asarray(r)
