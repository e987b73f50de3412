"""General sparse SpGEMM with sparse output: the ESC engine.

C<M> = A *.semiring* B for CSR inputs producing CSR output at O(flops)
memory — ANY (add monoid, mult op) pair, fused mask, no densification.

This is the data-parallel answer to the reference's Gustavson engine
(``Source/GB_AxB_Gustavson.c:139-160``: symbolic count phase + numeric
gather/scatter via the Sauna).  A scatter-accumulator workspace is the
wrong shape for a vector machine, so instead we use the
expand-sort-compress (ESC) formulation, which maps SpGEMM onto the three
primitives XLA lowers well — gather, sort, segmented reduce:

  1. *expand*: every multiply the product needs, ``z_t = a_e * b_pos``,
     is enumerated edge-parallel: lane t of the expansion finds its A
     entry ``e`` by binary search on the cumulative B-row-degree
     (``searchsorted``), then its B entry by offset into B's row — the
     flop enumeration is exactly ``GB_AxB_flopcount.c``'s sum, realized
     as lanes.
  2. *sort*: lanes are keyed by output coordinate i*n+j and sorted
     (stable).  Masked-out / padded lanes get the max key and fall to
     the tail (the mask is applied BEFORE the multiply, so a masked
     product does no arithmetic on masked lanes — mask fusion as in
     ``GB_AxB_Gustavson_mask.c``).
  3. *compress*: segment heads mark unique output coordinates; the add
     monoid folds each segment (named monoids take jax.ops segment
     reductions; arbitrary/user monoids take a segmented
     associative_scan); head lanes scatter-compact to the padded output.

Capacity planning pulls exactly two scalars to the host per call (the
flop total and the output nnz — the analogues of the reference's
symbolic-phase allocation in ``GB_AxB_alloc.c``); buffers are bucketed
to powers of two so jit recompilation is bounded.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.semirings import Semiring
from ..core.types import Type, cast
from .container import CsrMatrix
from .spmv import _SEGMENT_MONOIDS, segment_reduce

__all__ = ["csr_spgemm", "esc_combine"]

_tmap = jax.tree_util.tree_map


#: lanes-per-dispatch ceiling: ESC carries more state per lane than the
#: tri engine (whose cap is 2^26), so its programs stay at 2^24 lanes.
#: A memory bound kept from an earlier device, not re-derived on the
#: card (ROADMAP 1.6).
_ESC_LANE_CAP = 1 << 24


def _bucket(x: int, lo: int = 128) -> int:
    """Round up to the next power of two (>= lo) to bound jit cache."""
    c = lo
    while c < x:
        c <<= 1
    return c


def _bucket4(x: int, lo: int = 1024) -> int:
    """Quarter-step bucket: next value in {5/8, 6/8, 7/8, 8/8} * 2^k
    (>= lo, multiple of 128).  Pow2 buckets waste up to 2x of every
    lane-sized stage; quarter steps cap the waste at 25% for a 4x
    larger (still tiny) jit cache."""
    c = _bucket(x, lo)
    if c <= lo:
        return c
    for num in (5, 6, 7):
        v = (c // 8) * num
        if v >= x and v % 128 == 0:
            return v
    return c


@partial(jax.jit, static_argnums=(2,))
def _flops_jit(a_indices, b_indptr, ncolsA: int):
    degB = (b_indptr[1:] - b_indptr[:-1]).astype(jnp.int64)
    degB_ext = jnp.concatenate([degB, jnp.zeros((1,), jnp.int64)])
    # padded A lanes carry the sentinel column == ncolsA -> length 0
    lens = degB_ext[jnp.minimum(a_indices.astype(jnp.int64), ncolsA)]
    return jnp.sum(lens)


def _mask_keys(M: CsrMatrix, n: int, kdt, big, structural: bool = False):
    """Sorted truthy-entry keys of the mask (padded lanes -> big)."""
    lane = jnp.arange(M.nzmax)
    live = lane < M.nvals
    if not structural:
        if M.type.is_udt:
            raise TypeError("mask with UDT values is not valid")
        live = live & (M.values != 0)
    keys = M.rowids.astype(kdt) * n + M.indices.astype(kdt)
    keys = jnp.where(live, keys, big)
    return jnp.sort(keys)


def _segmented_fold(add, zs, head, seg, E, ident, ztype):
    """Fold each sorted segment with the add monoid -> seg_vals[E+1]
    indexed by segment id (works for arbitrary ops incl. UDT pytrees)."""
    name = add.op.name
    if not ztype.is_udt and name in _SEGMENT_MONOIDS:
        red = segment_reduce(name, zs, seg, E + 1, ident)
        return red
    # generic: segmented inclusive scan (flag, value) — the classic
    # segmented-scan trick; combine restarts at each head
    def combine(l, r):
        lf, lv = l
        rf, rv = r
        v = _tmap(lambda a, b: jnp.where(rf, b, a), add.op(lv, rv), rv)
        return (lf | rf, v)

    flags = head
    _, scanned = jax.lax.associative_scan(combine, (flags, zs))
    # segment result lives at the segment's last lane
    is_end = jnp.concatenate([head[1:], jnp.ones((1,), bool)])
    tgt = jnp.where(is_end, seg, E + 1)
    if ztype.is_udt:
        out = _tmap(lambda i: jnp.full((E + 2,), i), dict(ident)
                    if not isinstance(ident, dict) else ident)
        out = _tmap(lambda o, s: o.at[tgt].set(s, mode="drop"),
                    out, scanned)
        return _tmap(lambda o: o[:E + 1], out)
    out = jnp.full((E + 2,), ident, zs.dtype)
    out = out.at[tgt].set(scanned, mode="drop")
    return out[:E + 1]


@partial(jax.jit, static_argnums=(2,))
def _carry_jit(a_indices, b_indptr, ncolsA: int):
    """Per-entry expansion carries (pattern-only; cached in the plan).

    All lane offsets are int32: per-dispatch flops <= E < 2^31 by
    construction (E = bucket(flops)), int32 lanes move half the bytes
    of int64, and the scatter-diff/cumsum reconstruction is exact
    under int32 wraparound because the reconstructed values fit."""
    nzmaxA = a_indices.shape[0]
    degB = b_indptr[1:] - b_indptr[:-1]
    degB_ext = jnp.concatenate([degB, jnp.zeros((1,), jnp.int32)])
    acol = jnp.minimum(a_indices, ncolsA)
    lens = degB_ext[acol]                      # [nzmaxA] int32
    csum = jnp.cumsum(lens)
    ne = lens > 0
    rank = jnp.cumsum(ne.astype(jnp.int32)) - 1
    tgt = jnp.where(ne, rank, nzmaxA)
    starts = csum - lens                       # int32 lane offsets
    pos0 = b_indptr[acol] - starts
    eid = jnp.arange(nzmaxA, dtype=jnp.int32)

    def compact(v):
        return jnp.zeros((nzmaxA + 1,), jnp.int32).at[tgt].set(
            v, mode="drop")
    nne = jnp.sum(ne.astype(jnp.int32))
    return compact(pos0), compact(eid), compact(starts), nne


def _expand_lanes(pos0_c, eid_c, st_c, nne, total,
                  a_rowids, b_indices, E: int, nzmaxA: int,
                  nzmaxB: int):
    """Lane t -> (A entry e, B position pos, live flag, i, j) from the
    precomputed carries: two scatters + two cumsums + the inherent
    ``b_indices[pos]`` gather — no per-lane searchsorted (~21 chained
    gathers per lane)."""
    CN = pos0_c.shape[0]

    def diffs(v):
        return v - jnp.concatenate([jnp.zeros((1,), v.dtype), v[:-1]])
    ok = jnp.arange(CN, dtype=jnp.int32) < nne
    sc = jnp.where(ok, jnp.clip(st_c, 0, E), E)

    def expand(dv):
        return jnp.cumsum(jnp.zeros((E + 1,), jnp.int32).at[sc].add(
            jnp.where(ok, dv, 0), mode="drop")[:E])
    pos_lane = expand(diffs(pos0_c))
    ec_lane = expand(diffs(eid_c))
    t = jnp.arange(E, dtype=jnp.int32)
    live = t < total
    ec = jnp.clip(ec_lane, 0, nzmaxA - 1)
    posc = jnp.clip(pos_lane + t, 0, nzmaxB - 1)
    i = a_rowids[ec]
    j = b_indices[posc]
    return ec, posc, live, i, j


def _esc_core(sr: Semiring, E: int, m: int, n: int, k: int,
              has_mask: bool, complement: bool, kdt,
              pos0_c, eid_c, st_c, nne, total,
              a_rowids, a_values, b_indices, b_values, m_keys):
    nzmaxA = a_rowids.shape[0]
    nzmaxB = b_indices.shape[0]
    intmax = np.iinfo(np.dtype(kdt)).max
    # bigbase survives the *2+1 tag encoding of the mask merge
    bigbase = jnp.asarray(intmax // 2 - 1, kdt)
    big = jnp.asarray(intmax, kdt)
    sent = jnp.asarray(m * n, kdt)  # output sentinel: row m, "col" fixup

    ec, posc, live, i, j = _expand_lanes(
        pos0_c, eid_c, st_c, nne, total, a_rowids, b_indices, E,
        nzmaxA, nzmaxB)

    key = i.astype(kdt) * n + j.astype(kdt)
    key = jnp.where(live, key, bigbase)

    xt, yt, zt = sr.xtype, sr.ytype, sr.ztype
    a = _tmap(lambda v: v[ec], a_values)
    b = _tmap(lambda v: v[posc], b_values)
    if not xt.is_udt:
        a = cast(a, xt)
    if not yt.is_udt:
        b = cast(b, yt)
    z = sr.mult(a, b)
    ident = sr.add.identity
    if zt.is_udt:
        z = _tmap(lambda zz, ii: jnp.where(live, zz, jnp.asarray(ii)),
                  z, dict(ident) if not isinstance(ident, dict) else ident)
    else:
        z = jnp.where(live, z.astype(zt.dtype), jnp.asarray(ident, zt.dtype))

    # sort by output coordinate, payloads carried THROUGH the sort
    # (an argsort + per-lane permutation gathers costs 2 extra random
    # accesses per lane and per payload leaf; lax.sort moves the
    # payload in the sort network).  Mask membership is a SORT-MERGE,
    # not a per-lane searchsorted (~log2(nzM) chained gathers per
    # lane): the (sorted) mask keys ride the same sort, tagged to land
    # just before their lanes, and membership is one cummax pass
    # (Template/GB_AxB_dot_mask.c as one data-parallel sort).
    leaves, treedef = jax.tree_util.tree_flatten(z)
    if has_mask:
        NM = m_keys.shape[0]
        E2 = E + NM
        allk = jnp.concatenate([m_keys * 2, key * 2 + 1])
        tag = jnp.concatenate([jnp.ones((NM,), jnp.int8),
                               jnp.zeros((E,), jnp.int8)])
        if zt.is_udt:
            idt = dict(ident) if not isinstance(ident, dict) else ident
            # tree_flatten sorts dict keys, so leaf order matches z's
            ileaves = [jnp.asarray(v)
                       for v in jax.tree_util.tree_leaves(idt)]
        else:
            ileaves = [jnp.asarray(ident, leaves[0].dtype)]
        padded = [jnp.concatenate([jnp.full((NM,), iv, l.dtype), l])
                  for l, iv in zip(leaves, ileaves)]
        sorted_ops = jax.lax.sort((allk, tag, *padded), num_keys=1)
        sk = sorted_ops[0]
        is_m = sorted_ops[1] == 1
        zs = jax.tree_util.tree_unflatten(treedef, sorted_ops[2:])
        run = jax.lax.cummax(jnp.where(is_m, sk, jnp.asarray(-1, kdt)))
        match = (~is_m) & (sk < bigbase * 2) & (sk == run + 1)
        keep = ((~is_m) & (sk < bigbase * 2) & ~match) if complement \
            else match
        ks = jnp.where(keep, jnp.right_shift(sk, 1), big)
        if zt.is_udt:
            zs = _tmap(lambda zz, ii: jnp.where(keep, zz,
                                                jnp.asarray(ii)),
                       zs, dict(ident) if not isinstance(ident, dict)
                       else ident)
        else:
            zs = jnp.where(keep, zs, jnp.asarray(ident, zs.dtype))
    else:
        E2 = E
        key = jnp.where(live, key, big)
        sorted_ops = jax.lax.sort((key, *leaves), num_keys=1)
        ks = sorted_ops[0]
        zs = jax.tree_util.tree_unflatten(treedef, sorted_ops[1:])

    head = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    seg = (jnp.cumsum(head) - 1).astype(jnp.int32)

    seg_vals = _segmented_fold(sr.add, zs, head, seg, E2, ident, zt)

    # compact: one output slot per live head
    livek = ks < big
    out_head = head & livek
    r = (jnp.cumsum(out_head) - 1).astype(jnp.int32)
    nnzC = jnp.sum(out_head).astype(jnp.int32)
    tgt = jnp.where(out_head, r, E2 + 1)
    out_keys = jnp.full((E2 + 2,), sent, kdt).at[tgt].set(ks, mode="drop")
    hv = _tmap(lambda sv: sv[seg], seg_vals)
    if zt.is_udt:
        out_vals = _tmap(
            lambda v: jnp.zeros((E2 + 2,), v.dtype
                                ).at[tgt].set(v, mode="drop")[:E2 + 1], hv)
    else:
        out_vals = jnp.zeros((E2 + 2,), hv.dtype
                             ).at[tgt].set(hv, mode="drop")[:E2 + 1]
    out_keys = out_keys[:E2 + 1]

    # coordinates + row-pointer assembly (sentinel -> row m, col n)
    is_sent = out_keys == sent
    oi = jnp.where(is_sent, m, out_keys // n).astype(jnp.int32)
    oj = jnp.where(is_sent, n, out_keys % n).astype(jnp.int32)
    counts = jax.ops.segment_sum(
        (~is_sent).astype(jnp.int32), oi, num_segments=m + 1)
    indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts[:m]).astype(jnp.int32)])
    return indptr, oj, oi, out_vals, nnzC


_esc_jit = jax.jit(_esc_core,
                   static_argnums=(0, 1, 2, 3, 4, 5, 6, 7))


def csr_spgemm(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
               mask: Optional[CsrMatrix] = None,
               complement: bool = False,
               structural: bool = False) -> CsrMatrix:
    """C<M> = A *.sr* B, CSR x CSR -> CSR, any semiring, O(flops).

    ``mask``: optional CsrMatrix whose truthy entries select output
    positions (GraphBLAS valued-mask semantics); ``complement`` flips
    it.

    Host-sync budget (VERDICT r2 weak #4 / next #7): the flop total
    comes from numpy over the build-time host patterns when available
    (zero device pulls), the output nnz costs one scalar pull — and
    BOTH are remembered in a per-(A,B,mask) plan cache keyed by the
    operands' device buffers (weakly, so a dead operand can't alias a
    stale plan).  Steady-state repeated calls — iterated tricount /
    k-truss sweeps, benchmark loops — therefore run with ZERO host
    syncs: submit-only, the analogue of ``GB_AxB_alloc.c``'s symbolic
    sizing done once.
    """
    from ..utils import faultinject
    faultinject.checkpoint("csr_spgemm")
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (m, n):
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(
            f"mask {mask.shape} vs output {(m, n)}")
    zt = sr.ztype

    # key dtype: int32 sort is ~2x int64 on the VPU; fall back as
    # needed.  The masked path carries keys as key*2+1 (the sort-merge
    # tag encoding), which costs one extra bit of headroom.
    kbits = 31 if mask is None else 30
    if (m + 1) * n < (1 << kbits):
        kdt = jnp.int32
    elif (m + 1) * n < (1 << (kbits + 32)):
        kdt = jnp.int64
    else:
        raise NotImplementedError(
            "dimension product exceeds 2^62; use the hyper container")

    # plan cache: (flops, nnz) depend only on the operand/mask patterns,
    # not the semiring, so repeated products over the same containers
    # skip every host round-trip
    import weakref
    pkey = ("_spgemm_plan", bool(complement), bool(structural))
    # a valued (non-structural) mask keys output nnz on its VALUES too
    mask_buf = mask.indices if mask is not None else None
    mask_vbuf = (mask.values if mask is not None and not structural
                 and not mask.type.is_udt else None)
    plan = A._options.get(pkey)
    flops = nnz_known = carries = None
    if plan is not None:
        rb, rm, rmv, pf, pn, pc = plan
        if rb() is B.indices and rm() is mask_buf \
                and rmv() is mask_vbuf:
            flops, nnz_known, carries = pf, pn, pc

    if flops is None:
        # flop total sizes the expansion buffer.  When both operands
        # carry their build-time host patterns, compute it with numpy
        # and spare a device round trip per call
        hpA = A._options.get("host_pattern")
        hpB = B._options.get("host_pattern")
        if hpA is not None and hpB is not None:
            degB = np.bincount(hpB[0][:B.nvals], minlength=k)
            flops = int(degB[hpA[1][:A.nvals]].sum())
        else:
            flops = int(_flops_jit(A.indices, B.indptr, k))
    if flops == 0 or (mask is not None and not complement
                      and mask.nvals == 0):
        return _empty_csr(m, n, zt)
    if flops > _ESC_LANE_CAP:
        # bound each program's lanes (and so its memory): split A into
        # contiguous flop-balanced entry blocks and monoid-merge the
        # per-block partial outputs
        return _csr_spgemm_chunked(sr, A, B, mask, complement,
                                   structural, flops)
    E = _bucket4(flops)

    if carries is None:
        # expansion carries are pattern-only: compute once, slice to
        # the live-entry bucket (a heap-regime B touches few A
        # entries, so warm calls stop paying O(nzmax(A)) stages), and
        # remember them in the plan
        p0, ei, st, nn = _carry_jit(A.indices, B.indptr, k)
        nne_val = int(nn)        # plan-build pull (amortized like nnz)
        CN = min(_bucket(max(nne_val, 8), 128) + 1, p0.shape[0])
        carries = (p0[:CN], ei[:CN], st[:CN],
                   jnp.asarray(nne_val, jnp.int32))
    pos0_c, eid_c, st_c, nne = carries

    has_mask = mask is not None
    # mask pads use bigbase = intmax//2 - 1 so the *2 tag encoding in
    # _esc_core cannot overflow
    m_keys = (_mask_keys(mask, n, kdt,
                         np.iinfo(np.dtype(kdt)).max // 2 - 1,
                         structural)
              if has_mask else jnp.zeros((1,), kdt))

    total = jnp.asarray(min(flops, E), jnp.int32)
    indptr, oj, oi, ov, nnzC = _esc_jit(
        sr, E, m, n, k, has_mask, complement, kdt,
        pos0_c, eid_c, st_c, nne, total,
        A.rowids, A.values, B.indices, B.values, m_keys)
    if nnz_known is not None:
        nnz = nnz_known          # plan hit: no device pull at all
    else:
        nnz = int(nnzC)          # the one host sync of a cold call

        def _ref(x):
            if x is None:
                return lambda: None
            try:
                return weakref.ref(x)
            except TypeError:       # buffer type not weakref-able
                return lambda: None if x is None else x
        A._options[pkey] = (_ref(B.indices), _ref(mask_buf),
                            _ref(mask_vbuf), flops, nnz, carries)
    cap = min(_bucket(max(nnz, 8)), E + 1)
    from ..ops.flopcount import record_axb_method
    record_axb_method("esc:csr_spgemm")
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     _tmap(lambda v: v[:cap], ov), nnz, m, n, zt)


def _csr_spgemm_chunked(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
                        mask, complement: bool, structural: bool,
                        flops: int) -> CsrMatrix:
    """Huge products: contiguous A-entry blocks at flop-balanced
    boundaries (the GB_AxB_parallel.c:52-59 slicing plan), each block
    through the one-program engine, partials merged pairwise with the
    add monoid (blocks partition A's entries, so a shared output key
    is a genuine split segment)."""
    import numpy as np
    m, k = A.shape
    n = B.ncols
    # block containers are cached on A (keyed weakly on B/mask like
    # the per-call plan cache) so each block's own ESC plan cache hits
    # on warm calls — rebuilding blocks per call would orphan those
    # plans and re-pay the carry build + nnz pull every time
    import weakref as _wr

    def _wref(x):
        if x is None:
            return lambda: None
        try:
            return _wr.ref(x)
        except TypeError:
            return lambda: x
    mask_buf = mask.indices if mask is not None else None
    ckey = "_spgemm_chunks"
    entry = A._options.get(ckey)
    blocks = None
    if entry is not None:
        rb, rm, blocks_c = entry
        if rb() is B.indices and rm() is mask_buf:
            blocks = blocks_c
    if blocks is None:
        hpA = A._options.get("host_pattern")
        hpB = B._options.get("host_pattern")
        if hpA is not None and hpB is not None:
            degB = np.bincount(hpB[0][:B.nvals],
                               minlength=k).astype(np.int64)
            csum = np.cumsum(degB[hpA[1][:A.nvals]])
        else:
            from .tri import _entry_flops_csum
            csum = np.asarray(_entry_flops_csum(A.indices, B.indptr, k)
                              )[:A.nvals]
        nz = len(csum)
        bounds = [0]
        prev = 0
        while bounds[-1] < nz and prev < flops:
            s0 = bounds[-1]
            nxt = int(np.searchsorted(csum, prev + _ESC_LANE_CAP,
                                      side="right"))
            nxt = min(max(nxt, s0 + 1), nz)
            bounds.append(nxt)
            prev = int(csum[nxt - 1])
        blocks = []
        for s0, e0 in zip(bounds[:-1], bounds[1:]):
            cap = _bucket(max(e0 - s0, 8), 128)
            blk = CsrMatrix(
                A.indptr,
                jnp.concatenate([A.indices[s0:e0],
                                 jnp.full((cap - (e0 - s0),), k,
                                          A.indices.dtype)]),
                jnp.concatenate([A.rowids[s0:e0],
                                 jnp.full((cap - (e0 - s0),), m,
                                          A.rowids.dtype)]),
                _tmap(lambda v: jnp.concatenate(
                    [v[s0:e0], jnp.zeros((cap - (e0 - s0),), v.dtype)]),
                    A.values),
                e0 - s0, m, A.ncols, A.type)
            if hpA is not None:
                blk._options["host_pattern"] = (hpA[0][s0:e0],
                                                hpA[1][s0:e0])
            blocks.append(blk)
        A._options[ckey] = (_wref(B.indices), _wref(mask_buf), blocks)
    out = None
    for blk in blocks:
        part = csr_spgemm(sr, blk, B, mask=mask, complement=complement,
                          structural=structural)
        out = part if out is None else _merge_partials(sr, out, part,
                                                       m, n)
    from ..ops.flopcount import record_axb_method
    record_axb_method("esc:chunked")
    return out if out is not None else _empty_csr(m, n, sr.ztype)


def _merge_partials(sr: Semiring, P: CsrMatrix, Q: CsrMatrix,
                    m: int, n: int) -> CsrMatrix:
    """Union-merge two partial CSR outputs with the add monoid on
    shared keys (split segments across block boundaries)."""
    zt = sr.ztype
    kdt = jnp.int32 if (m + 1) * n < (1 << 31) else jnp.int64
    big = jnp.asarray(np.iinfo(np.dtype(kdt)).max, kdt)

    def keys_of(X):
        lane = jnp.arange(X.nzmax)
        live = lane < X.nvals
        return jnp.where(live,
                         X.rowids.astype(kdt) * n + X.indices.astype(kdt),
                         big)
    kp, kq = keys_of(P), keys_of(Q)
    keys = jnp.concatenate([kp, kq])
    tags = jnp.concatenate([jnp.zeros((P.nzmax,), bool),
                            jnp.ones((Q.nzmax,), bool)])

    def pad2(vp, vq):
        return _tmap(lambda a, b: jnp.concatenate(
            [a, jnp.zeros((b.shape[0],), a.dtype)]), vp, vq),                _tmap(lambda a, b: jnp.concatenate(
                   [jnp.zeros((a.shape[0],), b.dtype), b]), vp, vq)
    va, vb = pad2(P.values, Q.values)
    ok, ov, nnz = esc_combine(
        keys, tags, va, vb, zt, True, big,
        pair_fn=lambda a, b: sr.add.op(a, b),
        single_a_fn=lambda a: a, single_b_fn=lambda b: b)
    nnz = int(nnz)
    E = ok.shape[0]
    is_dead = ok == big
    oi = jnp.where(is_dead, m, (ok // n)).astype(jnp.int32)
    oj = jnp.where(is_dead, n, (ok % n)).astype(jnp.int32)
    counts = jax.ops.segment_sum((~is_dead).astype(jnp.int32),
                                 jnp.minimum(oi, m), num_segments=m + 1)
    indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts[:m]).astype(jnp.int32)])
    cap = min(_bucket(max(nnz, 8)), E)
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     _tmap(lambda v: v[:cap], ov), nnz, m, n, zt)


def _empty_csr(m: int, n: int, t: Type) -> CsrMatrix:
    from ..core.types import zeros_like_typed
    cap = 8
    vals = zeros_like_typed((cap,), t)
    return CsrMatrix(jnp.zeros((m + 1,), jnp.int32),
                     jnp.full((cap,), n, jnp.int32),
                     jnp.full((cap,), m, jnp.int32),
                     vals, 0, m, n, t)


# ---------------------------------------------------------------------------
# shared sort-combine core for eWise merges (used by sparse.ewise)
# ---------------------------------------------------------------------------

def esc_combine(keys, tags, vals_a, vals_b, ztype,
                union: bool, big, pair_fn, single_a_fn, single_b_fn):
    """Device union/intersection merge of two tagged, keyed tuple sets.

    ``keys``: concatenated linear keys (dead lanes == big); ``tags``:
    False for A-lanes, True for B-lanes; ``vals_a``/``vals_b``: values
    aligned with keys (each only meaningful on its own lanes).  A key
    present in both sets produces ``pair_fn(a, b)``; a singleton
    produces ``single_a_fn(a)`` / ``single_b_fn(b)`` (union=True) or is
    dropped (union=False).  All three callables must return ``ztype``.
    Returns (out_keys[E+1], out_vals[E+1], nnz) with dead slots keyed
    ``big`` — the 4-case merge of ``GB_add.c`` / ``GB_emult.c`` /
    ``GB_spec_accum.m`` as one sort + one vectorized pass.
    """
    E = keys.shape[0]
    # stable sort keeps A before B for equal keys (concat order)
    perm = jnp.argsort(keys)
    ks = keys[perm]
    tg = tags[perm]
    va = _tmap(lambda v: v[perm], vals_a)
    vb = _tmap(lambda v: v[perm], vals_b)
    head = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    nxt_same = jnp.concatenate([ks[1:] == ks[:-1], jnp.zeros((1,), bool)])
    live = ks < big
    # head lane h: pair iff lane h+1 shares the key
    def shift_down(v):
        return jnp.concatenate([v[1:], v[-1:]])
    vb_next = _tmap(shift_down, vb)
    is_pair = head & nxt_same & live
    z_pair = pair_fn(va, vb_next)
    z_a = single_a_fn(va)
    z_b = single_b_fn(vb)
    if ztype.is_udt:
        out_v = _tmap(
            lambda zp, a, b: jnp.where(is_pair, zp, jnp.where(tg, b, a)),
            z_pair, z_a, z_b)
    else:
        out_v = jnp.where(is_pair, z_pair, jnp.where(tg, z_b, z_a))
    keep = head & live if union else is_pair
    r = (jnp.cumsum(keep) - 1).astype(jnp.int32)
    nnz = jnp.sum(keep).astype(jnp.int32)
    tgt = jnp.where(keep, r, E + 1)
    out_keys = jnp.full((E + 2,), big, ks.dtype).at[tgt].set(
        ks, mode="drop")[:E + 1]
    if ztype.is_udt:
        out_vals = _tmap(lambda v: jnp.zeros((E + 2,), v.dtype).at[tgt].set(
            v, mode="drop")[:E + 1], out_v)
    else:
        out_vals = jnp.zeros((E + 2,), out_v.dtype).at[tgt].set(
            out_v, mode="drop")[:E + 1]
    return out_keys, out_vals, nnz
