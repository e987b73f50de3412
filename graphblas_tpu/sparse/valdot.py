"""Value-panel masked SpGEMM: memory-speed NUMERIC semirings (the
round-5 headline engine).

Round 4 made masked *counting* structure-independent (``bitdot``:
popcount panels) but every value-carrying semiring still fell to the
ESC engine, well below one reference core running Gustavson (``GB_AxB_Gustavson.c`` inner loops; the reference's
960 generated workers, ``Source/Generated/GB_AxB__plus_times_fp32.c``,
run every semiring at C-loop memory speed).  This engine generalizes
the heavy-column panel idea to VALUES:

* the heavy wedge-middle columns k (ranked by the exact per-column
  flop count ``indeg_A(k) * deg_B(k)``, ``GB_AxB_flopcount.c``) are
  packed, **one small slab (S=1024 columns) at a time**, into dense
  row-compacted value panels ``Aval[i, s] = A(i, k_s)`` /
  ``Bval[j, s] = B(k_s, j)`` plus matching bitmaps;

* per slab, a plan-time bitmap pass finds the mask entries owning at
  least one (A,B) pair there — the **live list** (a mask entry's
  wedges concentrate in few slabs, so Σ nlive_l × S is 3-4x smaller
  than one wide panel's nlive × S_total at scale 16; the row gathers
  are the pass's traffic);

* the masked product entry for live mask entry (i, j) is a
  gathered-row dot

      C_l[i,j] = add.reduce( mult(Aval[i,:], Bval[j,:]),
                             where = bits(Apack[i,:] & Bpack[j,:]) )

  and slabs merge into the accumulator by the add monoid (identity
  start).  The ``where``-reduce makes padding exact for EVERY monoid
  (``Monoid.reduce``); the plan-time popcounts give the output pattern
  (an entry exists only when the dot has >= 1 term, ``GB_AxB_dot.c``
  semantics);

* slabs stop when the next slab's measured cost (live-entry gather
  traffic + fixed overhead) exceeds the ESC time of the wedges it
  would cover — an exact marginal version of the ``GB_AxB_select``
  inequality — and the residual runs the any-semiring ESC engine with
  the same mask, merged by one sort-merge against the mask keys.

Panels carry the semiring's input dtypes (f32/f64/ints/bool — exact
for ints, the usual reassociation roundoff for floats).  All slabs use
one (bucketed) program shape, so the kernel compiles once.
"""

from __future__ import annotations

import weakref
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.semirings import Semiring
from ..core.types import cast
from .container import CsrMatrix
from .bitdot import _auto_budget, _host_cols_rows, _pack_jit

__all__ = ["ValdotPlan", "build_valdot_plan", "valdot_masked_spgemm"]

#: slab width in columns: small enough that live lists localize the
#: gather traffic, wide enough to amortize per-row gather latency and
#: per-slab overhead.  An unmeasured routing weight on the card.
_LEVEL_COLS = 4096

#: per-chunk gathered panel bytes cap
_CHUNK_BYTES = 1 << 29

#: the marginal slab rule's cost model: per live row a fixed gather
#: latency plus its bytes at a streaming rate, per residual wedge an ESC
#: cost, per slab a fixed overhead (dispatch + scatter-merge).  These
#: are unmeasured routing weights on the card: only their ratios steer
#: the panels/ESC split.
_ISSUE_NS = 35e-9
_STREAM_BW = 1.6e12
_ESC_NS = 230e-9
_LEVEL_OVERHEAD_S = 2e-3

#: a backstop only: the marginal rule, not the cap, should stop the
#: packing
_MAX_LEVELS = 320


def _bucket2(x: int, lo: int = 128) -> int:
    c = lo
    while c < x:
        c <<= 1
    return c


class ValLevel(NamedTuple):
    S: int                    # slot count (uniform = _LEVEL_COLS)
    na: int                   # panel rows, A side (pow2-bucketed)
    nb: int
    a_rows: jnp.ndarray       # PANEL row per selected A entry
    a_slots: jnp.ndarray      # slot per entry (-1 pad)
    a_vals: jnp.ndarray       # entry values (xtype dtype)
    b_js: jnp.ndarray
    b_slots: jnp.ndarray
    b_vals: jnp.ndarray
    live_idx: jnp.ndarray     # mask entries with >=1 pair (pad nzM)
    live_ai: jnp.ndarray      # A panel row per live entry
    live_bj: jnp.ndarray      # B panel row per live entry
    nlive: int
    packed: Optional[tuple]   # (Av, Bv, Ab, Bb) when cached in HBM
    covered: int              # wedges this slab handles


class ValdotPlan(NamedTuple):
    A_light: CsrMatrix        # residual A entries WITH values
    S: int                    # slab width
    kcut: int                 # total packed columns
    covered_lanes: int
    light_lanes: int
    levels: tuple
    cnt: jnp.ndarray          # heavy pair count per padded mask entry
    finite_ok: bool = False   # all operand values finite (plan-time)

    @property
    def panel_bytes(self) -> int:
        return sum(sum(a.nbytes for a in lv.packed) for lv in self.levels
                   if lv.packed is not None)


@partial(jax.jit, static_argnums=(0, 1))
def _pack_vals_jit(nrows: int, S: int, rows, slots, vals):
    """Scatter entry values into the (nrows, S) panel (zeros = absent;
    absence is tracked by the bitmaps, not the zeros)."""
    tgt = jnp.where(slots >= 0,
                    rows.astype(jnp.int64) * S + slots.astype(jnp.int64),
                    nrows * S)
    return (jnp.zeros((nrows * S + 1,), vals.dtype)
            .at[tgt].set(vals, mode="drop")[:nrows * S]
            .reshape(nrows, S))


def _slot_words(S: int) -> int:
    return max(((S + 31) // 32 + 7) // 8 * 8, 8)


def _pack_level(lv: ValLevel):
    if lv.packed is not None:
        return lv.packed
    Av = _pack_vals_jit(lv.na, lv.S, lv.a_rows, lv.a_slots, lv.a_vals)
    Bv = _pack_vals_jit(lv.nb, lv.S, lv.b_js, lv.b_slots, lv.b_vals)
    W = _slot_words(lv.S)
    Ab = _pack_jit(lv.na, W, lv.a_rows, lv.a_slots, lv.a_slots >= 0)
    Bb = _pack_jit(lv.nb, W, lv.b_js, lv.b_slots, lv.b_slots >= 0)
    return Av, Bv, Ab, Bb


@partial(jax.jit, static_argnums=(0,))
def _live_compact_jit(cap: int, cnt_l):
    nzmax = cnt_l.shape[0]
    livemask = cnt_l > 0
    r = (jnp.cumsum(livemask) - 1).astype(jnp.int32)
    tgt = jnp.where(livemask, r, nzmax + 1)
    return jnp.full((nzmax + 2,), nzmax, jnp.int32).at[tgt].set(
        jnp.arange(nzmax, dtype=jnp.int32), mode="drop")[:cap]


def build_valdot_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                      sr: Semiring,
                      budget_bytes: Optional[int] = None,
                      min_lanes: Optional[int] = None,
                      max_levels: int = _MAX_LEVELS,
                      level_cols: Optional[int] = None
                      ) -> Optional[ValdotPlan]:
    """Host-side plan for C<M> = A *.sr* B over the heavy columns.

    Builds slabs of ``level_cols`` columns in wedge-weight order; each
    slab's live mask entries come from a plan-time bitmap pass (the
    counts are accumulated — they ARE the output pattern); slabs stop
    at the marginal break-even against the ESC residual.  Returns None
    when no slab pays (small flop counts, flat profiles, UDT)."""
    import graphblas_tpu.sparse.bitdot as _bd
    from .bitdot import _bitdot_pass
    from .esc import _bucket
    if level_cols is None:
        level_cols = _LEVEL_COLS
    if budget_bytes is None:
        budget_bytes = _auto_budget()
    if min_lanes is None:
        min_lanes = _bd._MIN_LANES
    if sr.xtype.is_udt or sr.ytype.is_udt or sr.ztype.is_udt:
        return None
    m, kk = A.shape
    n = B.ncols
    if A.nvals == 0 or B.nvals == 0 or M.nvals == 0:
        return None
    a_rows, a_cols = _host_cols_rows(A)
    b_rows, b_cols = _host_cols_rows(B)
    indegA = np.bincount(a_cols, minlength=kk).astype(np.int64)
    degB = np.bincount(b_rows, minlength=kk).astype(np.int64)
    score = indegA * degB
    total = int(score.sum())
    if total < min_lanes:
        return None
    order = np.argsort(score)[::-1]
    csum = np.cumsum(score[order])
    nnzk = int((score > 0).sum())
    isa = np.dtype(sr.xtype.dtype).itemsize
    isb = np.dtype(sr.ytype.dtype).itemsize

    xv = cast(A.values, sr.xtype) if not A.type.is_udt else A.values
    yv = cast(B.values, sr.ytype) if not B.type.is_udt else B.values
    # plus_times fast path eligibility: zero panel pads are EXACT when
    # every operand value is finite (inf*0/nan would poison the pads);
    # one plan-time device reduce per operand
    finite_ok = True
    for v, t in ((xv, sr.xtype), (yv, sr.ytype)):
        if np.issubdtype(np.dtype(t.dtype), np.floating):
            finite_ok = finite_ok and bool(jnp.all(jnp.isfinite(v)))
    # sort entries by column rank once so each slab's entries are one
    # contiguous host range (no per-slab membership scan over all nnz)
    rankk = np.full(kk, nnzk, np.int64)
    rankk[order[:nnzk]] = np.arange(nnzk)
    a_rank = rankk[a_cols]
    b_rank = rankk[b_rows]
    a_ord = np.argsort(a_rank, kind="stable")
    b_ord = np.argsort(b_rank, kind="stable")
    a_rank_s = a_rank[a_ord]
    b_rank_s = b_rank[b_ord]

    import os as _os
    import sys as _sys
    import time as _time
    _verbose = bool(_os.environ.get("GBTPU_VERBOSE"))
    _t0 = _time.time()
    levels = []
    cnt_total = None
    sel_end = 0
    covered_all = 0
    panel_budget_left = budget_bytes // 2
    while len(levels) < max_levels and sel_end < nnzk:
        kcut_l = min(level_cols, nnzk - sel_end)
        cov_l = int(csum[sel_end + kcut_l - 1]) - (
            int(csum[sel_end - 1]) if sel_end else 0)
        # optimistic pre-check: even with zero gather traffic, would a
        # slab covering cov_l wedges beat its fixed overhead?
        if cov_l * _ESC_NS <= _LEVEL_OVERHEAD_S:
            break
        a_lo = int(np.searchsorted(a_rank_s, sel_end))
        a_hi = int(np.searchsorted(a_rank_s, sel_end + kcut_l))
        b_lo = int(np.searchsorted(b_rank_s, sel_end))
        b_hi = int(np.searchsorted(b_rank_s, sel_end + kcut_l))
        ae = a_ord[a_lo:a_hi]          # A entries with col in this slab
        be = b_ord[b_lo:b_hi]
        ra, ainv = np.unique(a_rows[ae], return_inverse=True)
        rb, binv = np.unique(b_cols[be], return_inverse=True)
        na = _bucket2(max(len(ra), 8))
        nb = _bucket2(max(len(rb), 8))
        S = level_cols                 # uniform program shape
        ca = _bucket(max(len(ae), 8), 128)
        cb = _bucket(max(len(be), 8), 128)
        arr = np.zeros(ca, np.int32); arr[:len(ae)] = ainv
        asl = np.full(ca, -1, np.int32)
        asl[:len(ae)] = (a_rank[ae] - sel_end).astype(np.int32)
        bjr = np.zeros(cb, np.int32); bjr[:len(be)] = binv
        bsl = np.full(cb, -1, np.int32)
        bsl[:len(be)] = (b_rank[be] - sel_end).astype(np.int32)
        aidx = np.zeros(ca, np.int64); aidx[:len(ae)] = ae
        bidx = np.zeros(cb, np.int64); bidx[:len(be)] = be
        av = jnp.take(xv, jnp.asarray(aidx), axis=0)
        bv = jnp.take(yv, jnp.asarray(bidx), axis=0)
        lv = ValLevel(S, na, nb,
                      jnp.asarray(arr), jnp.asarray(asl), av,
                      jnp.asarray(bjr), jnp.asarray(bsl), bv,
                      jnp.zeros((8,), jnp.int32),
                      jnp.zeros((8,), jnp.int32),
                      jnp.zeros((8,), jnp.int32), 0, None, cov_l)
        Av, Bv, Ab, Bb = _pack_level(lv)
        # liveness from the bit panels (amap/bmap are plan-time-only)
        amap = np.full(m, -1, np.int32)
        amap[ra] = np.arange(len(ra), dtype=np.int32)
        bmap = np.full(n, -1, np.int32)
        bmap[rb] = np.arange(len(rb), dtype=np.int32)
        amap_d = jnp.asarray(amap)
        bmap_d = jnp.asarray(bmap)
        cnt_l = _bitdot_pass(Ab, Bb, amap_d, bmap_d, M)
        # one plan-time sync per slab: the live count
        nlive = int(jnp.sum(cnt_l > 0))
        cost = (nlive * (2 * _ISSUE_NS + S * (isa + isb) / _STREAM_BW)
                + _LEVEL_OVERHEAD_S)
        if cost >= cov_l * _ESC_NS:
            break                       # marginal break-even: stop
        cap = _bucket(max(nlive, 8), 128)
        lidx = _live_compact_jit(cap, cnt_l)
        lidx_c = jnp.clip(lidx, 0, M.nzmax - 1)
        live_ai = amap_d[jnp.clip(jnp.take(M.rowids, lidx_c), 0, m - 1)
                         .astype(jnp.int32)]
        live_bj = bmap_d[jnp.clip(jnp.take(M.indices, lidx_c), 0, n - 1)
                         .astype(jnp.int32)]
        panel_bytes = (Av.nbytes + Bv.nbytes + Ab.nbytes + Bb.nbytes)
        packed = None
        if panel_bytes <= panel_budget_left:
            packed = (Av, Bv, Ab, Bb)
            panel_budget_left -= panel_bytes
        del Av, Bv, Ab, Bb
        levels.append(lv._replace(live_idx=lidx, live_ai=live_ai,
                                  live_bj=live_bj, nlive=nlive,
                                  packed=packed))
        cnt_total = cnt_l if cnt_total is None else cnt_total + cnt_l
        covered_all += cov_l
        sel_end += kcut_l
        if _verbose:
            print(f"[valdot plan {_time.time() - _t0:.0f}s] level "
                  f"{len(levels)}: cols={kcut_l} na={na} nb={nb} "
                  f"nlive={nlive} cov={cov_l}", file=_sys.stderr,
                  flush=True)
    if not levels:
        return None

    sel_any = np.zeros(kk, bool)
    sel_any[order[:sel_end]] = True
    keep = np.zeros(A.nzmax, bool)
    keep[:A.nvals] = ~sel_any[a_cols]
    from .tri import csr_filter_lanes
    from .bitdot import _shrink
    A_light = _shrink(csr_filter_lanes(A, jnp.asarray(keep)))
    lk = keep[:A.nvals]
    A_light._options["host_pattern"] = (a_rows[lk], a_cols[lk])
    return ValdotPlan(A_light, level_cols, sel_end, covered_all,
                      total - covered_all, tuple(levels), cnt_total,
                      finite_ok)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _valdot_jit(nchunk: int, chunk: int, sr: Semiring, use_bits: bool,
                Aval, Bval, Abit, Bbit, live_ai, live_bj, nlive):
    """Gathered-row masked dot over one packed slab for its live mask
    entries (panel coordinates precomputed at plan time), streamed in
    bounded-memory chunks (ONE program per call).  Returns acc[ztype]
    aligned with the (padded) live list."""
    na = Aval.shape[0]
    nb = Bval.shape[0]
    S = Aval.shape[1]
    W = Abit.shape[1]
    E = nchunk * chunk
    t = jnp.arange(E, dtype=jnp.int32)
    valid = t < nlive
    ii = jnp.pad(live_ai, (0, E - live_ai.shape[0]))[:E]
    jj = jnp.pad(live_bj, (0, E - live_bj.shape[0]))[:E]
    ok = (ii >= 0) & (jj >= 0) & valid
    ii = jnp.clip(ii, 0, na - 1).reshape(nchunk, chunk)
    jj = jnp.clip(jj, 0, nb - 1).reshape(nchunk, chunk)
    okc = ok.reshape(nchunk, chunk)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    zt = sr.ztype

    def body(args):
        i, j, o = args
        a = jnp.take(Aval, i, axis=0)
        b = jnp.take(Bval, j, axis=0)
        z = sr.mult(a, b)
        if not zt.is_udt:
            z = z.astype(zt.dtype)
        if not use_bits:
            # plus_times fast path: zero pads contribute exact zeros
            # (gated on plan-time finiteness), so the bitmap gathers
            # and the (chunk, S) mask expansion are skipped entirely
            return jnp.sum(jnp.where(o[:, None], z, 0), axis=1,
                           dtype=z.dtype)
        aw = jnp.take(Abit, i, axis=0)
        bw = jnp.take(Bbit, j, axis=0)
        pw = aw & bw
        bits = (((pw[:, :, None] >> shifts) & jnp.uint32(1)) != 0
                ).reshape(chunk, W * 32)[:, :S]
        return sr.add.reduce(z, axis=1, where=bits & o[:, None])

    return jax.lax.map(body, (ii, jj, okc)).reshape(E)


def _valdot_pass(sr, Av, Bv, Ab, Bb, live_ai, live_bj, nlive,
                 use_bits=True):
    from .esc import _bucket
    E = live_ai.shape[0]
    S = Av.shape[1]
    per = S * (Av.dtype.itemsize + Bv.dtype.itemsize + 8) + S // 2
    chunk = max(1 << 10, min(_bucket(max(E, 8), 1 << 10),
                             _CHUNK_BYTES // max(per, 1)))
    chunk = min(chunk, _bucket(max(E, 8), 128))
    nchunk = (E + chunk - 1) // chunk
    return _valdot_jit(nchunk, chunk, sr, use_bits, Av, Bv, Ab, Bb,
                       live_ai, live_bj, nlive)[:E]


def _valdot_heavy(plan: ValdotPlan, sr: Semiring, M: CsrMatrix):
    """All slabs, each gathering value rows only at its live mask
    entries, merged by monoid scatter into the full accumulator
    (identity start makes plain add.op correct)."""
    zt = sr.ztype
    # plus_times fast path: padding zeros are exact for PLUS/TIMES over
    # finite values, so the bitmap side of the pass is skipped
    use_bits = not (plan.finite_ok
                    and sr.add.op.name == "PLUS"
                    and sr.mult.name in ("TIMES", "TIMES_FLIP")
                    and not zt.is_udt and not zt.is_bool)
    acc = jnp.full((M.nzmax,), sr.add.identity, np.dtype(zt.dtype))
    for lv in plan.levels:
        if lv.nlive == 0:
            continue
        Av, Bv, Ab, Bb = _pack_level(lv)
        part = _valdot_pass(sr, Av, Bv, Ab, Bb,
                            lv.live_ai, lv.live_bj, lv.nlive,
                            use_bits=use_bits)
        idx = jnp.clip(lv.live_idx, 0, M.nzmax - 1)
        valid = jnp.arange(lv.live_idx.shape[0]) < lv.nlive
        merged = sr.add.op(acc[idx], part)
        acc = acc.at[jnp.where(valid, idx, M.nzmax)].set(
            merged, mode="drop")
    return acc, plan.cnt


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _combine_jit(sr: Semiring, E: int, m: int, n: int,
                 m_rowids, m_indices, m_nvals, m_truthy,
                 acc, cnt, r_rowids, r_indices, r_vals, r_nvals):
    """Merge the heavy per-mask-entry dots with the residual ESC output
    (a CSR subset of the mask) and compact to padded CSR arrays."""
    nzR = r_rowids.shape[0]
    big = jnp.int64((1 << 62) - 1)
    lane_m = jnp.arange(E)
    m_live = (lane_m < m_nvals) & m_truthy
    mk = jnp.where(lane_m < m_nvals,
                   m_rowids.astype(jnp.int64) * n + m_indices, big)
    rl = jnp.arange(nzR) < r_nvals
    rk = jnp.where(rl, r_rowids.astype(jnp.int64) * n + r_indices, big)
    # sort-merge: mask entries tag 0 (sort first), residual tag 1
    allk = jnp.concatenate([mk * 2, rk * 2 + 1])
    pay = jnp.concatenate([lane_m.astype(jnp.int32),
                           jnp.full((nzR,), E, jnp.int32)])
    rpay = jnp.concatenate([jnp.full((E,), nzR, jnp.int32),
                            jnp.arange(nzR, dtype=jnp.int32)])
    sk, sp, srp = jax.lax.sort((allk, pay, rpay), num_keys=1)
    is_m = sp < E
    midx = jax.lax.cummax(jnp.where(is_m, sp, -1))
    # residual lanes: the running mask entry has the same key (the ESC
    # output pattern is a subset of the mask)
    r_at = jnp.where((~is_m) & (sk < big * 2), midx, E)
    res_val = jnp.zeros((E + 1,), r_vals.dtype).at[r_at].set(
        jnp.take(r_vals, jnp.clip(srp, 0, nzR - 1), axis=0),
        mode="drop")[:E]
    res_has = jnp.zeros((E + 1,), bool).at[r_at].set(
        True, mode="drop")[:E]

    both = (cnt > 0) & res_has
    merged = sr.add.op(acc, res_val.astype(acc.dtype))
    val = jnp.where(both, merged,
                    jnp.where(res_has, res_val.astype(acc.dtype), acc))
    present = m_live & ((cnt > 0) | res_has)

    r = (jnp.cumsum(present) - 1).astype(jnp.int32)
    nnzC = jnp.sum(present).astype(jnp.int32)
    tgt = jnp.where(present, r, E + 1)
    oi = jnp.full((E + 2,), m, jnp.int32).at[tgt].set(
        m_rowids.astype(jnp.int32), mode="drop")[:E]
    oj = jnp.full((E + 2,), n, jnp.int32).at[tgt].set(
        m_indices.astype(jnp.int32), mode="drop")[:E]
    ov = jnp.zeros((E + 2,), val.dtype).at[tgt].set(
        val, mode="drop")[:E]
    counts = jax.ops.segment_sum(
        present.astype(jnp.int32), jnp.minimum(m_rowids, m),
        num_segments=m + 1)
    indptr = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(counts[:m]).astype(jnp.int32)])
    return indptr, oj, oi, ov, nnzC


_NO_PLAN = object()


def _ref(x):
    try:
        return weakref.ref(x)
    except TypeError:
        return lambda: x


def _cached_plan(M, A, B, sr, budget_bytes):
    """Per-(M, A, B, semiring-dtypes) plan cache on M: panels depend on
    the operand patterns AND values, so the cache keys on both."""
    vA = jax.tree_util.tree_leaves(A.values)[0]
    vB = jax.tree_util.tree_leaves(B.values)[0]
    key = ("valdot_plan", sr.xtype.name, sr.ytype.name)
    entry = M._options.get(key)
    if entry is not None:
        ra, rav, rb, rbv, plan = entry
        if (ra() is A.indices and rav() is vA
                and rb() is B.indices and rbv() is vB):
            return None if plan is _NO_PLAN else plan
    plan = build_valdot_plan(M, A, B, sr, budget_bytes=budget_bytes)
    M._options[key] = (_ref(A.indices), _ref(vA), _ref(B.indices),
                       _ref(vB), _NO_PLAN if plan is None else plan)
    return plan


def valdot_masked_spgemm(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
                         M: CsrMatrix, structural: bool = False,
                         budget_bytes: Optional[int] = None
                         ) -> Optional[CsrMatrix]:
    """C<M> = A *.sr* B through the value-panel engine (heavy columns)
    with the ESC engine on the residual.  Returns None when the plan
    refuses (small flop counts, flat profiles, UDT) — the caller falls
    back to the pure ESC path.  Non-complemented masks only."""
    from ..ops.flopcount import record_axb_method
    from ..utils import faultinject
    faultinject.checkpoint("valdot_masked_spgemm")
    m, k = A.shape
    n = B.ncols
    if M.shape != (m, n):
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(f"mask {M.shape} vs product {(m, n)}")
    plan = _cached_plan(M, A, B, sr, budget_bytes)
    if plan is None:
        return None
    acc, cnt = _valdot_heavy(plan, sr, M)
    if plan.A_light.nvals:
        from .esc import csr_spgemm
        R = csr_spgemm(sr, plan.A_light, B, mask=M,
                       structural=structural)
        record_axb_method("valdot:hybrid")    # after the ESC record
    else:
        R = None
        record_axb_method("valdot:full")
    if structural or M.type.is_udt:
        m_truthy = jnp.ones((M.nzmax,), bool)
    else:
        m_truthy = M.values != 0
    if R is None:
        zdt = np.dtype(sr.ztype.dtype)
        r_rowids = jnp.zeros((8,), jnp.int32)
        r_indices = jnp.zeros((8,), jnp.int32)
        r_vals = jnp.zeros((8,), zdt)
        r_nvals = 0
    else:
        r_rowids, r_indices, r_vals, r_nvals = (
            R.rowids, R.indices, R.values, R.nvals)
    indptr, oj, oi, ov, nnzC = _combine_jit(
        sr, M.nzmax, m, n, M.rowids, M.indices, M.nvals, m_truthy,
        acc, cnt, r_rowids, r_indices, r_vals, r_nvals)
    nnz = int(nnzC)
    from .esc import _bucket
    cap = min(_bucket(max(nnz, 8)), M.nzmax + 1)
    return CsrMatrix(indptr, oj[:cap], oi[:cap], ov[:cap], nnz, m, n,
                     sr.ztype)
