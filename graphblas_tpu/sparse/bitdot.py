"""Bitpacked dot-panel masked SpGEMM: structure-independent counting
on ANY graph shape (the power-law engine).

The sort-merge engine (:mod:`tri`) costs one sorted key per wedge; on
power-law graphs the wedge count concentrates on a few thousand heavy
wedge-middle columns k (measured scale-18 R-MAT: the top 32 K of 262 K
columns carry 97% of all wedges).  This engine splits the contraction
dimension by measured wedge weight:

* **heavy k** (top columns by ``indeg_A(k) * deg_B(k)``): the
  membership of each selected k in A's rows and B's columns is packed
  into per-row **bitmaps** of ``W`` uint32 words.  The masked dot for
  mask entry (i, j) over the packed slab is then

      counts[i,j] = popcount( Apack[i, :] & Bpack[j, :] )

  — two W-word row gathers + AND + popcount, fused by XLA into one
  memory-bandwidth-bound pass whose cost is *independent of graph
  structure*.

* **light k** (the residual): the remaining A entries go through the
  sort-merge engine, whose lane count is now only the uncovered wedge
  fraction (3% at scale 18).

**Row-compacted (hypersparse) panels** (round 5): a slab's panel keeps
only rows that own at least one selected bit, reached through an
(m,)-sized row->panel indirection — one extra cheap int32 gather per
mask entry.  At scale 22 (n = 4.19 M) dense panel rows collapsed the
budget to W=80 over 13 levels and a 4.6 G-lane sort residual dominated
(932 s); with live-row compaction the affordable W multiplies by the
inverse live fraction.  This is the hypersparse insight of
``GB_matrix.h:41-132`` applied to the engine's own workspace.

**Incremental liveness** (round 5): plans built with
``keep_entry_lists=True`` remember, per slab, the original A/B entry id
behind every packed bit, so :func:`bitdot_counts` can re-pack the slabs
under a per-entry ``alive`` mask — no host re-selection, no container
rebuild.  The k-truss sweep (``sparse/tri.py``) prunes edges by ANDing
liveness into the cached plan (the ``ktruss_graphblas.c:10-136`` loop
whose per-iteration cost is one masked product, not a re-plan).

This is the data-parallel answer to the reference's any-pattern masked dot
(``GB_AxB_dot.c:10-27``, ``Template/GB_AxB_dot_mask.c``): the reference
walks each mask entry's two sparse lists; here the heavy lists become
constant-width bitmap rows so the chip streams them at memory speed,
and only the provably-light residual pays per-wedge work.

Semantics: PLUS_PAIR over the pattern — identical to
:func:`tri.masked_pair_counts` (counts aligned with M's padded CSR
entry order) and exact (integer popcounts + integer lanes).
"""

from __future__ import annotations

import weakref
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .container import CsrMatrix

__all__ = ["BitdotPlan", "PackLevel", "build_bitdot_plan",
           "bitdot_counts", "masked_pair_counts_auto"]

#: per-dispatch mask-edge chunk is sized so the two gathered (chunk, W)
#: uint32 panels stay under ~1 GB even if XLA materializes them
_CHUNK_WORDS = 1 << 27

#: peak panel memory budget (cached level-1 pair + one transient
#: extra-level pair coexist), bytes, when the device reports no free
#: memory; override with GBTPU_BITDOT_BUDGET.  A memory bound, not a
#: measured optimum on the card (ROADMAP 3.3)
import os as _os
_PANEL_BUDGET = int(_os.environ.get("GBTPU_BITDOT_BUDGET", 8 << 30))

#: don't bother packing unless the heavy slab covers this wedge share
_MIN_COVER = 0.30

#: below this many wedges the sort-merge engine is a single cheap
#: dispatch and the panel build isn't worth it
_MIN_LANES = 1 << 22

#: stop adding bitmap levels once the residual is below this (one
#: cheap sort dispatch)
_MIN_LEVEL_REM = 1 << 25

#: a level must cover at least this many wedges to pay for its own
#: transient build + gather pass
_MIN_LEVEL_COVER = 1 << 24

#: use a row->panel indirection only when the live-row fraction is
#: below this (otherwise the map gather buys nothing)
_COMPACT_FRAC = 0.75


class PackLevel(NamedTuple):
    """One bitmap slab of selected contraction columns.  The first
    level's packed panels are cached on the plan; every level's compact
    entry lists allow transient (re)packing — levels 2+ are built, used
    and freed inside each counts call so peak HBM is one extra pair."""
    W: int                    # uint32 words per panel row
    na: int                   # panel rows (A side; < m when compacted)
    nb: int                   # panel rows (B side)
    a_rows: jnp.ndarray       # PANEL row per selected A entry
    a_slots: jnp.ndarray      # bit slot per selected A entry (-1 pad)
    a_eids: jnp.ndarray       # original A padded-lane id per entry
    b_js: jnp.ndarray         # PANEL row per selected B entry
    b_slots: jnp.ndarray
    b_eids: jnp.ndarray       # original B padded-lane id per entry
    amap: Optional[jnp.ndarray]  # (m,) orig row -> panel row / -1
    bmap: Optional[jnp.ndarray]  # (n,) orig col -> panel row / -1
    covered: int              # wedges this slab handles


class BitdotPlan(NamedTuple):
    Apack: jnp.ndarray        # packed level-1 A panel (cached)
    Bpack: jnp.ndarray        # packed level-1 B panel (cached)
    A_light: CsrMatrix        # residual A entries (k in NO slab)
    W: int                    # words per row (level 1)
    kcut: int                 # selected columns, all levels
    covered_lanes: int        # wedges handled by all bitmap levels
    light_lanes: int          # wedges left for the sort-merge engine
    levels: tuple = ()        # ALL PackLevel slabs (level 1 first)
    light_eids: Optional[jnp.ndarray] = None  # orig eid per light lane

    @property
    def panel_bytes(self) -> int:
        return self.Apack.nbytes + self.Bpack.nbytes


def _host_cols_rows(X: CsrMatrix):
    """(rowids, indices) of live entries as host arrays (host_pattern
    when present, one device pull otherwise)."""
    hp = X._options.get("host_pattern")
    if hp is not None:
        return (np.asarray(hp[0][:X.nvals]), np.asarray(hp[1][:X.nvals]))
    return (np.asarray(X.rowids[:X.nvals]), np.asarray(X.indices[:X.nvals]))


@partial(jax.jit, static_argnums=(0, 1))
def _pack_jit(nrows: int, W: int, rows, slots, live):
    """Scatter bits (1 << (slot & 31)) into word rows*W + slot>>5.
    Every live (row, slot) pair is unique, so add == bitwise-or."""
    word = (rows.astype(jnp.int64) * W
            + jnp.right_shift(slots, 5).astype(jnp.int64))
    bit = jnp.left_shift(jnp.uint32(1),
                         (slots & 31).astype(jnp.uint32))
    word = jnp.where(live & (slots >= 0), word, nrows * W)
    return (jnp.zeros((nrows * W + 1,), jnp.uint32)
            .at[word].add(jnp.where(live & (slots >= 0), bit, 0),
                          mode="drop")[:nrows * W]
            .reshape(nrows, W))


def _round8(w: int) -> int:
    return max((w // 8) * 8, 0)


class _SlabSel(NamedTuple):
    """Host-side selection of one slab (before device-ification)."""
    kcut: int
    na: int
    nb: int
    a_idx: np.ndarray         # indices into the host entry arrays (A)
    a_slots: np.ndarray
    b_idx: np.ndarray
    b_slots: np.ndarray
    amap: Optional[np.ndarray]
    bmap: Optional[np.ndarray]
    covered: int


def _select_slab(bud: int, sel_start: int, want_cols: int,
                 order, csum, kk: int, m: int, n: int,
                 a_rows, a_cols, b_rows, b_cols,
                 bpc: float = 0.125,
                 quantum: int = 256) -> Optional[_SlabSel]:
    """Pick the widest slab of columns order[sel_start:...] whose
    row-compacted panel pair fits ``bud`` bytes.  Live-row counts grow
    with the slab, so probe, then grow/shrink to the fixpoint.

    ``bpc``: panel bytes per (row, column) slot — 4/32 for bitmaps;
    the value engine (:mod:`valdot`) passes itemsize + 4/32.
    ``quantum``: slab width rounding (256 keeps bitmap word counts a
    multiple of 8 and value panels lane-aligned)."""
    if want_cols <= 0:
        return None

    def live(kcand):
        ksel = order[sel_start:sel_start + kcand]
        pos = np.full(kk, -1, np.int32)
        pos[ksel] = np.arange(kcand, dtype=np.int32)
        am = pos[a_cols] >= 0
        bm = pos[b_rows] >= 0
        ra = np.unique(a_rows[am])
        rb = np.unique(b_cols[bm])
        return pos, am, bm, ra, rb

    def width(rows_total):
        c = int(bud / (bpc * max(rows_total, 1)))
        return (c // quantum) * quantum

    def mem(kcand, na, nb):
        S = max(((kcand + quantum - 1) // quantum) * quantum, quantum)
        return bpc * S * (na + nb)

    # probe at dense-rows width, then retry at the live-row width
    kcand = min(max(width(m + n), quantum), want_cols)
    pos, am, bm, ra, rb = live(kcand)
    na = len(ra) if len(ra) < _COMPACT_FRAC * m else m
    nb = len(rb) if len(rb) < _COMPACT_FRAC * n else n
    for _ in range(3):
        bytes_ = mem(kcand, na, nb)
        grow = min(width(na + nb), want_cols)
        if bytes_ <= bud and grow <= kcand:
            break
        if bytes_ > bud and grow >= kcand:
            break                      # fixpoint within rounding
        kcand = max(grow, quantum) if grow > 0 else kcand
        if grow <= 0:
            return None
        pos, am, bm, ra, rb = live(kcand)
        na = len(ra) if len(ra) < _COMPACT_FRAC * m else m
        nb = len(rb) if len(rb) < _COMPACT_FRAC * n else n
    if mem(kcand, na, nb) > bud:
        # final conservative shrink with the measured live rows
        kcand = width(na + nb)
        if kcand < quantum // 8:
            return None
        kcand = min(kcand, want_cols)
        pos, am, bm, ra, rb = live(kcand)
        na = len(ra) if len(ra) < _COMPACT_FRAC * m else m
        nb = len(rb) if len(rb) < _COMPACT_FRAC * n else n
    if kcand <= 0:
        return None
    covered = int(csum[sel_start + kcand - 1]) - (
        int(csum[sel_start - 1]) if sel_start else 0)
    amap = bmap = None
    if na < m:
        amap = np.full(m, -1, np.int32)
        amap[ra] = np.arange(len(ra), dtype=np.int32)
        arow_panel = amap[a_rows[am]]
    else:
        arow_panel = a_rows[am].astype(np.int32)
    if nb < n:
        bmap = np.full(n, -1, np.int32)
        bmap[rb] = np.arange(len(rb), dtype=np.int32)
        bj_panel = bmap[b_cols[bm]]
    else:
        bj_panel = b_cols[bm].astype(np.int32)
    return _SlabSel(kcand, na, nb,
                    np.nonzero(am)[0], pos[a_cols[am]],
                    np.nonzero(bm)[0], pos[b_rows[bm]],
                    amap, bmap, covered), arow_panel, bj_panel


def _device_level(sel: _SlabSel, arow_panel, bj_panel,
                  keep_entry_lists: bool) -> PackLevel:
    from .esc import _bucket
    na_e, nb_e = len(sel.a_idx), len(sel.b_idx)
    ca, cb = _bucket(max(na_e, 8), 128), _bucket(max(nb_e, 8), 128)
    ar = np.zeros(ca, np.int32); ar[:na_e] = arow_panel
    asl = np.full(ca, -1, np.int32); asl[:na_e] = sel.a_slots
    bj = np.zeros(cb, np.int32); bj[:nb_e] = bj_panel
    bsl = np.full(cb, -1, np.int32); bsl[:nb_e] = sel.b_slots
    z = jnp.zeros((0,), jnp.int32)
    aei = bei = z
    if keep_entry_lists:
        ae = np.zeros(ca, np.int32); ae[:na_e] = sel.a_idx
        be = np.zeros(cb, np.int32); be[:nb_e] = sel.b_idx
        aei, bei = jnp.asarray(ae), jnp.asarray(be)
    W = max(_round8((sel.kcut + 31) // 32 + 7), 8)
    return PackLevel(
        W, sel.na, sel.nb,
        jnp.asarray(ar), jnp.asarray(asl), aei,
        jnp.asarray(bj), jnp.asarray(bsl), bei,
        None if sel.amap is None else jnp.asarray(sel.amap),
        None if sel.bmap is None else jnp.asarray(sel.bmap),
        sel.covered)


def build_bitdot_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                      budget_bytes: Optional[int] = None,
                      cover_target: float = 0.995,
                      min_lanes: Optional[int] = None,
                      max_levels: int = 24,
                      keep_entry_lists: bool = False,
                      ) -> Optional[BitdotPlan]:
    """Host-side plan for counts[e] = (A.B)[i_e, j_e] over PLUS_PAIR.

    Selects the heavy contraction columns by exact wedge weight
    ``indeg_A(k) * deg_B(k)`` (the per-column flop count of
    ``GB_AxB_flopcount.c``) into up to ``max_levels`` row-compacted
    bitmap slabs — the first is packed now and cached, the rest are
    stored as compact entry lists and packed transiently per call — and
    compacts the residual A entries for the sort-merge engine.  Returns
    None when the bitmaps can't cover enough wedges to pay.

    ``keep_entry_lists=True`` additionally keeps the level-1 entry
    lists and the residual's original entry ids on device, enabling
    liveness re-packing (:func:`bitdot_counts` ``alive_*``) for
    incremental sweeps (k-truss)."""
    from .esc import _bucket
    # late-bind the tunables so monkeypatched module globals (tests)
    # and env overrides take effect at call time, not def time
    if budget_bytes is None:
        budget_bytes = _PANEL_BUDGET
    if min_lanes is None:
        min_lanes = _MIN_LANES
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
    kneed = min(int(np.searchsorted(csum, cover_target * total)) + 1,
                nnzk)

    levels = []
    sel_end = 0
    sel_any = np.zeros(kk, bool)
    while len(levels) < max_levels and sel_end < kneed:
        rem = total - (int(csum[sel_end - 1]) if sel_end else 0)
        if sel_end and rem <= max(min_lanes, _MIN_LEVEL_REM):
            break
        bud = budget_bytes // 2
        got = _select_slab(bud, sel_end, kneed - sel_end, order, csum,
                           kk, m, n, a_rows, a_cols, b_rows, b_cols)
        if got is None:
            break
        sel, arow_panel, bj_panel = got
        if sel_end:
            # an extra level pays only when it removes more sort work
            # than its own transient build + gather pass
            if (sel.covered < max(_MIN_LEVEL_COVER, 0.05 * rem)
                    and rem - sel.covered > _MIN_LEVEL_REM):
                break
        levels.append(_device_level(sel, arow_panel, bj_panel,
                                    keep_entry_lists))
        sel_any[order[sel_end:sel_end + sel.kcut]] = True
        sel_end += sel.kcut
    if not levels:
        return None
    covered_all = int(csum[sel_end - 1])
    if covered_all < _MIN_COVER * total:
        return None

    lv0 = levels[0]
    Apack = _pack_jit(lv0.na, lv0.W, lv0.a_rows, lv0.a_slots,
                      lv0.a_slots >= 0)
    Bpack = _pack_jit(lv0.nb, lv0.W, lv0.b_js, lv0.b_slots,
                      lv0.b_slots >= 0)
    if not keep_entry_lists:
        # drop the level-1 lists: tricount-style one-shot callers never
        # re-pack level 1, and at scale the lists are O(nnz) device HBM
        z = jnp.zeros((0,), jnp.int32)
        levels[0] = lv0._replace(a_rows=z, a_slots=z, a_eids=z,
                                 b_js=z, b_slots=z, b_eids=z)

    keep = np.zeros(A.nzmax, bool)
    keep[:A.nvals] = ~sel_any[a_cols]
    from .tri import csr_filter_lanes
    A_light = _shrink(csr_filter_lanes(A, jnp.asarray(keep)))
    # hand the residual its host pattern (same order as the device
    # compaction) so the sort-merge engine can row-slice the mask
    lk = keep[:A.nvals]
    A_light._options["host_pattern"] = (a_rows[lk], a_cols[lk])
    light_eids = None
    if keep_entry_lists:
        le = np.zeros(A_light.nzmax, np.int32)
        nl = int(lk.sum())
        le[:nl] = np.nonzero(lk)[0]
        light_eids = jnp.asarray(le)
    return BitdotPlan(Apack, Bpack, A_light, levels[0].W, sel_end,
                      covered_all, total - covered_all, tuple(levels),
                      light_eids)


def _shrink(X: CsrMatrix) -> CsrMatrix:
    """Cut a compacted matrix's padded capacity down to its nnz bucket
    so downstream per-entry stages don't pay for the original size."""
    from .esc import _bucket
    cap = _bucket(max(X.nvals, 8), 128)
    if cap >= X.nzmax:
        return X
    vals = jax.tree_util.tree_map(lambda v: v[:cap], X.values)
    return CsrMatrix(X.indptr, X.indices[:cap], X.rowids[:cap], vals,
                     X.nvals, X.nrows, X.ncols, X.type)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _bitdot_jit(nchunk: int, chunk: int, has_amap: bool, has_bmap: bool,
                Apack, Bpack, amap, bmap, rowids, indices, nvals):
    """popcount(Apack[amap[i]] & Bpack[bmap[j]]) per mask entry,
    streamed in bounded-memory chunks via lax.map (ONE program per
    call).  Rows outside the compacted panel (map == -1) own no
    selected bits and contribute 0."""
    na = Apack.shape[0]
    nb = Bpack.shape[0]
    E = nchunk * chunk
    t = jnp.arange(E, dtype=jnp.int32)
    live = t < nvals
    ii = jnp.where(live, jnp.pad(rowids, (0, E - rowids.shape[0]))[:E]
                   .astype(jnp.int32), 0)
    jj = jnp.where(live, jnp.pad(indices, (0, E - indices.shape[0]))[:E]
                   .astype(jnp.int32), 0)
    if has_amap:
        ii = amap[jnp.clip(ii, 0, amap.shape[0] - 1)]
    if has_bmap:
        jj = bmap[jnp.clip(jj, 0, bmap.shape[0] - 1)]
    ok = (ii >= 0) & (jj >= 0) & live
    ii = jnp.clip(ii, 0, na - 1).reshape(nchunk, chunk)
    jj = jnp.clip(jj, 0, nb - 1).reshape(nchunk, chunk)
    okc = ok.reshape(nchunk, chunk)

    def body(args):
        i, j, o = args
        a = jnp.take(Apack, i, axis=0)
        b = jnp.take(Bpack, j, axis=0)
        c = jax.lax.population_count(a & b).astype(jnp.int32)
        return jnp.where(o, jnp.sum(c, axis=1, dtype=jnp.int32), 0)

    return jax.lax.map(body, (ii, jj, okc)).reshape(E)


def _bitdot_pass(Apack, Bpack, amap, bmap, M: CsrMatrix) -> jnp.ndarray:
    """One gather+AND+popcount pass of a packed slab pair over M."""
    from .esc import _bucket
    E = M.nzmax
    W = Apack.shape[1]
    chunk = max(1 << 12, min(_bucket(E, 1 << 12),
                             _CHUNK_WORDS // max(W, 1)))
    nchunk = (E + chunk - 1) // chunk
    dummy = jnp.zeros((1,), jnp.int32)
    return _bitdot_jit(nchunk, chunk, amap is not None, bmap is not None,
                       Apack, Bpack,
                       dummy if amap is None else amap,
                       dummy if bmap is None else bmap,
                       M.rowids, M.indices, M.nvals)[:E]


def _level_live(lv: PackLevel, alive_a, alive_b):
    la = lv.a_slots >= 0
    lb = lv.b_slots >= 0
    if alive_a is not None:
        la = la & alive_a[jnp.clip(lv.a_eids, 0,
                                   alive_a.shape[0] - 1)]
    if alive_b is not None:
        lb = lb & alive_b[jnp.clip(lv.b_eids, 0,
                                   alive_b.shape[0] - 1)]
    return la, lb


def bitdot_counts(plan: BitdotPlan, M: CsrMatrix,
                  alive_a=None, alive_b=None) -> jnp.ndarray:
    """Heavy-slab counts per M padded entry: the cached level-1 panels
    plus one transient build+pass per extra slab (panels freed as soon
    as the pass is enqueued — peak HBM is one extra pair).

    ``alive_a`` / ``alive_b``: optional bool lane masks over A's / B's
    padded entries; dead entries' bits are dropped at (re)pack time
    (requires a plan built with ``keep_entry_lists=True``)."""
    use_alive = alive_a is not None or alive_b is not None
    counts = None
    # large transient panels must not pile up: dispatch is async, so
    # without a drain every level's pair would be live at once (OOM at
    # scale 22).  One scalar pull per level is the FIFO barrier.
    big = max((4 * lv.W * (lv.na + lv.nb) for lv in plan.levels[1:]),
              default=0)
    sync_each = big > (1 << 29)
    for li, lv in enumerate(plan.levels):
        if li == 0 and not use_alive:
            Ap, Bp = plan.Apack, plan.Bpack
        else:
            if lv.a_rows.shape[0] == 0 or (
                    use_alive and lv.a_eids.shape[0] == 0):
                raise ValueError(
                    "liveness re-packing needs a plan built with "
                    "keep_entry_lists=True")
            la, lb = _level_live(lv, alive_a, alive_b)
            Ap = _pack_jit(lv.na, lv.W, lv.a_rows, lv.a_slots, la)
            Bp = _pack_jit(lv.nb, lv.W, lv.b_js, lv.b_slots, lb)
        c = _bitdot_pass(Ap, Bp, lv.amap, lv.bmap, M)
        counts = c if counts is None else counts + c
        if li > 0:
            del Ap, Bp
            if sync_each:
                jax.device_get(counts[0])      # drain the pipeline
    return counts


_NO_PLAN = object()   # cached "don't pack" decision


def _ref(x):
    try:
        return weakref.ref(x)
    except TypeError:                    # buffer type not weakref-able
        return lambda: x


def _auto_budget() -> int:
    """Panel budget bounded by what the device actually has free —
    a fixed budget OOMs when containers/workspace already hold
    several GB (k-truss at scale: the symmetric mask + per-iteration
    rebuilds).  Falls back to the static budget where the device
    reports no memory statistics (the CPU)."""
    try:
        st = jax.local_devices()[0].memory_stats()
        free = int(st["bytes_limit"]) - int(st["bytes_in_use"])
        # leave room for the sort workspace (~2.7 GB at the lane cap)
        # and transient gather chunks
        return max(min(_PANEL_BUDGET, int(free * 0.5)), 1 << 28)
    except Exception:
        return _PANEL_BUDGET


def _cached_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                 budget_bytes: Optional[int] = None
                 ) -> Optional[BitdotPlan]:
    """Per-(M, A, B) pattern plan cache, stored on M like the ESC plan
    cache (``esc.py``): the panels depend only on the operand patterns,
    so repeated calls (bench loops, PageRank-style iteration) skip the
    host selection + pack scatters entirely."""
    entry = M._options.get("bitdot_plan")
    if entry is not None:
        ra, rb, plan = entry
        if ra() is A.indices and rb() is B.indices:
            return None if plan is _NO_PLAN else plan
    if budget_bytes is None:
        budget_bytes = _auto_budget()
    plan = build_bitdot_plan(M, A, B, budget_bytes=budget_bytes)
    M._options["bitdot_plan"] = (_ref(A.indices), _ref(B.indices),
                                 _NO_PLAN if plan is None else plan)
    return plan


def masked_pair_counts_auto(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                            chunk: Optional[int] = None,
                            budget_bytes: Optional[int] = None
                            ) -> jnp.ndarray:
    """counts[e] = (A.B)[i_e, j_e] over PLUS_PAIR, with automatic
    heavy/light splitting (the GB_AxB_select analogue for counting):
    bitmaps for the heavy wedge-middle columns, sort-merge for the
    residual.  Falls back to the pure sort-merge engine when the
    bitmaps can't pay (small graphs, flat wedge profiles)."""
    from .tri import masked_pair_counts, _LANE_CAP
    from ..ops.flopcount import record_axb_method
    kw = {} if chunk is None else {"chunk": chunk}
    plan = _cached_plan(M, A, B, budget_bytes)
    if plan is None:
        counts = masked_pair_counts(M, A, B, **kw)
        record_axb_method("tri:sort_merge")
        return counts
    heavy = bitdot_counts(plan, M)
    if plan.light_lanes == 0 or plan.A_light.nvals == 0:
        record_axb_method("bitdot:full")
        return heavy
    light = masked_pair_counts(M, plan.A_light, B, **kw)
    record_axb_method("bitdot:hybrid")
    return heavy + light
