"""Sort-free masked structural counting on CSR: the large-graph
triangle/k-truss engine.

For counting semirings (PLUS_PAIR / PLUS_LAND on patterns), the masked
product C<M> = A·B needs only, per mask entry e=(i,j), the number of
wedges i -> k -> j.  The ESC engine would sort the expanded lanes by
output coordinate — but the mask's CSR keys are ALREADY sorted, so each
lane can locate its output slot directly by binary search and
segment-add there.  No sort, no n^2, no n^2/32 bitpack: O(flops) gathers
+ O(flops log nnz(M)) compares, chunked so peak memory is bounded.
This is what lets triangle counting run at large scale on one card
where both the bitmap and the bitpacked engines are infeasible;
``chip_smoke.py`` checks it at R-MAT scale 18 on the card.

Reference counterparts: ``Template/GB_AxB_dot_mask.c`` (masked dot),
``Extras/tri/tri_main.c`` (scale ambitions), ``tricount.c`` SandiaDot.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .container import CsrMatrix
from .esc import _bucket

__all__ = ["masked_pair_counts", "tricount_esc", "tricount_auto",
           "tricount_device",
           "tricount_prep_csr", "ktruss_esc", "allktruss_esc",
           "csr_filter_lanes", "csr_tril", "csr_triu"]


#: lanes per dispatch cap: the sort-merge kernel holds ~3 int64 +
#: 2 int32 E-sized arrays plus the sort workspace (~40 B/lane) — 2.7 GB
#: at 2^26.  A memory bound, not a measured optimum on the card.
_LANE_CAP = 1 << 26

#: key sentinel: real keys are i*n+j < 2^62; dead lanes sort last
_BIGKEY = (np.int64(1) << 62) - 1


@partial(jax.jit, static_argnums=(0, 1))
def _counts_jit(E: int, ncolsA: int, nlive,
                a_indices, a_rowids, b_indptr, b_indices,
                m_rowids, m_indices, m_nvals, n_out):
    """One-dispatch masked pair counting built from scans and one sort:

    * per-entry -> per-lane broadcasts use difference-scatter + cumsum
      (a segmented fill-forward built from two streaming primitives),
      NOT per-lane gathers;
    * the only true per-lane gather is ``b_indices[pos]`` (inherently
      random);
    * mask membership + per-entry counting is a SORT-MERGE of the lane
      keys with M's (already sorted) entry keys — the dot-mask probe of
      ``Template/GB_AxB_dot_mask.c`` as one data-parallel sort.

    The caller splits A into contiguous entry blocks when flops exceed
    the lane cap (``GB_AxB_parallel.c:52-59``'s slicing plan).
    """
    nzA = a_indices.shape[0]
    nzB = b_indices.shape[0]
    nzM = m_indices.shape[0]

    # ---- per-entry quantities (nzA-sized, cheap) ----
    degB = b_indptr[1:] - b_indptr[:-1]
    degB_ext = jnp.concatenate([degB, jnp.zeros((1,), jnp.int32)])
    acol = jnp.minimum(a_indices, ncolsA)
    eids = jnp.arange(nzA, dtype=jnp.int32)
    # padded entries hit the sentinel -> 0; entries at/past nlive are
    # the next host block's (fixed-size slices overlap) -> also 0
    lens = jnp.where(eids < nlive, degB_ext[acol], 0)
    csum = jnp.cumsum(lens)
    starts = csum - lens
    total = csum[-1]
    ne = lens > 0
    # compact the nonempty entries so consecutive-diff is well-defined
    rank = jnp.cumsum(ne.astype(jnp.int32)) - 1
    tgt = jnp.where(ne, rank, nzA)
    pos0 = b_indptr[acol] - starts                     # lane pos offset
    ikey = a_rowids.astype(jnp.int64) * n_out           # lane key base
    pos0_c = jnp.zeros((nzA + 1,), jnp.int32).at[tgt].set(
        pos0, mode="drop")
    ikey_c = jnp.zeros((nzA + 1,), jnp.int64).at[tgt].set(
        ikey, mode="drop")
    starts_c = jnp.zeros((nzA + 1,), jnp.int32).at[tgt].set(
        starts, mode="drop")
    pos0_d = pos0_c - jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                       pos0_c[:-1]])
    ikey_d = ikey_c - jnp.concatenate([jnp.zeros((1,), jnp.int64),
                                       ikey_c[:-1]])

    # ---- expansion: scatter diffs at start lanes, cumsum ----
    nne = jnp.sum(ne.astype(jnp.int32))
    lanes_ok = jnp.arange(nzA + 1, dtype=jnp.int32) < nne
    sc_tgt = jnp.where(lanes_ok, starts_c, E)
    pos_lane = jnp.cumsum(jnp.zeros((E + 1,), jnp.int32).at[sc_tgt].add(
        jnp.where(lanes_ok, pos0_d, 0), mode="drop")[:E])
    key_lane = jnp.cumsum(jnp.zeros((E + 1,), jnp.int64).at[sc_tgt].add(
        jnp.where(lanes_ok, ikey_d, 0), mode="drop")[:E])
    t = jnp.arange(E, dtype=jnp.int32)
    live = t < total
    pos = jnp.clip(pos_lane + t, 0, nzB - 1)
    j = b_indices[pos]                                   # THE gather
    key = jnp.where(live, key_lane + j, _BIGKEY)

    # ---- sort-merge with M's keys ----
    lane_m = jnp.arange(nzM)
    m_live = lane_m < m_nvals
    m_keys = jnp.where(m_live,
                       m_rowids.astype(jnp.int64) * n_out + m_indices,
                       _BIGKEY)
    # tag: m entries even, lanes odd -> m sorts before its lanes
    allk = jnp.concatenate([m_keys * 2, key * 2 + 1])
    pay = jnp.concatenate([lane_m.astype(jnp.int32),
                           jnp.full((E,), nzM, jnp.int32)])
    sk, sp = jax.lax.sort((allk, pay), num_keys=1)
    is_m = sp < nzM
    run = jax.lax.cummax(jnp.where(is_m, sk, jnp.int64(-1)))
    match = (~is_m) & (sk < _BIGKEY * 2) & (sk == run + 1)
    cnt0 = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(match.astype(jnp.int32))])
    # sorted position of each live m entry: m keys are unique and
    # already in CSR order, so sorted m-rank == m entry id
    N = nzM + E
    mrank = jnp.cumsum(is_m.astype(jnp.int32)) - 1
    mpos = jnp.zeros((nzM + 1,), jnp.int32).at[
        jnp.where(is_m, jnp.minimum(mrank, nzM), nzM)].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop")[:nzM]
    nxt = jnp.concatenate([mpos[1:], jnp.full((1,), N, jnp.int32)])
    # padded m entries share the BIGKEY*2 key; their ranges contain no
    # matches (dead lanes fail the sk < BIGKEY*2 test)
    counts = cnt0[nxt] - cnt0[mpos]
    return jnp.where(m_live, counts, 0).astype(jnp.int32)


@partial(jax.jit, static_argnums=(2,))
def _entry_flops_csum(a_indices, b_indptr, ncolsA: int):
    """int64 cumulative flop count per A entry (padded entries are 0)."""
    degB = b_indptr[1:] - b_indptr[:-1]
    degB_ext = jnp.concatenate([degB, jnp.zeros((1,), jnp.int32)])
    lens = degB_ext[jnp.minimum(a_indices, ncolsA)]
    return jnp.cumsum(lens.astype(jnp.int64))


@jax.jit
def _flops_and_maxdeg(a_indices, a_live, b_indptr, m_indptr, ncolsA):
    degB = b_indptr[1:] - b_indptr[:-1]
    degB_ext = jnp.concatenate([degB, jnp.zeros((1,), jnp.int32)])
    lens = degB_ext[jnp.minimum(a_indices, ncolsA)]
    flops = jnp.sum(jnp.where(a_live, lens, 0).astype(jnp.int64))
    maxdeg = jnp.max(m_indptr[1:] - m_indptr[:-1])
    return flops, maxdeg


def masked_pair_counts(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                       chunk: int = _LANE_CAP) -> jnp.ndarray:
    """counts[e] = (A·B)[i_e, j_e] over PLUS_PAIR for every entry e of M
    (aligned with M's padded CSR entry order; padded slots 0).

    ``chunk`` caps the expanded lanes per device dispatch; when the
    total flop count exceeds it, A is split on the host into contiguous
    entry blocks at flop-balanced boundaries (the slicing-by-flops plan
    of ``GB_AxB_parallel.c:52-59``) and the per-block counts are summed
    on device.  No 2^31 flop ceiling."""
    m, k = A.shape
    n = B.ncols
    if M.shape != (m, n):
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(f"mask {M.shape} vs product {(m, n)}")
    a_live = jnp.arange(A.nzmax) < A.nvals
    fl, md = _flops_and_maxdeg(A.indices, a_live, B.indptr, M.indptr, k)
    flops = int(fl)
    if flops == 0 or M.nvals == 0:
        return jnp.zeros((M.nzmax,), jnp.int32)
    cap = max(min(chunk, _LANE_CAP), 1 << 14)
    if flops <= cap:
        return _counts_jit(_bucket(flops, 1 << 14), k, A.nzmax,
                           A.indices, A.rowids, B.indptr, B.indices,
                           M.rowids, M.indices, M.nvals, n)

    # Host split: contiguous A-entry blocks of <= cap lanes each (a
    # block is never empty, so a single pathological entry with more
    # than `cap` lanes still goes through as its own dispatch).
    csum = np.asarray(_entry_flops_csum(A.indices, B.indptr, k))
    nz = A.nzmax
    bounds = [0]
    prev = 0
    while bounds[-1] < nz and prev < flops:
        s = bounds[-1]
        nxt = int(np.searchsorted(csum, prev + cap, side="right"))
        nxt = min(max(nxt, s + 1), nz)
        bounds.append(nxt)
        prev = int(csum[nxt - 1])
    blocks = list(zip(bounds[:-1], bounds[1:]))
    L = _bucket(max(e - s for s, e in blocks), 1 << 14)
    # sentinel-padded bases so fixed-size dynamic slices never wrap
    ai = jnp.concatenate([A.indices, jnp.full((L,), k, A.indices.dtype)])
    ar = jnp.concatenate([A.rowids, jnp.full((L,), m, A.rowids.dtype)])

    # mask row-slicing (round 4): a block covers a contiguous A-entry
    # (= row) range, and counts can only land on mask entries in those
    # rows — so each dispatch sorts only the mask SLICE, not all of M.
    # At scale 22 this is the difference between every dispatch
    # re-sorting 128 M mask keys and sorting ~E/nblocks of them.
    hpA = A._options.get("host_pattern")
    hpM = M._options.get("host_pattern")
    counts = jnp.zeros((M.nzmax + 1,), jnp.int32)
    use_slice = hpA is not None and hpM is not None and len(blocks) > 1
    if use_slice:
        a_rows_h = np.asarray(hpA[0][:A.nvals])
        m_rows_h = np.asarray(hpM[0][:M.nvals])
        mi_pad = jnp.concatenate([M.indices,
                                  jnp.full((M.nzmax,), n,
                                           M.indices.dtype)])
        mr_pad = jnp.concatenate([M.rowids,
                                  jnp.full((M.nzmax,), m,
                                           M.rowids.dtype)])
    for s, e in blocks:
        blk_flops = int(csum[e - 1]) - (int(csum[s - 1]) if s else 0)
        if blk_flops == 0:
            continue
        E = _bucket(blk_flops, 1 << 14)
        abk = jax.lax.dynamic_slice(ai, (s,), (L,))
        rbk = jax.lax.dynamic_slice(ar, (s,), (L,))
        if use_slice:
            r0 = a_rows_h[min(s, A.nvals - 1)]
            r1 = a_rows_h[min(e - 1, A.nvals - 1)]
            ms = int(np.searchsorted(m_rows_h, r0, side="left"))
            me = int(np.searchsorted(m_rows_h, r1, side="right"))
            if me == ms:
                continue
            Lm = min(_bucket(me - ms, 1 << 12), M.nzmax)
            seg = _counts_jit(
                E, k, e - s, abk, rbk, B.indptr, B.indices,
                jax.lax.dynamic_slice(mr_pad, (ms,), (Lm,)),
                jax.lax.dynamic_slice(mi_pad, (ms,), (Lm,)),
                me - ms, n)
            counts = counts.at[ms + jnp.arange(Lm)].add(
                seg, mode="drop")
        else:
            counts = counts.at[:M.nzmax].add(_counts_jit(
                E, k, e - s, abk, rbk,
                B.indptr, B.indices, M.rowids, M.indices, M.nvals, n))
    return counts[:M.nzmax]


def tricount_esc(L: CsrMatrix, U: Optional[CsrMatrix] = None,
                 chunk: int = _LANE_CAP) -> int:
    """Sandia triangle count at CSR scale: ntri = sum over (i,j) in L of
    (L·U)[i,j]; with ``U=None`` uses the pure-Sandia form (L·L).<L.
    Routes through the heavy/light bitdot split (:mod:`bitdot`) so
    power-law graphs run at bitmap speed, any-structure residual at
    sort-merge speed."""
    from .bitdot import masked_pair_counts_auto
    B = U if U is not None else L
    counts = masked_pair_counts_auto(L, L, B, chunk)
    return int(jnp.sum(counts.astype(jnp.int64)))


def tricount_device(L: CsrMatrix, U: Optional[CsrMatrix] = None,
                    chunk: int = _LANE_CAP):
    """Sandia triangle count returning a DEVICE 0-d int64 array — no
    host pull.  Callers batch N graphs' counts and pull once: one
    host round trip for N results instead of N.  ``int(...)`` or
    ``np.asarray`` on the result is the completion barrier."""
    from .bitdot import masked_pair_counts_auto
    B = U if U is not None else L
    counts = masked_pair_counts_auto(L, L, B, chunk)
    return jnp.sum(counts.astype(jnp.int64))


def tricount_auto(L: CsrMatrix, U: CsrMatrix) -> int:
    """SandiaDot triangle count with engine auto-select (the
    GB_AxB_select analogue at algorithm level):

      1. window-panel engine (:mod:`window`) — banded/clustered graphs:
         one dense contraction per 128-row block, mask fused (the
         Pallas Triton kernel on the GPU, its XLA form elsewhere)
      2. bitdot popcount panels + sort-merge residual — any structure

    Engine recorded in ``last_axb_method``."""
    from ..platform import triton_kernels
    from .window import (build_window_plan, window_count_sum_triton,
                         window_masked_count_sum)
    wplan = build_window_plan(L, U, L)
    if wplan is None:
        return tricount_esc(L, U)
    if triton_kernels():
        return int(window_count_sum_triton(wplan))
    return int(window_masked_count_sum(wplan))


@partial(jax.jit, static_argnums=(0, 1, 2))
def _filter_jit(nzmax: int, nrows: int, ncols: int,
                indices, rowids, values, keep):
    r = (jnp.cumsum(keep) - 1).astype(jnp.int32)
    nnz = jnp.sum(keep).astype(jnp.int32)
    tgt = jnp.where(keep, r, nzmax + 1)
    ni = jnp.full((nzmax + 2,), ncols, indices.dtype).at[tgt].set(
        indices, mode="drop")[:nzmax]
    nr = jnp.full((nzmax + 2,), nrows, rowids.dtype).at[tgt].set(
        rowids, mode="drop")[:nzmax]
    nv = jax.tree_util.tree_map(
        lambda v: jnp.zeros((nzmax + 2,), v.dtype).at[tgt].set(
            v, mode="drop")[:nzmax], values)
    counts = jax.ops.segment_sum(
        keep.astype(jnp.int32), jnp.minimum(rowids, nrows),
        num_segments=nrows + 1)
    indptr = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(counts[:nrows]).astype(jnp.int32)])
    return indptr, ni, nr, nv, nnz


def csr_filter_lanes(A: CsrMatrix, keep) -> CsrMatrix:
    """Device-side entry filter: keep[e] over A's padded entry order ->
    compacted CsrMatrix (the in-place prune of GB_select, sparse form)."""
    keep = jnp.asarray(keep, bool) & (jnp.arange(A.nzmax) < A.nvals)
    indptr, ni, nr, nv, nnz = _filter_jit(
        A.nzmax, A.nrows, A.ncols, A.indices, A.rowids, A.values, keep)
    return CsrMatrix(indptr, ni, nr, nv, int(nnz), A.nrows, A.ncols,
                     A.type)


def csr_tril(A: CsrMatrix, k: int = -1) -> CsrMatrix:
    """Entries on/below diagonal k (GxB_TRIL at CSR scale, no densify)."""
    d = A.indices.astype(jnp.int64) - A.rowids.astype(jnp.int64)
    return csr_filter_lanes(A, d <= k)


def csr_triu(A: CsrMatrix, k: int = 1) -> CsrMatrix:
    """Entries on/above diagonal k (GxB_TRIU at CSR scale)."""
    d = A.indices.astype(jnp.int64) - A.rowids.astype(jnp.int64)
    return csr_filter_lanes(A, d >= k)


@partial(jax.jit, static_argnums=(0,))
def _compact_lanes_jit(nz: int, vals, keep):
    """Compact vals[keep] to the front (same order csr_filter_lanes
    uses), zeros elsewhere."""
    r = (jnp.cumsum(keep) - 1).astype(jnp.int32)
    tgt = jnp.where(keep, r, nz + 1)
    return jnp.zeros((nz + 2,), vals.dtype).at[tgt].set(
        vals, mode="drop")[:nz]


def ktruss_esc(A: CsrMatrix, k: int, chunk: int = _LANE_CAP,
               max_iters: int = 1000,
               budget_bytes: Optional[int] = None
               ) -> Tuple[CsrMatrix, jnp.ndarray, int]:
    """Sparse k-truss at CSR scale (``ktruss_graphblas.c:10-136`` loop):
    support[e] = |N(i) ∩ N(j)| within the truss; prune support < k-2;
    repeat to fixpoint.  Returns (truss CsrMatrix, per-entry supports
    aligned to its padded order, nsteps).

    **Incremental** (round 5): the truss only shrinks, so the bitdot
    plan is built ONCE on the full graph (``keep_entry_lists=True``)
    and each sweep re-packs the cached slabs under a per-entry
    liveness mask + filters the light residual on device — no host
    re-selection, no per-sweep pack-scatter plan rebuild (a full host
    argsort + pack scatters per sweep)."""
    if k < 3:
        raise ValueError("k must be >= 3")
    if A.nvals == 0:
        return A, jnp.zeros((A.nzmax,), jnp.int32), 0
    from .bitdot import _auto_budget, bitdot_counts, build_bitdot_plan
    if budget_bytes is None:
        budget_bytes = min(_auto_budget(), 2 << 30)
    plan = build_bitdot_plan(A, A, A, budget_bytes=budget_bytes,
                             keep_entry_lists=True)
    from ..ops.flopcount import record_axb_method
    if plan is None:
        return _ktruss_sort_merge(A, k, chunk, max_iters)
    record_axb_method("bitdot:ktruss_incremental")
    lane = jnp.arange(A.nzmax)
    alive = lane < A.nvals
    light_lane = (jnp.arange(plan.A_light.nzmax) < plan.A_light.nvals
                  if plan.A_light.nvals else None)
    last = A.nvals
    nsteps = 0
    counts = jnp.zeros((A.nzmax,), jnp.int32)
    while nsteps < max_iters:
        nsteps += 1
        counts = bitdot_counts(plan, A, alive_a=alive, alive_b=alive)
        if plan.A_light.nvals:
            al = alive[jnp.clip(plan.light_eids, 0, A.nzmax - 1)]
            A_l = csr_filter_lanes(plan.A_light, al & light_lane)
            if A_l.nvals:
                B_l = csr_filter_lanes(A, alive)
                counts = counts + masked_pair_counts(A, A_l, B_l, chunk)
        keep = alive & (counts >= (k - 2))
        nk = int(jnp.sum(keep))
        if nk == last:
            break
        alive, last = keep, nk
        if nk == 0:
            break
    truss = csr_filter_lanes(A, alive)
    sup = _compact_lanes_jit(A.nzmax, counts, alive)
    return truss, sup, nsteps


def _ktruss_sort_merge(A: CsrMatrix, k: int, chunk: int,
                       max_iters: int) -> Tuple[CsrMatrix, jnp.ndarray,
                                                int]:
    """Small/flat-graph fallback: per-sweep sort-merge counting on the
    shrinking truss (one cheap dispatch per sweep at this size)."""
    last = A.nvals
    nsteps = 0
    counts = jnp.zeros((A.nzmax,), jnp.int32)
    while nsteps < max_iters:
        nsteps += 1
        counts = masked_pair_counts(A, A, A, chunk)
        keep = counts >= (k - 2)
        B = csr_filter_lanes(A, keep)
        if B.nvals == last:
            # nothing pruned: B's lanes coincide with A's, so the
            # supports just computed are already aligned with B
            return B, counts, nsteps
        A, last = B, B.nvals
        if last == 0:
            return A, jnp.zeros((A.nzmax,), jnp.int32), nsteps
    return A, counts, nsteps


def allktruss_esc(A: CsrMatrix, kmax: Optional[int] = None,
                  chunk: int = _LANE_CAP) -> dict:
    """All-k-truss sweep at CSR scale (``Extras/ktruss/allktruss.c``):
    k = 3.. until the truss is empty, reusing the (k-1)-truss as the
    next starting point.  Returns {k: {nedges, nsteps, nt}}."""
    out = {}
    C = A
    k = 3
    while kmax is None or k <= kmax:
        C, counts, nsteps = ktruss_esc(C, k, chunk)
        total = int(jnp.sum(counts.astype(jnp.int64)))
        out[k] = {"nedges": C.nvals // 2, "nsteps": nsteps,
                  "nt": total // 6}
        if C.nvals == 0:
            break
        k += 1
    return out


def tricount_prep_csr(A: CsrMatrix):
    """Degree-ascending relabel + L/U split (the reference's
    ``tri_prep.c`` / ``tricount.c`` prep): returns (L, U) of the
    permuted graph.  For power-law graphs this shrinks the SandiaDot
    wedge count by orders of magnitude (each edge is oriented from the
    lower-degree endpoint), which is what makes large-scale counting
    tractable."""
    hp = A._options.get("host_pattern")
    if hp is not None:
        I = np.asarray(hp[0][:A.nvals])
        J = np.asarray(hp[1][:A.nvals])
    else:
        I, J, _ = A.extractTuples()
        I, J = np.asarray(I), np.asarray(J)
    n = A.nrows
    deg = np.bincount(I, minlength=n)
    perm = np.argsort(deg, kind="stable")     # old ids in new order
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)
    In, Jn = rank[I], rank[J]
    lo = In > Jn
    up = In < Jn
    ones = np.ones(int(lo.sum()), bool)
    L = CsrMatrix.from_coo(In[lo], Jn[lo], ones, n, n,
                           type=A.type if A.type.is_bool else A.type,
                           sum_duplicates=False)
    ones = np.ones(int(up.sum()), bool)
    U = CsrMatrix.from_coo(In[up], Jn[up], ones, n, n,
                           type=A.type if A.type.is_bool else A.type,
                           sum_duplicates=False)
    return L, U
