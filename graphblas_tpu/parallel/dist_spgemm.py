"""Sharded-CSR masked SpGEMM: B slabs rotate around a ring of devices.

C<M> = A *.sr* B with A, B, and M all row-slabbed over a 1-D mesh at
O(nnz/d) per device.  Each of the d steps, every device computes the
partial products its A slab forms against the B slab it currently
holds, folds them into its mask-aligned accumulator with the add
monoid, and ``ppermute``s the B slab to its ring neighbour — the
classic systolic SpGEMM, with the per-step compute expressed as the
same chunked lane expansion + mask binary search as the single-chip
counting engine (:mod:`graphblas_tpu.sparse.tri`).

This is SURVEY §7 step 8's "distributed masked SpGEMM (halo exchange of
B rows ..., overlap with local compute)": the halo exchange is the ring
rotation, and because the add monoid is associative/commutative the
partial folds across steps commute with the within-step folds.

The reference never built this (``GB_AxB_parallel.c:52-74`` is the
stubbed slice design); the MPI extra (``kron_mpi.c``) has zero
communication.  Add monoids with a native scatter fold
(PLUS/MIN/MAX/TIMES/LOR/LAND) use it; ANY other associative monoid
(LXOR/EQ/user) falls back to a per-chunk sort + associative-scan
segment fold (round 3).  Any multiply op works.  ``dist_spgemm`` is the
UNMASKED variant: per-device product lanes accumulate into a capacity-
bounded buffer and one ESC-style sort-dedup emits the local slab.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.semirings import Semiring
from ..core.types import cast as gbcast
from ..sparse.container import CsrMatrix, csr_from_coo
from .dist_csr import dist_csr_from_matrix
from .mesh import make_mesh, pad_to_multiple

__all__ = ["dist_masked_spgemm", "dist_spgemm", "dist_tricount_csr"]

# add monoids with a jnp scatter fold (GB_assoc_template switch factory,
# scatter form); others would need a sort per step — not offered yet
_SCATTER_FOLDS = {
    "PLUS": lambda acc, tgt, z: acc.at[tgt].add(z, mode="drop"),
    "TIMES": lambda acc, tgt, z: acc.at[tgt].multiply(z, mode="drop"),
    "MIN": lambda acc, tgt, z: acc.at[tgt].min(z, mode="drop"),
    "MAX": lambda acc, tgt, z: acc.at[tgt].max(z, mode="drop"),
    "LOR": lambda acc, tgt, z: acc.at[tgt].max(z, mode="drop"),
    "LAND": lambda acc, tgt, z: acc.at[tgt].min(z, mode="drop"),
}


def _slab_mask_keys(M: CsrMatrix, d: int, blk: int, kdt
                    ) -> Tuple[np.ndarray, list]:
    """Row-slab M into per-device sorted local keys [d, nzpad]; also
    return the per-slab global (I, J) tuples for output assembly."""
    I, J, _ = M.extractTuples()
    n = M.ncols
    big = np.iinfo(np.dtype(kdt)).max
    dev = (I // blk).astype(np.int64)
    nz_per = np.bincount(dev, minlength=d)
    nzpad = pad_to_multiple(max(int(nz_per.max()), 8), 128)
    keys = np.full((d, nzpad), big, np.dtype(kdt))
    tuples = []
    for p in range(d):
        sel = dev == p
        Ip, Jp = I[sel], J[sel]
        k = len(Ip)
        keys[p, :k] = (Ip - p * blk).astype(np.dtype(kdt)) * n \
            + Jp.astype(np.dtype(kdt))
        tuples.append((Ip, Jp))
    return keys, tuples


def _as_csr(A) -> CsrMatrix:
    if isinstance(A, CsrMatrix):
        return A
    return CsrMatrix.from_matrix(A.wait())


_PROG_CACHE = {}


def _spgemm_prog(mesh: Mesh, sr: Semiring, d: int, blkA: int, blkB: int,
                 n: int, chunk: int, kdt, zdt, maxE: int):
    key = (id(mesh), sr, d, blkA, blkB, n, chunk, np.dtype(kdt).name,
           np.dtype(zdt).name, maxE)
    f = _PROG_CACHE.get(key)
    if f is not None:
        return f

    fold = _SCATTER_FOLDS.get(sr.add.op.name)
    ident = sr.add.identity
    big = np.iinfo(np.dtype(kdt)).max

    def local(a_idx, a_loc, a_val, offs, slab_starts, b_rowptr, b_idx,
              b_val, m_keys):
        # a_* are K-SORTED local entries; offs[s] bounds the contiguous
        # range whose k falls in B slab s, so each ring step touches
        # O(maxE) entries, not O(nzA) — the weak-scaling contract
        # (each device does O(local flops + maxE·d) total work, flat
        # at fixed per-device size; round-3's full rescan was O(nzA·d))
        a_idx, a_loc, a_val = a_idx[0], a_loc[0], a_val[0]
        offs = offs[0]
        b_rowptr, b_idx, b_val = b_rowptr[0], b_idx[0], b_val[0]
        # replicated (d+1,) slab start rows: flop-balanced partitions
        # make these non-uniform
        m_keys = m_keys[0]
        nzB = b_idx.shape[0]
        nzM = m_keys.shape[0]
        pidx = jax.lax.axis_index("i")
        av = gbcast(a_val, sr.xtype)
        # the accumulators start replicated but the fold depends on the
        # device index — mark them mesh-varying for the scan carry
        acc = jax.lax.pcast(jnp.full((nzM + 1,), ident, zdt),
                            ("i",), to="varying")
        npres = jax.lax.pcast(jnp.zeros((nzM + 1,), jnp.int32),
                              ("i",), to="varying")

        def step(s, carry):
            b_rowptr, b_idx, b_val, acc, npres = carry
            slab = ((pidx - s) % d).astype(jnp.int32)
            base = slab_starts[slab]
            lo = offs[slab]
            cnt = offs[slab + 1] - lo
            ai = jax.lax.dynamic_slice(a_idx, (lo,), (maxE,))
            al = jax.lax.dynamic_slice(a_loc, (lo,), (maxE,))
            avs = jax.tree_util.tree_map(
                lambda v: jax.lax.dynamic_slice(v, (lo,), (maxE,)), av)
            live = jnp.arange(maxE, dtype=jnp.int32) < cnt
            kk = ai - base
            valid = live & (kk >= 0) & (kk < blkB)
            kkc = jnp.clip(kk, 0, blkB - 1)
            # int32 lane arithmetic (half the bytes of a 64-bit
            # cumsum); per-device per-step flops < 2^31 is a
            # non-binding limit at any practical chunking
            deg = jnp.where(
                valid, b_rowptr[kkc + 1] - b_rowptr[kkc],
                jnp.int32(0))
            csum = jnp.cumsum(deg)
            total = csum[-1]
            nch = (total + chunk - 1) // chunk

            bv = gbcast(b_val, sr.ytype)

            def chunk_body(c, st):
                acc, npres = st
                t = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
                e = jnp.searchsorted(csum, t, side="right")
                lv = t < total
                ec = jnp.minimum(e, maxE - 1)
                start = csum[ec] - deg[ec]
                l = t - start
                pos = jnp.clip(b_rowptr[kkc[ec]] + l, 0, nzB - 1)
                i_loc = al[ec]
                j = b_idx[pos]
                keyv = jnp.where(
                    lv, i_loc.astype(kdt) * n + j.astype(kdt),
                    jnp.asarray(big, kdt))
                idx = jnp.searchsorted(m_keys, keyv)
                idxc = jnp.minimum(idx, nzM - 1)
                member = (m_keys[idxc] == keyv) & lv
                z = sr.mult(avs[ec], bv[pos])
                z = jnp.where(member, z.astype(zdt),
                              jnp.asarray(ident, zdt))
                tgt = jnp.where(member, idxc, nzM)
                if fold is not None:
                    acc2 = fold(acc, tgt, z)
                else:
                    # generic associative monoid: sort the chunk by
                    # target, segment-fold with the scan, combine
                    # elementwise (identity-washed slots are no-ops)
                    from ..sparse.spmv import segment_reduce_sorted
                    tgt_s, z_s = jax.lax.sort((tgt, z), num_keys=1)
                    fresh = segment_reduce_sorted(
                        sr.add.op, ident, z_s, tgt_s, nzM + 1)
                    # ops on staged dtypes (bool->uint8) may return
                    # bool — pin the carry dtype
                    acc2 = jnp.asarray(sr.add.op(acc, fresh),
                                       zdt)
                return acc2, \
                    npres.at[tgt].add(member.astype(jnp.int32),
                                      mode="drop")

            acc, npres = jax.lax.fori_loop(0, nch, chunk_body,
                                           (acc, npres))
            perm = [(k, (k + 1) % d) for k in range(d)]
            b_rowptr = jax.lax.ppermute(b_rowptr, "i", perm)
            b_idx = jax.lax.ppermute(b_idx, "i", perm)
            b_val = jax.lax.ppermute(b_val, "i", perm)
            return b_rowptr, b_idx, b_val, acc, npres

        _, _, _, acc, npres = jax.lax.fori_loop(
            0, d, step, (b_rowptr, b_idx, b_val, acc, npres))
        return acc[None, :nzM], npres[None, :nzM]

    f = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None),) * 4 + (P(),) + (P("i", None),) * 4,
        out_specs=(P("i", None), P("i", None))))
    _PROG_CACHE[key] = f
    return f


def _balanced_boundaries(w: np.ndarray, d: int, npad: int) -> np.ndarray:
    """Cut [0, len(w)) into d contiguous slabs of ~equal total weight
    (the flop-balanced slicing the reference planned in
    ``GB_AxB_parallel.c:52-59`` and never built).  Returns int64
    boundaries of length d+1 with bnd[-1] = npad."""
    cs = np.concatenate([[0], np.cumsum(w, dtype=np.float64)])
    total = cs[-1]
    if total <= 0:
        bnd = np.linspace(0, npad, d + 1).astype(np.int64)
        bnd[0], bnd[-1] = 0, npad
        return bnd
    bnd = np.searchsorted(cs, total * np.arange(d + 1) / d)
    bnd = np.minimum(bnd, len(w)).astype(np.int64)
    bnd[0] = 0
    bnd[-1] = npad
    bnd = np.maximum.accumulate(bnd)
    return bnd


def _ksorted_slabs(A: CsrMatrix, d: int, blkA: int, bndB: np.ndarray,
                   degB: np.ndarray):
    """Host plan for the ring schedule: per-device A entries sorted by
    contraction column k, with per-(device, B-slab) offsets and flop
    counts.  Returns (a_idx, a_loc, a_val, offs[d, d+1], maxE,
    max_step_flops) — the static shapes that bound each ring step."""
    from ..sparse.esc import _bucket
    I, J, X = A.extractTuples()
    I = np.asarray(I).astype(np.int64)
    J = np.asarray(J).astype(np.int64)
    tmap = jax.tree_util.tree_map
    X = tmap(np.asarray, X)
    dev = I // blkA
    loc = (I % blkA).astype(np.int32)
    order = np.lexsort((I, J, dev))
    I, J, loc, dev = I[order], J[order], loc[order], dev[order]
    X = tmap(lambda v: v[order], X)
    slab = np.minimum(np.searchsorted(bndB[1:], J, side="right"), d - 1)
    offs = np.zeros((d, d + 1), np.int32)
    counts = np.zeros((d, d), np.int64)
    flops = np.zeros((d, d), np.int64)
    dstart = np.searchsorted(dev, np.arange(d + 1))
    fl = degB[J]
    flc = np.concatenate([[0], np.cumsum(fl)])
    for p in range(d):
        s0, s1 = dstart[p], dstart[p + 1]
        cuts = s0 + np.searchsorted(slab[s0:s1], np.arange(d + 1))
        counts[p] = np.diff(cuts)
        flops[p] = flc[cuts[1:]] - flc[cuts[:-1]]
        offs[p, 1:] = np.cumsum(counts[p])
    maxE = _bucket(max(int(counts.max()) if counts.size else 1, 8), 128)
    # rows padded by maxE so the per-step dynamic_slice never clamps
    # (a clamped start would misalign the live mask with the entries)
    nzpad = pad_to_multiple(
        max(int((dstart[1:] - dstart[:-1]).max()) if d else 8, 8),
        128) + maxE
    ncols = A.ncols
    a_idx = np.full((d, nzpad), ncols, np.int32)
    a_loc = np.full((d, nzpad), blkA, np.int32)

    def _stage(dt):
        return np.uint8 if np.dtype(dt) == np.bool_ else np.dtype(dt)
    a_val = tmap(lambda v: np.zeros((d, nzpad), _stage(v.dtype)), X)
    for p in range(d):
        s0, s1 = dstart[p], dstart[p + 1]
        kcnt = s1 - s0
        a_idx[p, :kcnt] = J[s0:s1]
        a_loc[p, :kcnt] = loc[s0:s1]

        def fill(dst, src):
            dst[p, :kcnt] = src[s0:s1]
        tmap(fill, a_val, X)
    return (a_idx, a_loc, a_val, offs, maxE,
            int(flops.max()) if flops.size else 0)


def dist_masked_spgemm(sr: Semiring, A, B, M,
                       mesh: Optional[Mesh] = None,
                       chunk: int = 1 << 18) -> CsrMatrix:
    """C<M> = A *.sr* B over the mesh; A/B/M row-slabbed, B ring-
    rotated; returns the assembled CsrMatrix (pattern = mask entries
    that received at least one product, GraphBLAS product-pattern
    semantics)."""
    mesh = mesh or make_mesh()
    d = int(np.prod(mesh.devices.shape))
    A = _as_csr(A)
    B = _as_csr(B)
    M = _as_csr(M)
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if M.shape != (m, n):
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(f"mask {M.shape} vs product {(m, n)}")
    blkA = pad_to_multiple(max(m, 1), d) // d
    kdt = jnp.int32 if (blkA + 1) * n < (1 << 31) else jnp.int64
    m_keys_np, m_tuples = _slab_mask_keys(M, d, blkA, kdt)
    sh = NamedSharding(mesh, P("i", None))
    m_keys = jax.device_put(jnp.asarray(m_keys_np), sh)

    # host ring plan: B slabs cut at EQUAL FLOP WEIGHT (every ring step
    # is a barrier, so a hub-heavy uniform slab would cost
    # d * max-slab-flops in total), then per-device k-sorted A entries
    # + per-slab offsets (each step touches O(maxE) entries, and the
    # chunk is sized to the true max per-step flop count)
    degB = np.diff(np.asarray(B.indptr)).astype(np.int64)
    if degB.shape[0] < k:
        degB = np.concatenate([degB, np.zeros(k - degB.shape[0],
                                              np.int64)])
    hpA = A._options.get("host_pattern")
    if hpA is not None:
        indegA = np.bincount(np.asarray(hpA[1][:A.nvals]), minlength=k)
    else:
        av_live = np.asarray(A.indices[:A.nvals])
        indegA = np.bincount(av_live, minlength=k)
    kpad = pad_to_multiple(max(k, 1), d)
    bndB = _balanced_boundaries(degB * indegA[:k], d, kpad)
    DB = dist_csr_from_matrix(B, mesh, boundaries=bndB)
    blkB = DB.blk
    from ..sparse.esc import _bucket
    a_idx_np, a_loc_np, a_val_np, offs_np, maxE, max_fl = \
        _ksorted_slabs(A, d, blkA, bndB, degB)
    chunk = min(chunk, _bucket(max(max_fl, 1 << 12)))
    tmap = jax.tree_util.tree_map
    a_idx = jax.device_put(jnp.asarray(a_idx_np), sh)
    a_loc = jax.device_put(jnp.asarray(a_loc_np), sh)
    a_val = tmap(lambda v: jax.device_put(jnp.asarray(v), sh), a_val_np)
    offs = jax.device_put(jnp.asarray(offs_np), sh)
    starts = jnp.asarray(bndB, jnp.int32)

    zdt = np.dtype(sr.ztype.dtype)
    if zdt == np.bool_:
        zdt = np.uint8  # staged; cast back at assembly
    prog = _spgemm_prog(mesh, sr, d, blkA, blkB, n, chunk, kdt, zdt,
                        maxE)
    from . import introspect
    introspect.record("dist_masked_spgemm", prog,
                      (a_idx, a_loc, a_val, offs, starts,
                       DB.rowptr, DB.indices, DB.values, m_keys))
    acc, npres = prog(a_idx, a_loc, a_val, offs, starts,
                      DB.rowptr, DB.indices, DB.values, m_keys)

    # device-side assembly (VERDICT r2 next #8: no per-device host
    # loop): the mask's live entries are slab-major in the SAME order
    # as M's CSR entries, so one device gather aligns the folded
    # values/presence with M's padded arrays and the device-side lane
    # filter compacts the result — the output never round-trips as
    # per-slab Python lists.
    nzpad = acc.shape[1]
    slab_of = np.concatenate(
        [np.full(len(t[0]), p, np.int64) for p, t in enumerate(m_tuples)]
    ) if m_tuples else np.zeros(0, np.int64)
    slot_of = np.concatenate(
        [np.arange(len(t[0]), dtype=np.int64) for t in m_tuples]
    ) if m_tuples else np.zeros(0, np.int64)
    flat = jnp.asarray(slab_of * nzpad + slot_of)
    nz = int(flat.shape[0])
    vals = jnp.take(acc.reshape(-1), flat).astype(sr.ztype.dtype)
    pres = jnp.take(npres.reshape(-1), flat) > 0
    # align with M's padded entry order and filter device-side
    pad = M.nzmax - nz
    vals = jnp.concatenate([vals, jnp.zeros((max(pad, 0),), vals.dtype)])
    pres = jnp.concatenate([pres, jnp.zeros((max(pad, 0),), bool)])
    from ..sparse.tri import csr_filter_lanes
    C = CsrMatrix(M.indptr, M.indices, M.rowids, vals[:M.nzmax],
                  M.nvals, m, n, sr.ztype)
    return csr_filter_lanes(C, pres[:M.nzmax])


def dist_tricount_csr(A, mesh: Optional[Mesh] = None,
                      chunk: int = 1 << 18) -> int:
    """Distributed Sandia triangle count on CSR slabs:
    ntri = reduce(+, (L *.plus_pair* L)<L>) over the mesh."""
    from ..core.semirings import semiring
    from ..core.types import INT32
    from ..sparse.tri import csr_tril
    L = csr_tril(_as_csr(A))
    C = dist_masked_spgemm(semiring.plus_pair[INT32], L, L, L,
                           mesh=mesh, chunk=chunk)
    vals = np.asarray(C.values)[:C.nvals]
    return int(vals.astype(np.int64).sum())


# ---------------------------------------------------------------------------
# Unmasked distributed SpGEMM (VERDICT round-2 next #8)
# ---------------------------------------------------------------------------

def _unmasked_prog(mesh: Mesh, sr: Semiring, d: int, blkA: int,
                   blkB: int, n: int, chunk: int, Lcap: int, kdt, zdt):
    key = ("unmasked", id(mesh), sr, d, blkA, blkB, n, chunk, Lcap,
           np.dtype(kdt).name, np.dtype(zdt).name)
    f = _PROG_CACHE.get(key)
    if f is not None:
        return f
    ident = sr.add.identity
    big = np.iinfo(np.dtype(kdt)).max

    def local(a_idx, a_loc, a_val, b_rowptr, b_idx, b_val, offs):
        from ..sparse.spmv import segment_reduce_sorted
        a_idx, a_loc, a_val = a_idx[0], a_loc[0], a_val[0]
        b_rowptr, b_idx, b_val = b_rowptr[0], b_idx[0], b_val[0]
        offs = offs[0]
        nzA = a_idx.shape[0]
        nzB = b_idx.shape[0]
        pidx = jax.lax.axis_index("i")
        av = gbcast(a_val, sr.xtype)
        kbuf = jax.lax.pcast(jnp.full((Lcap + 1,), big, kdt),
                             ("i",), to="varying")
        zbuf = jax.lax.pcast(jnp.full((Lcap + 1,), ident, zdt),
                             ("i",), to="varying")

        def step(s, carry):
            b_rowptr, b_idx, b_val, kbuf, zbuf = carry
            base = ((pidx - s) % d).astype(jnp.int32) * blkB
            kk = a_idx - base
            valid = (kk >= 0) & (kk < blkB)
            kkc = jnp.clip(kk, 0, blkB - 1)
            deg = jnp.where(valid, b_rowptr[kkc + 1] - b_rowptr[kkc],
                            jnp.int32(0))
            csum = jnp.cumsum(deg)
            total = csum[-1]
            off0 = offs[s]
            nch = (total + chunk - 1) // chunk
            bv = gbcast(b_val, sr.ytype)

            def chunk_body(c, st):
                kbuf, zbuf = st
                t = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
                e = jnp.searchsorted(csum, t, side="right")
                lv = t < total
                ec = jnp.minimum(e, nzA - 1)
                start = csum[ec] - deg[ec]
                pos = jnp.clip(b_rowptr[kkc[ec]] + (t - start), 0,
                               nzB - 1)
                keyv = jnp.where(
                    lv, a_loc[ec].astype(kdt) * n
                    + b_idx[pos].astype(kdt), jnp.asarray(big, kdt))
                z = sr.mult(av[ec], bv[pos]).astype(zdt)
                tgt = jnp.where(lv, off0 + t, Lcap)
                return (kbuf.at[tgt].set(keyv, mode="drop"),
                        zbuf.at[tgt].set(z, mode="drop"))

            kbuf, zbuf = jax.lax.fori_loop(0, nch, chunk_body,
                                           (kbuf, zbuf))
            perm = [(k, (k + 1) % d) for k in range(d)]
            return (jax.lax.ppermute(b_rowptr, "i", perm),
                    jax.lax.ppermute(b_idx, "i", perm),
                    jax.lax.ppermute(b_val, "i", perm), kbuf, zbuf)

        _, _, _, kbuf, zbuf = jax.lax.fori_loop(
            0, d, step, (b_rowptr, b_idx, b_val, kbuf, zbuf))
        # local ESC: sort lanes by key, fold duplicates with the monoid
        ks, zs = jax.lax.sort((kbuf[:Lcap], zbuf[:Lcap]), num_keys=1)
        is_new = jnp.concatenate([jnp.ones((1,), bool),
                                  ks[1:] != ks[:-1]])
        live = ks < big
        seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        folded = segment_reduce_sorted(sr.add.op, ident, zs, seg, Lcap)
        kuniq = jnp.full((Lcap,), big, kdt).at[
            jnp.where(is_new & live, seg, Lcap)].set(ks, mode="drop")
        nuniq = jnp.sum((is_new & live).astype(jnp.int32))
        return kuniq[None], folded[None], nuniq[None, None]

    f = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None),) * 7,
        out_specs=(P("i", None), P("i", None), P("i", None))))
    _PROG_CACHE[key] = f
    return f


def dist_spgemm(sr: Semiring, A, B, mesh: Optional[Mesh] = None,
                chunk: int = 1 << 18,
                max_lanes_per_dev: int = 1 << 27) -> CsrMatrix:
    """UNMASKED C = A *.sr* B over the mesh: A/B row-slabbed, B ring-
    rotated, per-device product lanes buffered at their exact flop
    offsets (host-computed symbolic sizing, the ``GB_AxB_flopcount`` /
    ``GB_AxB_alloc`` analogue), then ONE local sort-dedup fold per
    device emits the output slab.  Any semiring whose add monoid the
    associative scan supports (= any associative op incl. UDT-free
    named monoids)."""
    mesh = mesh or make_mesh()
    d = int(np.prod(mesh.devices.shape))
    A = _as_csr(A)
    B = _as_csr(B)
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        from ..core.errors import DimensionMismatch
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    DA = dist_csr_from_matrix(A, mesh)
    DB = dist_csr_from_matrix(B, mesh)
    blkA, blkB = DA.blk, DB.blk

    # exact per-(device, step) lane offsets from the host patterns
    Ia, Ja, _ = A.extractTuples()
    degB = np.zeros(k + 1, np.int64)
    Ib, _, _ = B.extractTuples()
    np.add.at(degB, Ib, 1)
    devA = (Ia // blkA).astype(np.int64)
    slabB = (Ja // blkB).astype(np.int64)
    flops_pq = np.zeros((d, d), np.int64)
    np.add.at(flops_pq, (devA, np.minimum(slabB, d - 1)), degB[Ja])
    # device p meets B slab q = (p - s) % d at step s
    offs = np.zeros((d, d + 1), np.int64)
    for p in range(d):
        per_step = flops_pq[p, (p - np.arange(d)) % d]
        offs[p, 1:] = np.cumsum(per_step)
    Lcap = int(offs[:, -1].max())
    if Lcap > max_lanes_per_dev:
        raise MemoryError(
            f"unmasked distributed SpGEMM needs {Lcap} lanes/device "
            f"(cap {max_lanes_per_dev}); use dist_masked_spgemm or a "
            f"bigger mesh")
    Lcap = pad_to_multiple(max(Lcap, 8), 128)

    kdt = jnp.int32 if (blkA + 1) * n < (1 << 31) else jnp.int64
    zdt = np.dtype(sr.ztype.dtype)
    if zdt == np.bool_:
        zdt = np.uint8
    sh = NamedSharding(mesh, P("i", None))
    offs_d = jax.device_put(jnp.asarray(offs.astype(np.int32)), sh)
    prog = _unmasked_prog(mesh, sr, d, blkA, blkB, n, chunk, Lcap,
                          kdt, zdt)
    kuniq, folded, nuniq = prog(DA.indices, DA.locrow, DA.values,
                                DB.rowptr, DB.indices, DB.values, offs_d)
    kuniq = np.asarray(kuniq)
    folded = np.asarray(folded)
    nuniq = np.asarray(nuniq)[:, 0]
    Is, Js, Xs = [], [], []
    for p in range(d):
        u = int(nuniq[p])
        keys = kuniq[p, :u].astype(np.int64)
        Is.append(keys // n + p * blkA)
        Js.append(keys % n)
        Xs.append(folded[p, :u])
    I = np.concatenate(Is) if Is else np.zeros(0, np.int64)
    J = np.concatenate(Js) if Js else np.zeros(0, np.int64)
    X = np.concatenate(Xs) if Xs else np.zeros(0, zdt)
    X = X.astype(sr.ztype.dtype, copy=False)
    return csr_from_coo(I, J, X, m, n, type=sr.ztype,
                        sum_duplicates=False)
