"""Distributed padded-CSR: memory-scalable sharding for large graphs.

The dense-block DistMatrix costs O(n²/d) HBM per device; real large
graphs need O(nnz/d).  Here each device holds a *CSR slab* of rows
(indices/values padded to the max slab nnz so shards are uniform), and
SpMV is the edge-parallel gather + segment-sum kernel run inside
``shard_map``:

* ``dist_csr_mxv``: y = A *.sr* x for ANY named semiring and dtype,
  with A row-slabbed and x replicated — the output lands row-sharded
  with ZERO collectives (each device owns its rows); one ``all_gather``
  republishes y when the next iteration needs it, which is the frontier
  exchange of BFS/PageRank at scale.

This is the direct realization of SURVEY §5's "row/block partitioning of
CSR across the mesh with halo exchange of frontier vectors".  The
sharded masked SpGEMM (B slabs rotating over the ICI ring) lives in
:mod:`graphblas_tpu.parallel.dist_spgemm`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.matrix import Matrix, np_bool
from ..core.semirings import Semiring
from ..core.types import Type, FP32, type_of_dtype
from .mesh import make_mesh, pad_to_multiple

__all__ = ["DistCsr", "dist_csr_from_matrix", "dist_csr_mxv",
           "dist_csr_pagerank", "dist_csr_bfs"]


class DistCsr:
    """Row-slab CSR over a 1-D mesh: arrays lead with a device axis.

    rowptr:  [d, blk+1] int32 (per-slab indptr)
    indices: [d, nzpad] int32 (column ids; ncols = identity sentinel)
    locrow:  [d, nzpad] int32 (row id *within the slab*; blk = sentinel)
    values:  [d, nzpad] of the matrix dtype (bool staged as uint8)
    """

    def __init__(self, rowptr, indices, locrow, values, mesh: Mesh,
                 nrows: int, ncols: int, blk: int, type: Type = FP32):
        self.starts = None         # variable slab boundaries (np, d+1)
        self.rowptr = rowptr
        self.indices = indices
        self.locrow = locrow
        self.values = values
        self.mesh = mesh
        self.nrows = nrows
        self.ncols = ncols
        self.blk = blk
        self.type = type

    @property
    def ndev(self) -> int:
        return int(self.rowptr.shape[0])


def dist_csr_from_matrix(A, mesh: Optional[Mesh] = None,
                         transpose: bool = False,
                         boundaries=None) -> DistCsr:
    """Split A's rows (or A''s, for vxm use) into per-device CSR slabs.
    Accepts a bitmap Matrix or a CsrMatrix (no densify).

    ``boundaries`` (optional, length d+1, boundaries[0]=0): explicit
    slab row boundaries for WEIGHT-BALANCED partitions — the ring
    SpGEMM cuts B's rows at equal flop weight so no single hub slab
    serializes the rotation (every ring step is a barrier; with uniform
    slabs a power-law hub slab costs d * max-slab-flops total)."""
    mesh = mesh or make_mesh()
    d = int(np.prod(mesh.devices.shape))
    if isinstance(A, Matrix):
        A = A.wait()
        I, J, X = A.extractTuples()
        nr, nc = A.nrows, A.ncols
        t = A.type
    else:  # CsrMatrix / anything with extractTuples + shape
        I, J, X = A.extractTuples()
        nr, nc = A.shape
        t = getattr(A, "type", None) or type_of_dtype(np.asarray(X).dtype)
    tmap = jax.tree_util.tree_map
    nrows, ncols = (nc, nr) if transpose else (nr, nc)
    if transpose:
        # extractTuples gives row- or column-major order, so within each
        # new row the new columns already ascend: a stable one-key sort
        # is the transpose's row-major order
        I, J = J, I
        order = np.argsort(I, kind="stable")
        I, J = I[order], J[order]
        X = tmap(lambda v: np.asarray(v)[order], X)
    return _dist_csr_from_coo(I, J, X, nrows, ncols, t, mesh, boundaries)


def _dist_csr_from_coo(I, J, X, nrows: int, ncols: int, t: Type,
                       mesh: Mesh, boundaries=None) -> DistCsr:
    """Row-slab DistCsr from host COO arrays in row-major order."""
    tmap = jax.tree_util.tree_map
    d = int(np.prod(mesh.devices.shape))
    if boundaries is None:
        m_pad = pad_to_multiple(max(nrows, 1), d)
        blk = m_pad // d
        dev = (I // blk).astype(np.int64)
        loc = (I % blk).astype(np.int32)
        starts = None
    else:
        bnd = np.asarray(boundaries, np.int64)
        assert len(bnd) == d + 1 and bnd[0] == 0 and bnd[-1] >= nrows
        dev = (np.searchsorted(bnd[1:], I, side="right")
               ).astype(np.int64)
        dev = np.minimum(dev, d - 1)
        loc = (I - bnd[dev]).astype(np.int32)
        blk = int(max((bnd[1:] - bnd[:-1]).max(), 1))
        starts = bnd
    nz_per_dev = np.bincount(dev, minlength=d)
    nzpad = pad_to_multiple(max(int(nz_per_dev.max()), 8), 128)

    # bool values are staged as uint8 (see core/matrix.np_bool).  UDT
    # values are a pytree of leaves (SoA, like CsrMatrix.values).
    def _stage(dt):
        return np.uint8 if np.dtype(dt) == np.bool_ else np.dtype(dt)
    rowptr = np.zeros((d, blk + 1), np.int32)
    indices = np.full((d, nzpad), ncols, np.int32)
    locrow = np.full((d, nzpad), blk, np.int32)
    values = tmap(lambda v: np.zeros((d, nzpad),
                                     _stage(np.asarray(v).dtype)), X)
    for p in range(d):
        sel = dev == p
        Jp, Lp = J[sel], loc[sel]
        k = len(Jp)
        indices[p, :k] = Jp
        locrow[p, :k] = Lp

        def put(buf, v):
            buf[p, :k] = np.asarray(v)[sel].astype(buf.dtype, copy=False)
            return buf
        values = tmap(put, values, X)
        cnt = np.bincount(Lp, minlength=blk)
        rowptr[p, 1:] = np.cumsum(cnt)

    sh = NamedSharding(mesh, P("i", None))
    out = DistCsr(jax.device_put(jnp.asarray(rowptr), sh),
                  jax.device_put(jnp.asarray(indices), sh),
                  jax.device_put(jnp.asarray(locrow), sh),
                  tmap(lambda v: jax.device_put(jnp.asarray(v), sh),
                       values),
                  mesh, nrows, ncols, blk, t)
    out.starts = starts            # None = uniform blk slabs
    return out


def _local_spmv(sr: Optional[Semiring], indices, locrow, values, x_ext,
                blk):
    """One slab's y = A_slab *.sr* x: gather + mult + segment-reduce
    (the edge-parallel kernel of sparse/spmv.py, per shard)."""
    from ..sparse.spmv import _mult_apply, segment_reduce
    xg = jnp.take(x_ext, indices[0], axis=0)
    if sr is None:  # legacy fast path: plus_times on the stored dtype
        contrib = values[0].astype(xg.dtype) * xg
        y = jax.ops.segment_sum(contrib, locrow[0],
                                num_segments=blk + 1)[:blk]
        return y[None]
    from ..core.types import cast as gbcast
    ident = sr.add.identity
    a = gbcast(values[0], sr.xtype)
    z = _mult_apply(sr, a, xg)
    live = locrow[0] < blk
    z = jnp.where(live, z, jnp.asarray(ident, z.dtype))
    y = segment_reduce(sr.add.op.name, z, jnp.minimum(locrow[0], blk),
                       blk + 1, ident)[:blk]
    return y.astype(sr.ztype.dtype)[None]


_PROG_CACHE = {}


def _mxv_prog(mesh: Mesh, blk: int, sr: Optional[Semiring]):
    key = (id(mesh), blk, sr)
    f = _PROG_CACHE.get(key)
    if f is not None:
        return f

    def local(rowptr, indices, locrow, values, x_ext):
        y = _local_spmv(sr, indices, locrow, values, x_ext, blk)
        return y
    f = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None),) * 4 + (P(),),
        out_specs=P("i", None)))
    _PROG_CACHE[key] = f
    return f


def _udt_mxv_prog(mesh: Mesh, blk: int, sr: Semiring):
    """UDT distributed SpMV program (cached by semiring identity —
    UDT identities are dict pytrees, unhashable as jit statics)."""
    key = ("udt", id(mesh), blk, id(sr))
    f = _PROG_CACHE.get(key)
    if f is not None:
        return f
    tmap = jax.tree_util.tree_map

    def local(rowptr, indices, locrow, values, x_ext):
        from ..sparse.spmv import segment_reduce_sorted
        idx = indices[0]
        loc = locrow[0]
        vals = tmap(lambda v: v[0], values)
        xg = tmap(lambda v: jnp.take(v, idx, axis=0), x_ext)
        z = sr.mult(vals, xg)
        ident = sr.add.identity
        live = loc < blk
        z = tmap(lambda zz, idv: jnp.where(live, zz,
                                           jnp.asarray(idv, zz.dtype)),
                 z, ident)
        y = segment_reduce_sorted(sr.add.op, ident, z,
                                  jnp.minimum(loc, blk), blk + 1)
        return tmap(lambda v: v[:blk][None], y)

    f = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None),) * 4 + (P(),),
        out_specs=P("i", None)))
    _PROG_CACHE[key] = f
    return f


def dist_csr_mxv(D: DistCsr, x, sr: Optional[Semiring] = None):
    """y = A *.sr* x (default: plus_times on x's dtype); y comes back
    row-sharded (concatenated slabs, padded length), zero collectives.
    Any named (add, mult) pair works — the add monoid must have a
    segment reduction (PLUS/TIMES/MIN/MAX/LOR/LAND/LXOR/EQ) — and UDT
    semirings run through the generic associative-scan reduction
    (``dpagerank2.c``'s struct semiring, distributed)."""
    if sr is not None and (sr.ztype.is_udt or D.type.is_udt):
        # caller supplies x already in the semiring's input domain
        # (pytree of [ncols] leaves), like the single-chip UDT mxv
        tmap = jax.tree_util.tree_map
        x_ext = tmap(lambda v: jnp.concatenate(
            [jnp.asarray(v), jnp.zeros((1,), jnp.asarray(v).dtype)]), x)
        if D.starts is not None:
            raise ValueError(
                "dist_csr_mxv requires uniform slabs (see above)")
        prog = _udt_mxv_prog(D.mesh, D.blk, sr)
        y = prog(D.rowptr, D.indices, D.locrow, D.values, x_ext)
        return tmap(lambda v: v.reshape(-1)[:D.nrows], y)
    if sr is None:
        x = jnp.asarray(x, jnp.float32)
        xfill = jnp.zeros((1,), x.dtype)
    else:
        from ..core.types import cast as gbcast
        x = gbcast(jnp.asarray(x), sr.ytype)
        # the sentinel slot must be harmless: dead lanes are identity-
        # washed in the kernel, so any in-domain value works
        xfill = jnp.zeros((1,), x.dtype)
    if D.starts is not None:
        raise ValueError(
            "dist_csr_mxv requires uniform slabs; this DistCsr was "
            "built with explicit flop-balanced boundaries (ring "
            "SpGEMM use only)")
    x_ext = jnp.concatenate([x, xfill])
    prog = _mxv_prog(D.mesh, D.blk, sr)
    from . import introspect
    introspect.record("dist_csr_mxv", prog,
                      (D.rowptr, D.indices, D.locrow, D.values, x_ext))
    y = prog(D.rowptr, D.indices, D.locrow, D.values, x_ext)
    return y.reshape(-1)[:D.nrows]


def _rowscaled_transpose_coo(A):
    """Host COO of C' where C = D*A, D(i,i) = 1/sum(A(i,:)) (the
    ``drowscale`` of a CsrMatrix without densifying), in row-major order
    of C'.  A's entries are in CSR order, so a stable sort by column
    gives the transpose's row-major order."""
    hp = A._options.get("host_pattern")
    if hp is not None:
        I = np.asarray(hp[0][:A.nvals])
        J = np.asarray(hp[1][:A.nvals])
        X = np.asarray(jax.device_get(A.values))[:A.nvals]
    else:
        I, J, X = (np.asarray(v) for v in A.extractTuples())
    X = X.astype(np.float64)
    rowsum = np.bincount(I, weights=X, minlength=A.nrows)
    rowsum[rowsum == 0] = 1.0
    vals = (X / rowsum[I]).astype(np.float32)
    order = np.argsort(J, kind="stable")
    return J[order], I[order], vals[order]


def dist_csr_pagerank(A, iters: int = 20,
                      mesh: Optional[Mesh] = None) -> np.ndarray:
    """PageRank over the sharded-CSR SpMV (one all_gather per iteration,
    implicit in the replicated x of the next step).  Accepts a bitmap
    Matrix or a CsrMatrix (no densify)."""
    mesh = mesh or make_mesh()
    from ..sparse.container import CsrMatrix
    # r' = r @ C = C' r  -> shard C' (CSC of C) row-slabs
    if isinstance(A, CsrMatrix):
        It, Jt, Xt = _rowscaled_transpose_coo(A)
        D = _dist_csr_from_coo(It, Jt, Xt, A.ncols, A.nrows, FP32, mesh)
    else:
        from ..models.pagerank import drowscale
        D = dist_csr_from_matrix(drowscale(A), mesh, transpose=True)
    n = A.nrows
    r = np.full(n, 1.0 / n, np.float32)
    a = (1 - 0.85) / n
    for _ in range(iters):
        s = a * float(r.sum())
        r = np.asarray(dist_csr_mxv(D, jnp.asarray(0.85 * r))) + s
    return r / r.sum()


def dist_csr_bfs(A, src: int,
                 mesh: Optional[Mesh] = None) -> np.ndarray:
    """BFS levels over the sharded-CSR frontier SpMV.  Accepts Matrix
    or CsrMatrix."""
    mesh = mesh or make_mesh()
    D = dist_csr_from_matrix(A, mesh, transpose=True)
    n = A.nrows
    lev = np.zeros(n, np.int64)
    q = np.zeros(n, np.float32)
    q[src] = 1.0
    level = 1
    while q.any() and level <= n:
        lev[q != 0] = level
        nxt = np.asarray(dist_csr_mxv(D, jnp.asarray(q)))
        q = ((nxt != 0) & (lev == 0)).astype(np.float32)
        level += 1
    return lev
