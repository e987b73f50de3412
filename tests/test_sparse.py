"""Sparse backend tests: CSR containers, bitpack, SpMV, masked SpGEMM."""

import jax.numpy as jnp
import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import sparse as sp
from graphblas_tpu.core.semirings import semiring


def _rand_csr(m, n, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    vals = rng.normal(size=(m, n)) * mask
    I, J = np.nonzero(mask)
    return sp.CsrMatrix.from_coo(I, J, vals[I, J], m, n), vals, mask


def test_csr_roundtrip():
    A, dense, mask = _rand_csr(13, 17, 0.3, 0)
    M = A.to_matrix()
    assert np.allclose(M.to_dense(), dense)
    assert np.array_equal(M.pattern_np(), mask)
    # transpose
    T = A.T()
    assert np.allclose(T.to_matrix().to_dense(), dense.T)


def test_csr_from_matrix():
    A, dense, mask = _rand_csr(9, 9, 0.4, 1)
    M = A.to_matrix()
    B = sp.CsrMatrix.from_matrix(M)
    assert np.allclose(B.to_matrix().to_dense(), dense)
    assert B.nvals == A.nvals


def test_csr_dup_sum():
    I = [0, 0, 1, 0]
    J = [1, 1, 2, 1]
    X = [1.0, 2.0, 5.0, 4.0]
    A = sp.CsrMatrix.from_coo(I, J, X, 3, 3)
    assert A.nvals == 2
    assert A.to_matrix().extractElement(0, 1) == 7.0


def test_bitpack_popcount():
    rng = np.random.default_rng(2)
    pat = rng.random((7, 100)) < 0.4
    packed = sp.pack_pattern(pat)
    got = np.asarray(sp.popcount(packed)).sum(axis=1)
    assert np.array_equal(got, pat.sum(axis=1))


@pytest.mark.parametrize("srname,ty", [
    ("plus_times", "FP64"), ("min_plus", "FP64"), ("max_times", "FP64"),
    ("plus_times", "INT32"),
])
def test_csr_mxv_semirings(srname, ty):
    t = getattr(gb, ty)
    A, dense, mask = _rand_csr(20, 16, 0.3, 3)
    if ty == "INT32":
        dense = (dense * 10).astype(np.int32) * mask
        I, J = np.nonzero(mask)
        A = sp.CsrMatrix.from_coo(I, J, dense[I, J], 20, 16, type=t)
    sr = semiring[srname][t]
    rng = np.random.default_rng(4)
    x = rng.normal(size=16) if ty == "FP64" else \
        rng.integers(-5, 5, 16).astype(np.int32)
    y, ypat = sp.csr_mxv(sr, A, jnp.asarray(x))
    # oracle on the bitmap backend
    M = A.to_matrix()
    u = gb.Vector.from_dense(x, t)
    want = gb.mxv(gb.Vector.new(sr.ztype, 20), None, None, sr, M, u)
    assert np.array_equal(np.asarray(ypat), want.pattern_np())
    got = np.where(np.asarray(ypat), np.asarray(y), 0)
    assert np.allclose(got, want.to_dense())


def test_csr_vxm_bool():
    A, dense, mask = _rand_csr(12, 12, 0.3, 5)
    sym = mask | mask.T
    I, J = np.nonzero(sym)
    Ab = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), 12, 12,
                               type=gb.BOOL)
    q = np.zeros(12, bool)
    q[2] = True
    sr = semiring.lor_land[gb.BOOL]
    y, ypat = sp.csr_vxm(sr, jnp.asarray(q), Ab.T(), x_pattern=q)
    want = sym[2]  # neighbors of node 2
    got = np.asarray(y) & np.asarray(ypat)
    assert np.array_equal(got, want)


def test_edge_intersection_counts():
    rng = np.random.default_rng(6)
    pat = rng.random((30, 30)) < 0.3
    pat = (pat | pat.T) & ~np.eye(30, dtype=bool)
    ei, ej = np.nonzero(np.tril(pat, -1))
    counts = np.asarray(sp.masked_spgemm_counts(
        (ei, ej), np.tril(pat, -1), np.triu(pat, 1)))
    L = np.tril(pat, -1)
    U = np.triu(pat, 1)
    want = np.array([(L[i] & U[j]).sum() for i, j in zip(ei, ej)])
    assert np.array_equal(counts, want)


def test_tricount_sparse_matches_dense():
    rng = np.random.default_rng(7)
    pat = rng.random((60, 60)) < 0.15
    pat = (pat | pat.T) & ~np.eye(60, dtype=bool)
    A = gb.Matrix.from_dense(pat.astype(np.float64), gb.FP64, pattern=pat)
    want = int(((pat.astype(np.int64) @ pat) * pat).sum()) // 6
    assert sp.tricount_sparse(A) == want


def test_ktruss_sparse_matches_bitmap():
    from graphblas_tpu import models
    # 5-clique + path
    I, J = [], []
    for i in range(5):
        for j in range(i + 1, 5):
            I += [i, j]
            J += [j, i]
    for i in range(5, 8):
        I += [i, i + 1]
        J += [i + 1, i]
    A = gb.Matrix.from_coo(np.array(I), np.array(J),
                           np.ones(len(I), bool), 9, 9, type=gb.BOOL,
                           dup=gb.binary.lor[gb.BOOL])
    (ei, ej, supp), _ = sp.ktruss_sparse(A, 4)
    C, _ = models.ktruss(A, 4)
    want = C.pattern_np()
    got = np.zeros_like(want)
    keep = supp >= 2
    got[ei[keep], ej[keep]] = True
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# BSR tile path
# ---------------------------------------------------------------------------

def test_bsr_tricount_matches_dense():
    rng = np.random.default_rng(9)
    pat = rng.random((300, 300)) < 0.04
    pat = (pat | pat.T) & ~np.eye(300, dtype=bool)
    L = np.tril(pat, -1)
    U = np.triu(pat, 1)
    want = int(((pat.astype(np.float64) @ pat) * pat).sum()) // 6
    assert sp.tricount_bsr(L, U) == want


def test_bsr_rectangular_tiles():
    rng = np.random.default_rng(10)
    pat = rng.random((200, 300)) < 0.05
    tp = sp.tile_pattern(pat)
    # reassemble from tiles and compare
    got = np.zeros((tp.grid.shape[0] * 128, tp.grid.shape[1] * 128),
                   bool)
    tiles = np.asarray(tp.tiles)
    for (I, J) in zip(*np.nonzero(tp.grid)):
        got[I*128:(I+1)*128, J*128:(J+1)*128] = \
            tiles[tp.index[I, J]] != 0
    assert np.array_equal(got[:200, :300], pat)


def test_bsr_pallas_empty_mask():
    Z = np.zeros((50, 50), bool)
    assert sp.tricount_bsr(Z, Z) == 0


def test_bsr_values_masked_mxm():
    rng = np.random.default_rng(11)
    n = 260
    mask = rng.random((n, n)) < 0.05
    Ad = (rng.normal(size=(n, n)) * mask).astype(np.float32)
    Bmask = rng.random((n, n)) < 0.05
    Bd = (rng.normal(size=(n, n)) * Bmask).astype(np.float32)
    Mmask = rng.random((n, n)) < 0.1
    A = gb.Matrix.from_dense(Ad, gb.FP32, pattern=mask)
    B = gb.Matrix.from_dense(Bd, gb.FP32, pattern=Bmask)
    M = gb.Matrix.from_dense(Mmask.astype(np.float32), gb.FP32,
                             pattern=Mmask)
    C = sp.masked_mxm(M, A, B, semiring=semiring.plus_times[gb.FP32])
    want = (Ad.astype(np.float64) @ Bd.astype(np.float64)) * Mmask
    got = C.to_dense()
    assert np.allclose(got, want.astype(np.float32), atol=1e-4)


def test_bsr_count_masked_mxm():
    rng = np.random.default_rng(12)
    n = 200
    pat = rng.random((n, n)) < 0.08
    pat = (pat | pat.T) & ~np.eye(n, dtype=bool)
    A = gb.Matrix.from_dense(pat, gb.BOOL, pattern=pat)
    C = sp.masked_mxm(A, A, A)  # C<A> = A*A counting
    want = ((pat.astype(np.int64) @ pat) * pat)
    assert np.array_equal(C.to_dense(), want.astype(np.int32))


# ---------------------------------------------------------------------------
# CSR elementwise / apply / select / reduce
# ---------------------------------------------------------------------------

def test_csr_ewise_add_mult():
    A, Ad, Am = _rand_csr(15, 12, 0.3, 30)
    B, Bd, Bm = _rand_csr(15, 12, 0.3, 31)
    op = gb.binary.plus[gb.FP64]
    C = sp.csr_ewise_add(op, A, B)
    want_pat = Am | Bm
    want = np.where(Am & Bm, Ad + Bd, np.where(Am, Ad, Bd))
    M = C.to_matrix()
    assert np.array_equal(M.pattern_np(), want_pat)
    assert np.allclose(M.to_dense(), np.where(want_pat, want, 0))
    D = sp.csr_ewise_mult(gb.binary.times[gb.FP64], A, B)
    Md = D.to_matrix()
    assert np.array_equal(Md.pattern_np(), Am & Bm)
    assert np.allclose(Md.to_dense(), np.where(Am & Bm, Ad * Bd, 0))


def test_csr_apply_select_reduce():
    A, Ad, Am = _rand_csr(10, 10, 0.4, 32)
    C = sp.csr_apply(gb.unary.ainv[gb.FP64], A)
    assert np.allclose(C.to_matrix().to_dense(), -Ad)
    # select: keep strict upper triangle
    U = sp.csr_select(gb.selectop.triu, A, 1)
    Mu = U.to_matrix()
    assert np.array_equal(Mu.pattern_np(), np.triu(Am, 1))
    # row reduce
    vals, pat = sp.csr_reduce_rows(gb.monoid.plus[gb.FP64], A)
    assert np.allclose(np.asarray(vals), Ad.sum(axis=1))
    assert np.array_equal(np.asarray(pat), Am.any(axis=1))
    # scalar reduce
    s = sp.csr_reduce_scalar(gb.monoid.plus[gb.FP64], A)
    assert np.isclose(s, Ad.sum())
    smax = sp.csr_reduce_scalar(gb.monoid.max[gb.FP64], A)
    assert np.isclose(smax, Ad[Am].max())


def test_tile_pattern_from_coo_matches_dense():
    rng = np.random.default_rng(13)
    pat = rng.random((300, 260)) < 0.03
    I, J = np.nonzero(pat)
    t1 = sp.tile_pattern(pat)
    from graphblas_tpu.sparse.bsr import tile_pattern_from_coo
    t2 = tile_pattern_from_coo(I, J, pat.shape)
    assert np.array_equal(t1.grid, t2.grid)
    # same tiles content (order may differ; compare via index map)
    for (ti, tj) in zip(*np.nonzero(t1.grid)):
        a = np.asarray(t1.tiles)[t1.index[ti, tj]]
        b = np.asarray(t2.tiles)[t2.index[ti, tj]]
        assert np.array_equal(a, b)


def test_rmat_generator():
    from graphblas_tpu.models.rmat import rmat_edges, rmat_graph
    I, J = rmat_edges(10, 8, seed=3)
    n = 1 << 10
    assert I.max() < n and J.max() < n
    assert (I != J).all()
    # symmetric + deduped
    lin = set(zip(I.tolist(), J.tolist()))
    assert all((j, i) in lin for i, j in list(lin)[:100])
    A = rmat_graph(8, 4, seed=5)
    assert A.nrows == 256
    assert A.nvals == len(rmat_edges(8, 4, seed=5)[0])


def test_rmat_device_generator():
    """The device generator keeps rmat_edges' contract: symmetric,
    unique, no self edges, row-major sorted, ~edge_factor*n draws, and
    the same seed gives the same graph."""
    from graphblas_tpu.models.rmat import rmat_edges_device
    n = 1 << 10
    I, J = rmat_edges_device(10, 8, seed=3)
    lin = I * n + J
    assert I.dtype == np.int64 and I.max() < n and J.max() < n
    assert (np.diff(lin) > 0).all() and (I != J).all()
    assert np.array_equal(np.sort(J * n + I), lin)
    assert 0.5 * 8 * n < len(I) <= 2 * 8 * n
    I2, J2 = rmat_edges_device(10, 8, seed=3)
    assert np.array_equal(I, I2) and np.array_equal(J, J2)
    # R-MAT skew: the top vertex carries far more than the mean degree
    assert np.bincount(I).max() > 8 * len(I) / n


def test_csr_from_coo_presorted_matches_sorted():
    """Row-major unique input skips the sort; the container equals the
    one built from the shuffled tuples."""
    rng = np.random.default_rng(14)
    lin = np.unique(rng.integers(0, 60 * 50, 700))
    I, J = lin // 50, lin % 50
    X = rng.normal(size=len(I))
    A = sp.CsrMatrix.from_coo(I, J, X, 60, 50)
    p = rng.permutation(len(I))
    B = sp.CsrMatrix.from_coo(I[p], J[p], X[p], 60, 50)
    for f in ("indptr", "indices", "rowids", "values"):
        assert np.array_equal(np.asarray(getattr(A, f)),
                              np.asarray(getattr(B, f)))


def test_csr_mxv_sparse_x_min_plus():
    # sparse x where mult(a, 0) != add identity: only correct if absent
    # contributions are masked to the identity
    A, Ad, Am = _rand_csr(10, 8, 0.5, 40)
    xp = np.zeros(8, bool)
    xp[[1, 4, 6]] = True
    x = np.where(xp, np.arange(8, dtype=np.float64), 0.0)
    sr = semiring.min_plus[gb.FP64]
    y, ypat = sp.csr_mxv(sr, A, jnp.asarray(x), x_pattern=xp)
    # oracle via bitmap backend
    u = gb.Vector.from_dense(x, gb.FP64, pattern=xp)
    want = gb.mxv(gb.Vector.new(gb.FP64, 10), None, None, sr,
                  A.to_matrix(), u)
    assert np.array_equal(np.asarray(ypat), want.pattern_np())
    got = np.where(np.asarray(ypat), np.asarray(y), 0)
    assert np.allclose(got, want.to_dense())


def test_top_level_mxv_routes_csr():
    from graphblas_tpu.ops.flopcount import last_axb_method
    A, Ad, Am = _rand_csr(9, 9, 0.4, 41)
    u = gb.Vector.from_dense(np.arange(9, dtype=np.float64))
    w = gb.mxv(gb.Vector.new(gb.FP64, 9), None, None,
               semiring.plus_times[gb.FP64], A, u)
    assert np.allclose(w.to_dense(), Ad @ np.arange(9.0))
    # vxm with TRAN1 also hits the CSR kernel
    w2 = gb.vxm(gb.Vector.new(gb.FP64, 9), None, None,
                semiring.plus_times[gb.FP64], u, A, gb.TRAN1)
    assert np.allclose(w2.to_dense(), Ad @ np.arange(9.0))
    # mxm accepts CsrMatrix operands (auto-densify)
    C = gb.mxm(gb.Matrix.new(gb.FP64, 9, 9), None, None,
               semiring.plus_times[gb.FP64], A, A)
    assert np.allclose(C.to_dense(), Ad @ Ad)


def test_bfs_csr_whole_loop():
    from graphblas_tpu import models
    rng = np.random.default_rng(50)
    pat = rng.random((80, 80)) < 0.05
    pat = (pat | pat.T) & ~np.eye(80, dtype=bool)
    I, J = np.nonzero(pat)
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), np.float32), 80, 80,
                              type=gb.FP32)
    Am = gb.Matrix.from_dense(pat, gb.BOOL, pattern=pat)
    want = models.bfs_jit(Am, 0)
    got = sp.bfs_csr(A, 0)
    assert np.array_equal(got, want)


def test_pagerank_csr_whole_loop():
    from graphblas_tpu import models
    rng = np.random.default_rng(51)
    pat = rng.random((60, 60)) < 0.1
    np.fill_diagonal(pat, False)
    I, J = np.nonzero(pat)
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), np.float32), 60, 60,
                              type=gb.FP32)
    Am = gb.Matrix.from_dense(pat, gb.BOOL, pattern=pat)
    want = models.pagerank_jit(Am, iters=20)
    got = sp.pagerank_csr(A, iters=20)
    assert np.allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("add,mult", [("MIN", "PLUS"), ("MAX", "PLUS"),
                                      ("MIN", "MAX"), ("MAX", "MIN"),
                                      ("MIN", "TIMES"), ("MAX", "TIMES")])
def test_tropical_pairs_mxm(add, mult):
    """Tropical semirings on dense FP32 bitmap operands through gb.mxm
    (the generic path) against the numpy oracle."""
    from graphblas_tpu.ops.flopcount import last_axb_method
    rng = np.random.default_rng(60)
    a = rng.random((140, 150)).astype(np.float32) + 0.1
    b = rng.random((150, 130)).astype(np.float32) + 0.1
    sr = semiring[f"{add}_{mult}".lower()][gb.FP32]
    C = gb.mxm(gb.Matrix.new(gb.FP32, 140, 130), None, None, sr,
               gb.Matrix.from_dense(a, gb.FP32),
               gb.Matrix.from_dense(b, gb.FP32))
    assert last_axb_method() == "vpu:generic"
    ops = {"PLUS": np.add, "TIMES": np.multiply,
           "MIN": np.minimum, "MAX": np.maximum}
    z = ops[mult](a[:, :, None], b[None, :, :])
    want = z.min(axis=1) if add == "MIN" else z.max(axis=1)
    assert C.pattern_np().all()
    assert np.allclose(C.to_dense(), want, rtol=1e-6)


def test_tropical_semiring_mm_fallback_matches_generic():
    # sparse operands: absent entries must not take part in the min;
    # checked against the dense oracle through the public API
    rng = np.random.default_rng(61)
    mask = rng.random((40, 40)) < 0.4
    Ad = (rng.random((40, 40)) * mask).astype(np.float32)
    A = gb.Matrix.from_dense(Ad, gb.FP32, pattern=mask)
    sr = semiring.min_plus[gb.FP32]
    C = gb.mxm(gb.Matrix.new(gb.FP32, 40, 40), None, None, sr, A, A)
    Af = np.where(mask, Ad.astype(np.float64), np.inf)
    z = Af[:, :, None] + Af[None, :, :]
    want = z.min(axis=1)
    got = C.to_dense()
    pat = C.pattern_np()
    assert np.allclose(got[pat], want[pat].astype(np.float32))


def test_unmasked_bsr_spgemm():
    rng = np.random.default_rng(70)
    n = 300
    mask = rng.random((n, n)) < 0.04
    Ad = (rng.normal(size=(n, n)) * mask).astype(np.float32)
    Bmask = rng.random((n, n)) < 0.04
    Bd = (rng.normal(size=(n, n)) * Bmask).astype(np.float32)
    A = gb.Matrix.from_dense(Ad, gb.FP32, pattern=mask)
    B = gb.Matrix.from_dense(Bd, gb.FP32, pattern=Bmask)
    C = sp.masked_mxm(None, A, B, semiring=semiring.plus_times[gb.FP32])
    want = Ad.astype(np.float64) @ Bd.astype(np.float64)
    want_pat = (mask.astype(np.int64) @ Bmask) > 0
    assert np.array_equal(C.pattern_np(), want_pat)
    got = C.to_dense()
    assert np.allclose(got[want_pat], want[want_pat].astype(np.float32),
                       atol=1e-4)
    # counting form
    Ab = gb.Matrix.from_dense(mask, gb.BOOL, pattern=mask)
    Cc = sp.masked_mxm(None, Ab, Ab)
    cnt = (mask.astype(np.int64) @ mask)
    assert np.array_equal(Cc.to_dense(), cnt.astype(np.int32))


def test_csr_mxv_int_matrix_float_semiring():
    # int-stored A with a float semiring must not truncate x
    I, J = [0, 1], [0, 1]
    A = sp.CsrMatrix.from_coo(I, J, np.array([2, 3]), 2, 2,
                              type=gb.INT32)
    x = np.array([0.5, 0.25])
    y, yp = sp.csr_mxv(semiring.plus_times[gb.FP64], A, jnp.asarray(x))
    assert np.allclose(np.asarray(y), [1.0, 0.75])


def test_masked_mxm_rejects_unsupported_semiring():
    A = gb.Matrix.from_dense(np.ones((4, 4), np.float32), gb.FP32)
    with pytest.raises(NotImplementedError):
        sp.masked_mxm(None, A, A, semiring=semiring.min_plus[gb.FP32])


def test_masked_mxm_truthy_counts_and_bool():
    # explicit zeros must not count as truthy pairs for PLUS_LAND
    n = 4
    Av = np.array([[0.0, 2.0], [3.0, 0.0]])
    Ap = np.ones((2, 2), bool)      # all present, two explicit zeros
    A = gb.Matrix.from_dense(Av, gb.FP64, pattern=Ap)
    C = sp.masked_mxm(None, A, A,
                      semiring=semiring.plus_land[gb.INT32])
    want = gb.mxm(gb.Matrix.new(gb.INT32, 2, 2), None, None,
                  semiring.plus_land[gb.INT32], A, A)
    assert np.array_equal(C.to_dense(), want.to_dense())
    Cb = sp.masked_mxm(None, A, A,
                       semiring=semiring.lor_land[gb.BOOL])
    wantb = gb.mxm(gb.Matrix.new(gb.BOOL, 2, 2), None, None,
                   semiring.lor_land[gb.BOOL], A, A)
    assert np.array_equal(Cb.to_dense(), wantb.to_dense())
    assert np.array_equal(Cb.pattern_np(), wantb.pattern_np())


@pytest.mark.parametrize("srname,ty", [
    ("plus_times", "FP32"), ("plus_times", "INT32"),
    ("plus_times", "UINT32"), ("min_plus", "INT32"),
    ("max_times", "FP32"), ("lor_land", "BOOL"),
    ("plus_pair", "INT32"), ("min_first", "FP32"),
])
def test_csr_mxv_sorted_matches_gather(monkeypatch, srname, ty):
    """The zero-gather sort-routed dense-x kernel must agree exactly
    with the gather kernel for every eligible semiring/dtype."""
    import graphblas_tpu.sparse.spmv as spmv_mod
    t = getattr(gb, ty)
    rng = np.random.default_rng(11)
    n, m = 60, 45
    nz = 700
    I = rng.integers(0, n, nz)
    J = rng.integers(0, m, nz)
    if ty == "BOOL":
        X = np.ones(nz, bool)
        x = rng.random(m) > 0.4
    elif ty == "FP32":
        X = rng.normal(size=nz).astype(np.float32)
        x = rng.normal(size=m).astype(np.float32)
    else:
        X = rng.integers(1, 9, nz).astype(t.dtype)
        x = rng.integers(-4, 9, m).astype(t.dtype) if ty == "INT32" \
            else rng.integers(0, 9, m).astype(t.dtype)
    A = sp.CsrMatrix.from_coo(I, J, X, n, m, type=t)
    sr = semiring[srname][t]
    # gather kernel (sorted path disabled by the size gate)
    assert not spmv_mod._sorted_path_ok(sr, A)
    y0, p0 = sp.csr_mxv(sr, A, jnp.asarray(x))
    # force the sorted path
    monkeypatch.setattr(spmv_mod, "_SORTED_MIN_LANES", 1)
    assert spmv_mod._sorted_path_ok(sr, A)
    y1, p1 = sp.csr_mxv(sr, A, jnp.asarray(x))
    assert np.array_equal(np.asarray(p0), np.asarray(p1))
    g0 = np.where(np.asarray(p0), np.asarray(y0), 0)
    g1 = np.where(np.asarray(p1), np.asarray(y1), 0)
    if ty == "FP32":
        assert np.allclose(g0, g1, rtol=1e-6, atol=1e-7)
    else:
        assert np.array_equal(g0, g1)
    # plan is cached once per container
    assert "_spmv_plan" in A._options


def test_csr_mxv_sorted_excludes_fp64_and_sparse_x(monkeypatch):
    import graphblas_tpu.sparse.spmv as spmv_mod
    monkeypatch.setattr(spmv_mod, "_SORTED_MIN_LANES", 1)
    rng = np.random.default_rng(3)
    I = rng.integers(0, 30, 200)
    J = rng.integers(0, 30, 200)
    X = rng.normal(size=200)
    A = sp.CsrMatrix.from_coo(I, J, X, 30, 30, type=gb.FP64)
    sr = semiring.plus_times[gb.FP64]
    # f64 x cannot ride the 32-bit bitcast broadcast
    assert not spmv_mod._sorted_path_ok(sr, A)
    x = rng.normal(size=30)
    y, p = sp.csr_mxv(sr, A, jnp.asarray(x))
    D = np.zeros((30, 30)); D[I, J] = 0
    I2, J2, X2 = A.extractTuples(); D[I2, J2] = X2
    assert np.allclose(np.where(np.asarray(p), np.asarray(y), 0),
                       np.where(D.any(axis=1) | (np.diff(np.asarray(A.indptr)) > 0),
                                D @ x, 0))


# -- dense-x SpMV kernels (gather and sort-routed) ---------------------------
def _spmv_ref(I, J, X, x, m, n):
    D = np.zeros((m, n), np.float64)
    np.add.at(D, (I, J), X)
    return D @ x.astype(np.float64), (np.bincount(I, minlength=m) > 0)


def _both_dense_x_kernels(monkeypatch, A, sr, x):
    """(y, ypat) from the gather kernel, then from the sorted kernel."""
    import graphblas_tpu.sparse.spmv as spmv_mod
    from graphblas_tpu.ops.flopcount import last_axb_method
    out = []
    for min_lanes, method in ((1 << 62, "spmv:gather"),
                              (1, "spmv:sorted")):
        monkeypatch.setattr(spmv_mod, "_SORTED_MIN_LANES", min_lanes)
        y, p = sp.csr_mxv(sr, A, jnp.asarray(x))
        assert last_axb_method() == method
        out.append((np.asarray(y), np.asarray(p)))
    return out


def test_csr_mxv_dense_x_empty_row_blocks(monkeypatch):
    """Rows with no entries give zero values and an absent pattern on
    both dense-x kernels, however long the empty stretch."""
    rng = np.random.default_rng(8)
    m, n = 600, 300
    I = np.concatenate([rng.integers(0, 100, 800),
                        rng.integers(400, 450, 300)])
    J = rng.integers(0, n, len(I))
    X = rng.normal(size=len(I)).astype(np.float32)
    A = sp.CsrMatrix.from_coo(I, J, X, m, n, type=gb.FP32)
    x = rng.normal(size=n).astype(np.float32)
    ref, refp = _spmv_ref(I, J, X, x, m, n)
    for y, p in _both_dense_x_kernels(
            monkeypatch, A, semiring.plus_times[gb.FP32], x):
        assert np.array_equal(p, refp)
        assert np.all(y[100:400] == 0) and np.all(y[450:] == 0)
        assert np.allclose(np.where(p, y, 0), np.where(refp, ref, 0),
                           rtol=1e-5, atol=1e-5)


def test_csr_mxv_dense_x_sums_duplicates(monkeypatch):
    """A container built with sum_duplicates=False carries duplicate
    (i, j) lanes; both dense-x kernels add them."""
    I = np.array([0, 0, 5, 5, 5, 130, 130])
    J = np.array([3, 3, 7, 7, 7, 2, 2])
    X = np.array([1.0, 2.0, 10.0, 20.0, 30.0, 4.0, 5.0], np.float32)
    A = sp.CsrMatrix.from_coo(I, J, X, 200, 200, type=gb.FP32,
                              sum_duplicates=False)
    x = np.arange(1, 201, dtype=np.float32)
    for y, _ in _both_dense_x_kernels(
            monkeypatch, A, semiring.plus_times[gb.FP32], x):
        assert np.isclose(y[0], 3.0 * x[3])
        assert np.isclose(y[5], 60.0 * x[7])
        assert np.isclose(y[130], 9.0 * x[2])


def test_csr_mxv_dense_x_huge_dimension():
    """A 2^23-dimension matrix with three far-apart clusters: the
    dense-x kernel's work and memory follow nnz and n, with no
    block-grid table."""
    dim = 1 << 23
    rng = np.random.default_rng(11)
    base = np.array([0, dim // 2, dim - 128], np.int64)
    I = np.concatenate([b + rng.integers(0, 128, 2000) for b in base])
    J = np.concatenate([b + rng.integers(0, 128, 2000) for b in base])
    X = rng.normal(size=len(I)).astype(np.float32)
    A = sp.CsrMatrix.from_coo(I, J, X, dim, dim, type=gb.FP32)
    x = rng.normal(size=dim).astype(np.float32)
    y, p = sp.csr_mxv(semiring.plus_times[gb.FP32], A, jnp.asarray(x))
    y, p = np.asarray(y), np.asarray(p)
    rows = np.unique(I)
    assert np.array_equal(np.nonzero(p)[0], rows)
    want = np.zeros(len(rows))
    np.add.at(want, np.searchsorted(rows, I),
              X.astype(np.float64) * x[J])
    assert np.allclose(y[rows], want, rtol=1e-5, atol=1e-5)
    assert not y[~p].any()


def test_csr_mxv_routes_dense_x_kernels():
    """csr_mxv records which dense-x kernel ran: the gather kernel
    below the sorted path's size gate, the sorted kernel above it."""
    from graphblas_tpu.ops.flopcount import last_axb_method
    import graphblas_tpu.sparse.spmv as spmv_mod
    rng = np.random.default_rng(10)
    sr = semiring.plus_times[gb.FP32]
    for nz, method in ((500, "spmv:gather"),
                       (spmv_mod._SORTED_MIN_LANES, "spmv:sorted")):
        I = rng.integers(0, 200, nz)
        J = rng.integers(0, 200, nz)
        X = rng.normal(size=nz).astype(np.float32)
        A = sp.CsrMatrix.from_coo(I, J, X, 200, 200, type=gb.FP32,
                                  sum_duplicates=False)
        x = rng.normal(size=200).astype(np.float32)
        y, p = sp.csr_mxv(sr, A, jnp.asarray(x))
        assert last_axb_method() == method
        ref, refp = _spmv_ref(I, J, X, x, 200, 200)
        assert np.array_equal(np.asarray(p), refp)
        assert np.allclose(np.asarray(y), np.where(refp, ref, 0),
                           rtol=1e-4, atol=1e-4)


def test_csr_mxv_inf_x_against_absent_entry(monkeypatch):
    """An inf in x meets only the rows that hold an entry in its
    column; rows without one stay finite on both dense-x kernels (no
    0 * inf from padding or dense tiles)."""
    I = np.array([0, 0, 1, 2, 3])
    J = np.array([0, 1, 1, 2, 3])
    X = np.ones(5, np.float32)
    A = sp.CsrMatrix.from_coo(I, J, X, 4, 4, type=gb.FP32)
    x = np.array([np.inf, 1.0, 2.0, 3.0], np.float32)
    for y, p in _both_dense_x_kernels(
            monkeypatch, A, semiring.plus_times[gb.FP32], x):
        assert p.all()
        assert np.isposinf(y[0])
        assert np.array_equal(y[1:], [1.0, 2.0, 3.0])


def test_csr_mxv_sorted_path_gate():
    """The sorted kernel takes only large, 32-bit, non-UDT dense-x
    calls on concrete patterns, and caches its plan on the container."""
    import jax
    import graphblas_tpu.sparse.spmv as spmv_mod
    rng = np.random.default_rng(9)
    big = spmv_mod._SORTED_MIN_LANES
    I = rng.integers(0, 300, big)
    J = rng.integers(0, 300, big)
    A = sp.CsrMatrix.from_coo(I, J, np.ones(big, np.float32), 300, 300,
                              type=gb.FP32, sum_duplicates=False)
    sr32 = semiring.plus_times[gb.FP32]
    assert spmv_mod._sorted_path_ok(sr32, A)
    small = sp.CsrMatrix.from_coo(I[:100], J[:100],
                                  np.ones(100, np.float32), 300, 300,
                                  type=gb.FP32)
    assert not spmv_mod._sorted_path_ok(sr32, small)
    assert not spmv_mod._sorted_path_ok(semiring.plus_times[gb.FP64], A)
    # traced patterns (whole-loop jitted solvers) cannot plan on the host
    seen = []
    jax.jit(lambda ind: seen.append(spmv_mod._sorted_path_ok(
        sr32, sp.CsrMatrix(A.indptr, ind, A.rowids, A.values, A.nvals,
                           300, 300, gb.FP32))) or ind)(A.indices)
    assert seen == [False]
    sp.csr_mxv(sr32, A, jnp.ones(300, jnp.float32))
    assert "_spmv_plan" in A._options
