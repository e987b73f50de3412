"""GPU correctness lane: the matmul, Triton and bitpack paths that the
CPU suite only exercises on XLA:CPU or in interpret mode, plus int8
exactness, 64-bit integer products and full-f32 matmul precision — each
checked against an independent numpy oracle on the card itself.

Run on the card with ``make test-gpu``; without a GPU every test skips.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import graphblas_tpu as gb
from graphblas_tpu.core.matrix import Matrix
from graphblas_tpu.core.semirings import semiring
from graphblas_tpu.sparse.container import CsrMatrix
import graphblas_tpu.sparse as sp

pytestmark = pytest.mark.gpu


def sym_graph(rng, n, nedges):
    i = rng.integers(0, n, nedges)
    j = rng.integers(0, n, nedges)
    keep = i != j
    lin = np.unique(i[keep] * n + j[keep])
    i, j = lin // n, lin % n
    I = np.concatenate([i, j])
    J = np.concatenate([j, i])
    lin = np.unique(I * n + J)
    return lin // n, lin % n


def test_mxu_plus_times_f32(rng):
    """Dense semiring matmul vs numpy (f32 tolerance)."""
    m, k, n = 160, 224, 96
    a = rng.random((m, k)).astype(np.float32)
    b = rng.random((k, n)).astype(np.float32)
    A = Matrix.from_dense(a, type=gb.FP32)
    B = Matrix.from_dense(b, type=gb.FP32)
    C = gb.mxm(Matrix.new(gb.FP32, m, n), None, None,
               semiring.plus_times[gb.FP32], A, B)
    got = np.asarray(C.wait().values)
    assert np.allclose(got, a @ b, rtol=1e-4)


def test_int8_counting_exact(rng):
    """Pattern/counting matmul exactness through the int8 matmul path:
    counts up to k=224 must be exact integers."""
    m, k, n = 96, 224, 64
    a = rng.random((m, k)) < 0.5
    b = rng.random((k, n)) < 0.5
    A = Matrix.from_dense(a.astype(np.uint32), type=gb.UINT32,
                          pattern=a)
    B = Matrix.from_dense(b.astype(np.uint32), type=gb.UINT32,
                          pattern=b)
    C = gb.mxm(Matrix.new(gb.UINT32, m, n), None, None,
               semiring.plus_times[gb.UINT32], A, B)
    got = np.asarray(C.wait().values)
    want = a.astype(np.int64) @ b.astype(np.int64)
    pat = np.asarray(gb.np_bool(C.wait().pattern)) \
        if hasattr(gb, "np_bool") else None
    assert np.array_equal(got.astype(np.int64)[want > 0], want[want > 0])


def test_tricount_engines_agree(rng):
    """CSR counting engine vs bitmap engine vs dense oracle."""
    n = 600
    I, J = sym_graph(rng, n, 6000)
    D = np.zeros((n, n), np.int64)
    D[I, J] = 1
    want = int(np.trace(D @ D @ D)) // 6
    A_csr = CsrMatrix.from_coo(I, J, np.ones(len(I), np.uint32), n, n,
                               type=gb.UINT32)
    L = sp.csr_tril(A_csr)
    U = sp.csr_triu(A_csr)
    assert sp.tricount_esc(L, U) == want
    A_bm = Matrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL)
    assert sp.tricount_sparse(A_bm) == want


def test_tropical_minplus(rng):
    """Tropical (MIN_PLUS) generic engine on the card vs numpy oracle."""
    n = 128
    a = rng.random((n, n)).astype(np.float32)
    b = rng.random((n, n)).astype(np.float32)
    A = Matrix.from_dense(a, type=gb.FP32)
    B = Matrix.from_dense(b, type=gb.FP32)
    C = gb.mxm(Matrix.new(gb.FP32, n, n), None, None,
               semiring.min_plus[gb.FP32], A, B)
    got = np.asarray(C.wait().values)
    want = np.min(a[:, :, None] + b[None, :, :], axis=1)
    assert np.allclose(got, want, rtol=1e-5)


def test_np_bool_staging(rng):
    """bool device->host transfers stage through uint8; np_bool must
    round-trip exactly."""
    from graphblas_tpu.core.matrix import np_bool
    pat = jnp.asarray(rng.random((64, 64)) < 0.3)
    host = np_bool(pat)
    assert host.dtype == np.bool_
    assert np.array_equal(host, np.asarray(pat))


def test_spmv_semirings_on_chip(rng):
    """csr_mxv on the card for a few semirings vs dense oracle."""
    n = 300
    I, J = sym_graph(rng, n, 2000)
    X = (rng.random(len(I)) + 0.5).astype(np.float32)
    A = CsrMatrix.from_coo(I, J, X, n, n, type=gb.FP32,
                           sum_duplicates=False)
    x = (rng.random(n) + 0.5).astype(np.float32)
    D = np.zeros((n, n), np.float64)
    D[I, J] = X
    y, ypat = sp.csr_mxv(semiring.plus_times[gb.FP32], A, x)
    rows = D.sum(axis=1) != 0
    assert np.allclose(np.asarray(y)[rows], (D @ x)[rows], rtol=1e-4)
    y2, _ = sp.csr_mxv(semiring.min_plus[gb.FP32], A, x)
    want2 = np.where(rows, np.min(np.where(D > 0, D + x[None, :],
                                           np.inf), axis=1), 0)
    assert np.allclose(np.asarray(y2)[rows], want2[rows], rtol=1e-5)


def test_esc_spgemm_on_chip(rng):
    """ESC sparse-output SpGEMM on the card: masked f32 vs a dense
    numpy oracle."""
    from graphblas_tpu.sparse.esc import csr_spgemm
    n = 200
    Ap = rng.random((n, n)) < 0.08
    Bp = rng.random((n, n)) < 0.08
    Mp = rng.random((n, n)) < 0.3
    Av = np.where(Ap, rng.normal(size=(n, n)), 0).astype(np.float32)
    Bv = np.where(Bp, rng.normal(size=(n, n)), 0).astype(np.float32)
    I, J = np.nonzero(Ap)
    A = CsrMatrix.from_coo(I, J, Av[I, J], n, n, type=gb.FP32)
    I, J = np.nonzero(Bp)
    B = CsrMatrix.from_coo(I, J, Bv[I, J], n, n, type=gb.FP32)
    I, J = np.nonzero(Mp)
    M = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL)
    sr = semiring.plus_times[gb.FP32]
    C = csr_spgemm(sr, A, B, mask=M)
    cI, cJ, cX = C.extractTuples()
    want = (Av.astype(np.float64) @ Bv.astype(np.float64))
    wantp = ((Ap.astype(np.int64) @ Bp.astype(np.int64)) > 0) & Mp
    wI, wJ = np.nonzero(wantp)
    assert np.array_equal(np.asarray(cI), wI)
    assert np.array_equal(np.asarray(cJ), wJ)
    assert np.allclose(np.asarray(cX), want[wI, wJ], rtol=1e-4)


def test_hyper_spgemm_on_chip(rng):
    """Hypersparse SpGEMM at dimension 2^40 on the card."""
    from graphblas_tpu.sparse.hyper import HyperMatrix, hyper_spgemm
    dim = 1 << 40
    base = (1 << 39) + 12345
    k = 40
    rows = base + rng.integers(0, 200, 3 * k)
    cols = base + rng.integers(0, 200, 3 * k)
    vals = rng.integers(1, 5, 3 * k).astype(np.int32)
    A = HyperMatrix.from_coo(rows, cols, vals, dim, dim, type=gb.INT32)
    B = HyperMatrix.from_coo(cols, rows, vals, dim, dim, type=gb.INT32)
    sr = semiring.plus_times[gb.INT32]
    C = hyper_spgemm(sr, A, B)
    cI, cJ, cX = C.extractTuples()
    # dense oracle over the local 200x200 window
    Ad = np.zeros((200, 200), np.int64)
    np.add.at(Ad, (rows - base, cols - base), vals)
    Bd = np.zeros((200, 200), np.int64)
    np.add.at(Bd, (cols - base, rows - base), vals)
    Cd = Ad @ Bd
    wI, wJ = np.nonzero(Cd)
    assert np.array_equal(np.asarray(cI) - base, wI)
    assert np.array_equal(np.asarray(cJ) - base, wJ)
    assert np.array_equal(np.asarray(cX), Cd[wI, wJ].astype(np.int32))


def test_sorted_spmv_on_chip(rng):
    """Sort-routed SpMV (bitcast-cummax broadcast) on the card."""
    from graphblas_tpu.sparse.spmv import csr_mxv, spmv_plan
    from graphblas_tpu.sparse.spmv import _csr_mxv_sorted_jit
    n = 4096
    I = rng.integers(0, n, 8 * n)
    J = rng.integers(0, n, 8 * n)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), np.float32), n, n,
                           type=gb.FP32, sum_duplicates=False)
    x = rng.random(n).astype(np.float32)
    sr = semiring.plus_times[gb.FP32]
    avals_csc, rank, spp, scc = spmv_plan(A)
    x_ext = jnp.concatenate([jnp.asarray(x), jnp.zeros((1,), jnp.float32)])
    y, _ = _csr_mxv_sorted_jit(sr.add.op.name, sr, A.nrows,
                               sr.ztype.dtype, avals_csc, rank, spp, scc,
                               A.rowids, A.indptr, x_ext, sr.add.identity)
    yh = np.asarray(y)
    indptr = np.asarray(A.indptr)
    cols = np.asarray(A.indices)[:A.nvals]
    vals = np.asarray(A.values)[:A.nvals]
    for r in rng.integers(0, n, 16):
        want = (vals[indptr[r]:indptr[r + 1]] *
                x[cols[indptr[r]:indptr[r + 1]]]).sum()
        assert np.isclose(yh[r], want, rtol=1e-4)


def test_tri_counts_kernel_on_chip(rng):
    """tri.py's sort-merge masked counting on the card."""
    from graphblas_tpu.sparse.tri import tricount_esc, csr_tril, csr_triu
    i, j = sym_graph(rng, 500, 3000)
    n = 500
    A = CsrMatrix.from_coo(i, j, np.ones(len(i), bool), n, n,
                           type=gb.BOOL)
    L, U = csr_tril(A), csr_triu(A)
    got = tricount_esc(L, U)
    Ad = np.zeros((n, n), np.float64)
    Ad[i, j] = 1
    want = int(round(((Ad @ Ad) * Ad).sum())) // 6
    assert got == want


def test_window_engines_on_chip(rng):
    """Window-panel masked count, XLA form and compiled Triton kernel,
    on the card vs the dense oracle and each other."""
    from graphblas_tpu.sparse import window as W
    n, bw = 1500, 120
    sym = rng.random((n, n)) < 0.08
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    I, J = np.nonzero(np.tril(Ap))
    L = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL)
    I, J = np.nonzero(np.triu(Ap))
    U = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL)
    wplan = W.build_window_plan(L, U, L)
    assert wplan is not None
    got_xla = int(W.window_masked_count_sum(wplan))
    got_triton = int(W.window_count_sum_triton(wplan))
    Af = Ap.astype(np.float64)
    want = int(round(((Af @ Af) * Af).sum())) // 6
    assert got_xla == want and got_triton == want


def test_spmm_ell_on_chip(rng):
    """Bucketed-ELL SpMM on the card vs numpy."""
    from graphblas_tpu.sparse.spmm import csr_spmm_dense
    m, n, k = 600, 500, 16
    Ap = rng.random((m, n)) < 0.05
    Av = np.where(Ap, rng.normal(size=(m, n)), 0).astype(np.float32)
    I, J = np.nonzero(Ap)
    A = CsrMatrix.from_coo(I, J, Av[I, J], m, n, type=gb.FP32)
    X = rng.normal(size=(n, k)).astype(np.float32)
    sr = semiring.plus_times[gb.FP32]
    y, ypat = csr_spmm_dense(sr, A, jnp.asarray(X))
    want = Av.astype(np.float64) @ X.astype(np.float64)
    live = Ap.any(axis=1)
    # rtol alone is the wrong criterion for near-cancelling f32 dots:
    # entries with |want| ~ 1e-4 fail a pure rtol=1e-4 check on
    # reduction-order grounds; atol=1e-5 bounds the f32 abs error of a
    # 16-term dot of unit-scale values with room to spare.
    assert np.allclose(np.asarray(y)[live], want[live],
                       rtol=1e-4, atol=1e-5)
    assert np.array_equal(np.asarray(ypat)[:, 0], live)


def test_bitdot_engine_on_chip(rng):
    """bitdot engine: bitmap popcount counts on the card vs the
    sort-merge engine AND a dense numpy oracle."""
    import graphblas_tpu as gb
    from graphblas_tpu import sparse as sp
    from graphblas_tpu.sparse.bitdot import (build_bitdot_plan,
                                             bitdot_counts)
    from graphblas_tpu.sparse.tri import (masked_pair_counts,
                                          tricount_prep_csr)
    r = np.random.default_rng(23)
    n = 500
    deg = np.minimum((r.pareto(1.2, n) * 4).astype(int) + 1, n - 1)
    I = np.repeat(np.arange(n), deg)
    J = r.integers(0, n, size=len(I))
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    I, J = lin // n, lin % n
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL, sum_duplicates=False)
    L, U = tricount_prep_csr(A)
    plan = build_bitdot_plan(L, L, U, min_lanes=1, cover_target=0.9)
    assert plan is not None
    got = bitdot_counts(plan, L)
    if plan.A_light.nvals:
        got = got + masked_pair_counts(L, plan.A_light, U)
    ref = masked_pair_counts(L, L, U)
    assert bool(jnp.all(got == ref))
    # dense oracle for the total
    D = np.zeros((n, n), bool)
    D[I, J] = True
    Ld = np.tril(D, -1).astype(np.int64)
    Ud = np.triu(D, 1).astype(np.int64)
    # prep relabels; totals must still match the graph's triangle count
    want = int(((Ld @ Ld) * Ld).sum())
    assert int(jnp.sum(ref.astype(jnp.int64))) == want


def test_int64_plus_times_s64_dot(rng):
    """INT64 PLUS_TIMES takes the matmul path (an s64 dot_general) on
    the card and is exact, beyond the int32 range."""
    from graphblas_tpu.platform import x64_dot_ok
    from graphblas_tpu.ops.flopcount import last_axb_method
    assert x64_dot_ok()
    m, k, n = 48, 64, 40
    a = rng.integers(-(1 << 20), 1 << 20, (m, k)).astype(np.int64)
    b = rng.integers(-(1 << 20), 1 << 20, (k, n)).astype(np.int64)
    A = Matrix.from_dense(a, type=gb.INT64)
    B = Matrix.from_dense(b, type=gb.INT64)
    C = gb.mxm(Matrix.new(gb.INT64, m, n), None, None,
               semiring.plus_times[gb.INT64], A, B)
    assert last_axb_method() == "mxu:plus_times"
    assert np.array_equal(np.asarray(C.wait().values), a @ b)


def test_plus_times_f32_full_precision(rng):
    """f32 PLUS_TIMES against float64 numpy at rtol 1e-5: a product
    computed in TF32 (about 3 decimal digits) fails this."""
    m, k, n = 128, 1024, 96
    a = rng.random((m, k)).astype(np.float32)
    b = rng.random((k, n)).astype(np.float32)
    A = Matrix.from_dense(a, type=gb.FP32)
    B = Matrix.from_dense(b, type=gb.FP32)
    C = gb.mxm(Matrix.new(gb.FP32, m, n), None, None,
               semiring.plus_times[gb.FP32], A, B)
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(np.asarray(C.wait().values), want,
                               rtol=1e-5)


def test_valdot_masked_mxm_on_chip(rng, monkeypatch):
    """valdot, the valued masked SpGEMM engine, through gb.mxm on the
    card vs the ESC engine: identical pattern, f32 values to
    reassociation tolerance (elementwise products, so no TF32)."""
    import graphblas_tpu.sparse.bitdot as bd
    from graphblas_tpu.ops.flopcount import last_axb_method
    from graphblas_tpu.sparse.esc import csr_spgemm
    monkeypatch.setattr(bd, "_MIN_LANES", 1)
    n = 6000
    deg = np.minimum((rng.pareto(1.2, n) * 4).astype(int) + 1, n - 1)
    I = np.repeat(np.arange(n), deg)
    J = rng.integers(0, n, size=len(I))
    keep = I != J
    lin = np.unique(np.concatenate([I[keep] * n + J[keep],
                                    J[keep] * n + I[keep]]))
    I, J = lin // n, lin % n
    lo = I > J

    def valued(r, c):
        v = (rng.random(len(r)) + 0.5).astype(np.float32)
        return CsrMatrix.from_coo(r, c, v, n, n, type=gb.FP32,
                                  sum_duplicates=False)

    L, U, M = valued(I[lo], J[lo]), valued(J[lo], I[lo]), valued(I[lo], J[lo])
    C0 = CsrMatrix.from_coo(np.zeros(0, int), np.zeros(0, int),
                            np.zeros(0, np.float32), n, n, type=gb.FP32)
    sr = semiring.plus_times[gb.FP32]
    C = gb.mxm(C0, M, None, sr, L, U)
    assert last_axb_method().startswith("valdot")
    R = csr_spgemm(sr, L, U, mask=M)
    ci, cj, cx = (np.asarray(v) for v in C.extractTuples())
    ri, rj, rx = (np.asarray(v) for v in R.extractTuples())
    assert np.array_equal(ci, ri) and np.array_equal(cj, rj)
    np.testing.assert_allclose(cx, rx, rtol=2e-5, atol=2e-6)
