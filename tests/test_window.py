"""Window-panel masked SpGEMM engine: differential tests vs the dense
oracle on banded patterns, plan rejection on unstructured ones."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import sparse as sp
from graphblas_tpu.sparse import window as W


def _banded_csr(n, bw, density, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pat = rng.random((n, n)) < density
    band = np.abs(i[:, None] - i[None, :]) <= bw
    pat &= band
    I, J = np.nonzero(pat)
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL)
    return A, pat


def _csr_of(pat):
    I, J = np.nonzero(pat)
    n = pat.shape[0]
    return sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                                 type=gb.BOOL), pat


def test_window_tricount_banded():
    n, bw = 700, 90
    rng = np.random.default_rng(0)
    sym = rng.random((n, n)) < 0.15
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    Lp = np.tril(Ap)
    Up = np.triu(Ap)
    I, J = np.nonzero(Lp)
    L = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL)
    I, J = np.nonzero(Up)
    U = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL)
    got = W.tricount_window(L, U)
    assert got is not None
    Af = Ap.astype(np.float64)
    want = int(round(((Af @ Af) * Af).sum())) // 6
    assert got == want


def test_window_masked_mm_general():
    # C<M> = A · B' with three unrelated banded patterns
    n = 500
    A, Ap = _banded_csr(n, 70, 0.2, 1)
    B, Bp = _banded_csr(n, 50, 0.25, 2)
    M, Mp = _banded_csr(n, 40, 0.3, 3)
    plan = W.build_window_plan(A, B, M)
    assert plan is not None
    C = np.asarray(W.window_masked_mm(plan))
    # reassemble to dense and compare with the oracle
    want = (Ap.astype(np.int64) @ Bp.T.astype(np.int64)) * Mp
    got = np.zeros((plan.nI * W.T, plan.mshape[1] + W.T * plan.nJmax),
                   np.int64)
    for I in range(plan.nI):
        c0 = plan.j0[I] * W.T
        got[I * W.T:(I + 1) * W.T, c0:c0 + plan.nJmax * W.T] += C[I]
    got = got[:n, :n]
    assert np.array_equal(got, want)
    # real triple count matches the BSR schedule's definition
    from graphblas_tpu.sparse import bsr
    At = bsr.tile_pattern(Ap)
    Bt = bsr.tile_pattern(Bp.T)
    Mt = bsr.tile_pattern(Mp)
    sched = bsr.build_schedule(Mt, At, Bt)
    assert plan.ntriples == (len(sched[1]) if sched else 0)


def test_window_count_triton_tricount_interpret():
    """The Pallas Triton window count (interpret mode) equals the XLA
    form and the dense oracle on a banded tricount plan."""
    n, bw = 700, 90
    rng = np.random.default_rng(0)
    sym = rng.random((n, n)) < 0.15
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    L, _ = _csr_of(np.tril(Ap))
    U, _ = _csr_of(np.triu(Ap))
    plan = W.build_window_plan(L, U, L)
    assert plan is not None
    got = int(W.window_count_sum_triton(plan, interpret=True))
    Af = Ap.astype(np.float64)
    want = int(round(((Af @ Af) * Af).sum())) // 6
    assert got == int(W.window_masked_count_sum(plan)) == want


def test_window_count_triton_general_interpret():
    """Unrelated banded A, B, M with n off the 128 grid: the contraction
    window and the output window differ (W != nJmax), and the padded
    panel rows and columns must count nothing."""
    n = 500
    A, Ap = _banded_csr(n, 70, 0.2, 1)
    B, Bp = _banded_csr(n, 50, 0.25, 2)
    M, Mp = _banded_csr(n, 200, 0.3, 3)
    plan = W.build_window_plan(A, B, M)
    assert plan is not None and plan.Wmax != plan.nJmax
    want = int(((Ap.astype(np.int64) @ Bp.T.astype(np.int64)) * Mp).sum())
    assert int(W.window_count_sum_triton(plan, interpret=True)) == want
    assert int(W.window_masked_count_sum(plan)) == want


def test_window_rejects_unstructured():
    # uniform random pattern spans the full width -> plan refused
    n = W.T * (W.MAX_W_BLOCKS + 2)
    rng = np.random.default_rng(4)
    I = rng.integers(0, n, 4000)
    J = rng.integers(0, n, 4000)
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL)
    assert W.build_window_plan(A, A, A) is None
    # and the rejection is cached
    assert A._options[("_window_plan", id(A), id(A))] is False


def test_window_plan_cache():
    A, _ = _banded_csr(300, 30, 0.3, 5)
    p1 = W.build_window_plan(A, A, A)
    p2 = W.build_window_plan(A, A, A)
    assert p1 is p2


def test_tricount_prep_csr():
    import graphblas_tpu.sparse as S
    rng = np.random.default_rng(9)
    n = 300
    i = rng.integers(0, n, 2500)
    j = rng.integers(0, n, 2500)
    keep = i != j
    lin = np.unique(np.concatenate([i[keep] * n + j[keep],
                                    j[keep] * n + i[keep]]))
    I, J = lin // n, lin % n
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL, sum_duplicates=False)
    L, U = S.tricount_prep_csr(A)
    got = S.tricount_esc(L, U)
    D = np.zeros((n, n))
    D[I, J] = 1
    want = int(round(np.trace(D @ D @ D))) // 6
    assert got == want
    # prep orients every edge exactly once
    assert L.nvals == len(I) // 2 and U.nvals == len(I) // 2
