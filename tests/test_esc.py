"""ESC sparse SpGEMM (CSR x CSR -> CSR, any semiring) vs the dense
oracle — the round-2 headline engine (VERDICT.md next-round #1)."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.sparse.container import CsrMatrix
from graphblas_tpu.sparse.esc import csr_spgemm
from graphblas_tpu.core.semirings import semiring
from graphblas_tpu.core.types import (BOOL, FP32, FP64, INT32, INT64,
                                      UINT8, UINT32)

import tests.oracle as orc
from tests.helpers import rand_om


def to_csr(o: orc.OM, t: gb.Type) -> CsrMatrix:
    I, J = np.nonzero(o.p)
    X = o.m[I, J]
    return CsrMatrix.from_coo(I, J, X, o.p.shape[0], o.p.shape[1],
                              type=t, sum_duplicates=False)


def csr_to_om(C: CsrMatrix) -> orc.OM:
    vals = np.zeros(C.shape, C.type.dtype)
    pat = np.zeros(C.shape, bool)
    I, J, X = C.extractTuples()
    vals[I, J] = X
    pat[I, J] = True
    return orc.OM(vals, pat)


def check(Com, expect, dtype, tol=0.0):
    assert np.array_equal(Com.p, expect.p), "pattern mismatch"
    if np.issubdtype(np.dtype(dtype), np.floating):
        a, b = Com.m[Com.p], expect.m[expect.p]
        # summation order differs from the oracle; f32 cancellation can
        # leave absolute errors ~eps * max|term| (reference parity bar
        # is 'within roundoff', isequal_roundoff.m)
        if np.dtype(dtype) == np.float32:
            rtol, atol = 1e-4, 1e-4
        else:
            rtol, atol = 1e-8, 1e-10
        assert np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
    else:
        assert np.array_equal(Com.m, expect.m)


FAMILIES = [
    ("plus", "times", FP32),
    ("plus", "times", FP64),
    ("plus", "times", INT32),
    ("plus", "times", UINT8),      # wraps mod 256
    ("min", "plus", FP64),
    ("max", "second", INT64),
    ("lor", "land", BOOL),
    ("land", "lor", BOOL),
    ("lxor", "land", BOOL),
    ("times", "times", FP32),
    ("plus", "pair", INT32),
    ("min", "first", INT32),
    ("plus", "minus", FP64),       # non-commutative mult: operand order
    ("min", "div", FP64),
    ("eq", "eq", BOOL),
    ("max", "min", UINT32),
]


@pytest.mark.parametrize("addname,multname,t", FAMILIES,
                         ids=[f"{a}_{m}_{t.name}" for a, m, t in FAMILIES])
def test_esc_spgemm_matches_oracle(addname, multname, t, rng):
    dtype = t.dtype
    A = rand_om(rng, (17, 23), dtype, density=0.3)
    B = rand_om(rng, (23, 19), dtype, density=0.3)
    sr = semiring[f"{addname}_{multname}"][t]
    C = csr_spgemm(sr, to_csr(A, t), to_csr(B, t))
    expect = orc.o_mxm(addname, multname, dtype, A, B)
    check(csr_to_om(C), expect, sr.ztype.dtype)
    from graphblas_tpu.ops.flopcount import last_axb_method
    assert last_axb_method() == "esc:csr_spgemm"


@pytest.mark.parametrize("complement", [False, True])
def test_esc_spgemm_masked(rng, complement):
    A = rand_om(rng, (20, 20), np.float64, density=0.25)
    B = rand_om(rng, (20, 20), np.float64, density=0.25)
    M = rand_om(rng, (20, 20), np.float64, density=0.4)
    sr = semiring.plus_times[FP64]
    C = csr_spgemm(sr, to_csr(A, FP64), to_csr(B, FP64),
                   mask=to_csr(M, FP64), complement=complement)
    Z = orc.o_mxm("plus", "times", np.float64, A, B)
    empty = orc.OM(np.zeros((20, 20)), np.zeros((20, 20), bool))
    expect = orc.o_mask(empty, M, Z, scmp=complement)
    check(csr_to_om(C), expect, np.float64)


def test_esc_spgemm_valued_mask_zeros(rng):
    """Mask entries with value 0 do NOT select (valued-mask semantics)."""
    A = rand_om(rng, (10, 10), np.int32, density=0.5)
    B = rand_om(rng, (10, 10), np.int32, density=0.5)
    M = rand_om(rng, (10, 10), np.int32, density=0.6)
    # force some explicit zeros into the mask
    M.m[M.p] = np.where(np.arange(M.p.sum()) % 3 == 0, 0, M.m[M.p])
    sr = semiring.plus_times[INT32]
    C = csr_spgemm(sr, to_csr(A, INT32), to_csr(B, INT32),
                   mask=to_csr(M, INT32))
    Z = orc.o_mxm("plus", "times", np.int32, A, B)
    empty = orc.OM(np.zeros((10, 10), np.int32), np.zeros((10, 10), bool))
    expect = orc.o_mask(empty, M, Z)
    check(csr_to_om(C), expect, np.int32)


def test_esc_spgemm_empty_and_shapes(rng):
    sr = semiring.plus_times[FP32]
    A = rand_om(rng, (5, 7), np.float32, density=0.0)
    B = rand_om(rng, (7, 3), np.float32, density=0.5)
    C = csr_spgemm(sr, to_csr(A, FP32), to_csr(B, FP32))
    assert C.nvals == 0 and C.shape == (5, 3)
    with pytest.raises(gb.DimensionMismatch):
        csr_spgemm(sr, to_csr(B, FP32), to_csr(B, FP32))


def test_esc_spgemm_user_monoid_scan_path(rng):
    """A user-defined add monoid exercises the segmented-scan fold."""
    from graphblas_tpu.core.monoids import monoid_new
    from graphblas_tpu.core.ops import BinaryOp
    from graphblas_tpu.core.semirings import Semiring
    import jax.numpy as jnp
    # absmax monoid: keep the operand with larger |.| (assoc, id 0)
    absmax = BinaryOp("ABSMAX", lambda x, y: jnp.where(
        jnp.abs(x) >= jnp.abs(y), x, y), FP64, FP64, FP64)
    mon = monoid_new(absmax, 0.0)
    sr = Semiring(mon, gb.binary.times[FP64])
    A = rand_om(rng, (12, 15), np.float64, density=0.4)
    B = rand_om(rng, (15, 9), np.float64, density=0.4)
    C = csr_spgemm(sr, to_csr(A, FP64), to_csr(B, FP64))
    # oracle
    m, k = A.p.shape
    n = B.p.shape[1]
    out = np.zeros((m, n))
    outp = np.zeros((m, n), bool)
    for i in range(m):
        for j in range(n):
            acc = 0.0
            for kk in range(k):
                if A.p[i, kk] and B.p[kk, j]:
                    z = A.m[i, kk] * B.m[kk, j]
                    acc = acc if abs(acc) >= abs(z) else z
                    outp[i, j] = True
            out[i, j] = acc if outp[i, j] else 0.0
    check(csr_to_om(C), orc.OM(out, outp), np.float64)


def test_esc_spgemm_large_dimension_no_densify(rng):
    """n = 200_000: a dense bitmap would need 40 GB — success proves the
    O(nnz) path (VERDICT 'done' criterion: large-scale mxm on CSR)."""
    n = 200_000
    nnz = 4000
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    X = rng.random(nnz).astype(np.float32)
    A = CsrMatrix.from_coo(I, J, X, n, n, type=FP32)
    sr = semiring.plus_times[FP32]
    C = csr_spgemm(sr, A, A)
    # oracle via scipy-style dict product on the deduped tuples
    Ia, Ja, Xa = A.extractTuples()
    rows = {}
    for i, j, x in zip(Ia, Ja, Xa):
        rows.setdefault(i, []).append((j, x))
    expect = {}
    for i, row in rows.items():
        for k, a in row:
            for j, b in rows.get(k, ()):
                expect[(i, j)] = expect.get((i, j), 0.0) + a * b
    Ic, Jc, Xc = C.extractTuples()
    got = {(i, j): x for i, j, x in zip(Ic, Jc, Xc)}
    assert set(got) == set(expect)
    for ij in expect:
        assert np.isclose(got[ij], expect[ij], rtol=1e-5)


def test_esc_spgemm_int64_keys(rng):
    """Dimensions past 2^31 linear-key range switch to int64 keys."""
    n = 70_000  # n*n ~ 4.9e9 > 2^31
    I = np.array([0, 1, 2, n - 1])
    J = np.array([1, 2, 3, 0])
    X = np.array([1.0, 2.0, 3.0, 4.0], np.float64)
    A = CsrMatrix.from_coo(I, J, X, n, n, type=FP64)
    sr = semiring.plus_times[FP64]
    C = csr_spgemm(sr, A, A)
    Ic, Jc, Xc = C.extractTuples()
    got = {(int(i), int(j)): x for i, j, x in zip(Ic, Jc, Xc)}
    assert got == {(0, 2): 2.0, (1, 3): 6.0, (n - 1, 1): 4.0}


# -- plan cache: steady-state calls skip every host sync (VERDICT r3) --------

def test_spgemm_plan_cache_repeated_calls(rng):
    from graphblas_tpu.sparse import csr_spgemm
    n = 300
    A = CsrMatrix.from_coo(rng.integers(0, n, 2000),
                              rng.integers(0, n, 2000),
                              rng.random(2000), n, n, type=gb.FP64)
    B = CsrMatrix.from_coo(rng.integers(0, n, 2000),
                              rng.integers(0, n, 2000),
                              rng.random(2000), n, n, type=gb.FP64)
    sr = semiring.plus_times[gb.FP64]
    C1 = csr_spgemm(sr, A, B)
    assert ("_spgemm_plan", False, False) in A._options
    C2 = csr_spgemm(sr, A, B)  # plan hit: no host pull
    assert C1.nvals == C2.nvals
    for a, b in zip(C1.extractTuples(), C2.extractTuples()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # different B pattern buffer -> plan miss, fresh correct result
    B2 = CsrMatrix.from_coo(rng.integers(0, n, 500),
                               rng.integers(0, n, 500),
                               rng.random(500), n, n, type=gb.FP64)
    C3 = csr_spgemm(sr, A, B2)
    assert C3.nvals != 0


def test_spgemm_plan_cache_valued_mask_invalidation(rng):
    """A valued mask keys output nnz on its VALUES: same pattern with
    different values must not reuse the cached nnz."""
    import jax.numpy as jnp
    from graphblas_tpu.sparse import csr_spgemm
    n = 200
    I = rng.integers(0, n, 1500)
    J = rng.integers(0, n, 1500)
    A = CsrMatrix.from_coo(I, J, rng.random(1500), n, n, type=gb.FP64)
    B = CsrMatrix.from_coo(rng.integers(0, n, 1500),
                              rng.integers(0, n, 1500),
                              rng.random(1500), n, n, type=gb.FP64)
    sr = semiring.plus_times[gb.FP64]
    M1 = CsrMatrix.from_coo(I, J, np.ones(1500), n, n, type=gb.FP64)
    C1 = csr_spgemm(sr, A, B, mask=M1)
    # same mask pattern, half the values zeroed
    newv = np.asarray(M1.values).copy()
    newv[: M1.nvals // 2] = 0.0
    M2 = CsrMatrix(M1.indptr, M1.indices, M1.rowids,
                      jnp.asarray(newv), M1.nvals, n, n, gb.FP64)
    C2 = csr_spgemm(sr, A, B, mask=M2)
    assert C2.nvals < C1.nvals


def test_mxm_cost_model_exact_flops(rng):
    """The engine decision + counters see the true flop count
    (GB_AxB_flopcount.c), not the nvals^2/k estimate (VERDICT r2 #5)."""
    from graphblas_tpu.utils import counters
    from graphblas_tpu.ops.mxm import mxm
    n = 400
    IA, JA = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    IB, JB = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    A = CsrMatrix.from_coo(IA, JA, rng.random(3000), n, n,
                              type=gb.FP64)
    B = CsrMatrix.from_coo(IB, JB, rng.random(3000), n, n,
                              type=gb.FP64)
    IA2, JA2, _ = A.extractTuples()
    IB2, JB2, _ = B.extractTuples()
    exact = int(np.bincount(IB2, minlength=n)[JA2].sum())
    counters.reset()
    Cc = CsrMatrix.from_coo([], [], np.zeros(0), n, n, type=gb.FP64)
    mxm(Cc, None, None, semiring.plus_times[gb.FP64], A, B)
    assert counters._state["modelled_flops"] == exact


def test_chunked_spgemm_matches_single_program(rng):
    """Flop totals beyond the lane cap split into A-entry blocks whose
    partials monoid-merge to the identical result (the cap bounds
    each program's lanes and so its memory)."""
    import graphblas_tpu.sparse.esc as esc_mod
    from graphblas_tpu import sparse as sp
    r = np.random.default_rng(99)
    n = 400
    I = r.integers(0, n, 6000)
    J = r.integers(0, n, 6000)
    lin = np.unique(I * n + J)
    I, J = lin // n, lin % n
    va = (r.random(len(I)) * 3 - 1).astype(np.float32)
    A = sp.CsrMatrix.from_coo(I, J, va, n, n, type=gb.FP32,
                              sum_duplicates=False)
    Bv = (r.random(len(I)) * 2 + 1).astype(np.float32)
    B = sp.CsrMatrix.from_coo(J, I, Bv, n, n, type=gb.FP32,
                              sum_duplicates=False)
    MI = r.integers(0, n, 3000)
    MJ = r.integers(0, n, 3000)
    ml = np.unique(MI * n + MJ)
    M = sp.CsrMatrix.from_coo(ml // n, ml % n,
                              np.ones(len(ml), np.float32), n, n,
                              type=gb.FP32, sum_duplicates=False)
    sr = gb.semiring.plus_times[gb.FP32]
    for mask in (None, M):
        ref = esc_mod.csr_spgemm(sr, A, B, mask=mask)
        old = esc_mod._ESC_LANE_CAP
        esc_mod._ESC_LANE_CAP = 1 << 14       # force many blocks
        try:
            A2 = sp.CsrMatrix.from_coo(I, J, va, n, n, type=gb.FP32,
                                       sum_duplicates=False)
            got = esc_mod.csr_spgemm(sr, A2, B, mask=mask)
        finally:
            esc_mod._ESC_LANE_CAP = old
        ri, rj, rx = ref.extractTuples()
        gi, gj, gx = got.extractTuples()
        ro = np.lexsort((np.asarray(rj), np.asarray(ri)))
        go = np.lexsort((np.asarray(gj), np.asarray(gi)))
        assert np.array_equal(np.asarray(ri)[ro], np.asarray(gi)[go])
        assert np.array_equal(np.asarray(rj)[ro], np.asarray(gj)[go])
        np.testing.assert_allclose(np.asarray(rx)[ro],
                                   np.asarray(gx)[go], rtol=1e-5)
