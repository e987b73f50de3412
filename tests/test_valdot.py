"""Value-panel masked SpGEMM (sparse/valdot.py): numeric semirings
through the heavy/light split, checked against the ESC engine (which is
itself differential-tested against the dense oracle).

Reference counterpart: the generated memory-speed semiring workers
(``Source/Generated/GB_AxB__plus_times_fp32.c``, ``GB_AxB_dot.c``).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import graphblas_tpu as gb
from graphblas_tpu import sparse as sp
from graphblas_tpu.core.semirings import semiring
from graphblas_tpu.sparse.esc import csr_spgemm
from graphblas_tpu.sparse.valdot import (build_valdot_plan,
                                         valdot_masked_spgemm)


def _powerlaw(rng, n=600, alpha=1.2, mult=3):
    deg = np.minimum((rng.pareto(alpha, n) * mult).astype(int) + 1, n - 1)
    I = np.repeat(np.arange(n), deg)
    J = rng.integers(0, n, size=len(I))
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    return lin // n, lin % n, n


def _valued_csr(rng, I, J, n, t=None, dtype=np.float32, vals=None):
    t = t or gb.FP32
    if vals is None:
        vals = (rng.random(len(I)) * 4 - 2).astype(dtype)
        if np.issubdtype(dtype, np.integer):
            vals = rng.integers(1, 9, len(I)).astype(dtype)
    return sp.CsrMatrix.from_coo(I, J, vals, n, n, type=t,
                                 sum_duplicates=False)


def _tosets(C):
    I, J, X = C.extractTuples()
    order = np.lexsort((np.asarray(J), np.asarray(I)))
    return (np.asarray(I)[order], np.asarray(J)[order],
            np.asarray(X)[order])


def _check(sr, A, B, M, exact, **kw):
    ref = csr_spgemm(sr, A, B, mask=M)
    got = valdot_masked_spgemm(sr, A, B, M, **kw)
    assert got is not None
    ri, rj, rx = _tosets(ref)
    gi, gj, gx = _tosets(got)
    assert np.array_equal(ri, gi) and np.array_equal(rj, gj), \
        (len(ri), len(gi))
    if exact:
        assert np.array_equal(rx, gx)
    else:
        np.testing.assert_allclose(rx, gx, rtol=2e-5, atol=2e-6)
    return got


@pytest.fixture
def graph():
    r = np.random.default_rng(77)
    I, J, n = _powerlaw(r, n=500)
    lo = I > J
    return r, I, J, n, lo


def _mk(graph, dtype, t):
    r, I, J, n, lo = graph
    L = _valued_csr(r, I[lo], J[lo], n, t, dtype)
    U = _valued_csr(r, J[lo], I[lo], n, t, dtype)
    M = _valued_csr(r, I[lo], J[lo], n, t, dtype)
    return L, U, M


@pytest.mark.parametrize("srname,dtype,t,exact", [
    ("plus_times", np.float32, None, False),
    ("plus_times", np.int32, "INT32", True),
    ("min_plus", np.float32, None, False),
    ("max_times", np.float64, "FP64", False),
    ("plus_pair", np.float32, None, True),
])
def test_valdot_matches_esc(graph, srname, dtype, t, exact):
    t = getattr(gb, t) if isinstance(t, str) else gb.FP32
    L, U, M = _mk(graph, dtype, t)
    sr = semiring[srname][t]
    ref = csr_spgemm(sr, L, U, mask=M)
    plan = build_valdot_plan(M, L, U, sr, min_lanes=1)
    assert plan is not None
    got = valdot_masked_spgemm(sr, L, U, M)
    if got is None:     # auto gate refused (small graph): force plan
        import graphblas_tpu.sparse.bitdot as bd
        old = bd._MIN_LANES
        bd._MIN_LANES = 1
        try:
            M._options.pop(("valdot_plan", sr.xtype.name,
                            sr.ytype.name), None)
            got = valdot_masked_spgemm(sr, L, U, M)
        finally:
            bd._MIN_LANES = old
    assert got is not None
    ri, rj, rx = _tosets(ref)
    gi, gj, gx = _tosets(got)
    assert np.array_equal(ri, gi) and np.array_equal(rj, gj)
    if exact:
        assert np.array_equal(rx, gx)
    else:
        np.testing.assert_allclose(rx, gx, rtol=2e-5, atol=2e-6)


def test_valdot_valued_mask_truthiness(graph):
    # falsy mask values must not produce output entries
    r, I, J, n, lo = graph
    import graphblas_tpu.sparse.bitdot as bd
    L = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
    U = _valued_csr(r, J[lo], I[lo], n, gb.FP32, np.float32)
    mv = r.random(int(lo.sum())).astype(np.float32)
    mv[mv < 0.5] = 0.0                      # half the mask is falsy
    M = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32, vals=mv)
    sr = semiring.plus_times[gb.FP32]
    old = bd._MIN_LANES
    bd._MIN_LANES = 1
    try:
        ref = csr_spgemm(sr, L, U, mask=M)
        got = valdot_masked_spgemm(sr, L, U, M)
    finally:
        bd._MIN_LANES = old
    assert got is not None
    ri, rj, rx = _tosets(ref)
    gi, gj, gx = _tosets(got)
    assert np.array_equal(ri, gi) and np.array_equal(rj, gj)
    np.testing.assert_allclose(rx, gx, rtol=2e-5, atol=2e-6)


def test_valdot_refuses_small_and_udt():
    I = np.array([1, 2, 2, 3, 3, 3])
    J = np.array([0, 0, 1, 0, 1, 2])
    A = sp.CsrMatrix.from_coo(I, J, np.ones(6, np.float32), 4, 4,
                              type=gb.FP32, sum_duplicates=False)
    sr = semiring.plus_times[gb.FP32]
    # tiny wedge count: the plan refuses, caller must fall back
    assert valdot_masked_spgemm(sr, A, A, A) is None


def test_valdot_plan_cache(graph):
    r, I, J, n, lo = graph
    import graphblas_tpu.sparse.bitdot as bd
    L = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
    U = _valued_csr(r, J[lo], I[lo], n, gb.FP32, np.float32)
    M = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
    sr = semiring.plus_times[gb.FP32]
    old = bd._MIN_LANES
    bd._MIN_LANES = 1
    try:
        c1 = valdot_masked_spgemm(sr, L, U, M)
        key = ("valdot_plan", "FP32", "FP32")
        entry = M._options.get(key)
        c2 = valdot_masked_spgemm(sr, L, U, M)
        assert M._options.get(key) is entry       # no rebuild
        assert np.array_equal(np.asarray(c1.values[:c1.nvals]),
                              np.asarray(c2.values[:c2.nvals]))
    finally:
        bd._MIN_LANES = old


def test_fast_path_and_nonfinite_guard(graph):
    # finite values: the plus_times fast path (no bitmap reduce) must
    # equal the bits path; with an inf value the plan must fall back
    # to the bits path (zero pads would poison inf*0)
    r, I, J, n, lo = graph
    import graphblas_tpu.sparse.bitdot as bd
    sr = semiring.plus_times[gb.FP32]
    old = bd._MIN_LANES
    bd._MIN_LANES = 1
    try:
        L = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
        U = _valued_csr(r, J[lo], I[lo], n, gb.FP32, np.float32)
        M = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
        plan_key = ("valdot_plan", "FP32", "FP32")
        got = valdot_masked_spgemm(sr, L, U, M)
        assert M._options[plan_key][-1].finite_ok
        ref = csr_spgemm(sr, L, U, mask=M)
        np.testing.assert_allclose(
            np.sort(np.asarray(got.values[:got.nvals])),
            np.sort(np.asarray(ref.values[:ref.nvals])), rtol=2e-5)
        # inject an inf into U -> plan must detect and use bits
        vals = np.asarray(U.values[:U.nvals]).copy()
        vals[0] = np.inf
        hp = U._options["host_pattern"]
        U2 = sp.CsrMatrix.from_coo(hp[0][:U.nvals], hp[1][:U.nvals],
                                   vals, n, n, type=gb.FP32,
                                   sum_duplicates=False)
        M2 = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
        got2 = valdot_masked_spgemm(sr, L, U2, M2)
        assert not M2._options[plan_key][-1].finite_ok
        ref2 = csr_spgemm(sr, L, U2, mask=M2)
        g = np.sort(np.asarray(got2.values[:got2.nvals]))
        rr = np.sort(np.asarray(ref2.values[:ref2.nvals]))
        fin = np.isfinite(rr)
        assert got2.nvals == ref2.nvals
        np.testing.assert_allclose(g[fin], rr[fin], rtol=2e-5)
        assert np.array_equal(np.isfinite(g), fin)
    finally:
        bd._MIN_LANES = old


def test_public_mxm_routes_through_valdot():
    # the masked CSR mxm auto-select must try valdot and record it
    # (graph large enough that the dense-matmul small-scale path bows out:
    # m*n > 2^24)
    r = np.random.default_rng(55)
    I, J, n = _powerlaw(r, n=6000, mult=4)
    lo = I > J
    import graphblas_tpu.sparse.bitdot as bd
    from graphblas_tpu.ops.mxm import mxm
    from graphblas_tpu.ops.flopcount import last_axb_method
    from graphblas_tpu.core.descriptor import Descriptor
    L = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
    U = _valued_csr(r, J[lo], I[lo], n, gb.FP32, np.float32)
    M = _valued_csr(r, I[lo], J[lo], n, gb.FP32, np.float32)
    C0 = sp.CsrMatrix.from_coo(np.array([], int), np.array([], int),
                               np.array([], np.float32), n, n,
                               type=gb.FP32)
    old = bd._MIN_LANES
    bd._MIN_LANES = 1
    try:
        C = mxm(C0, M, None, "plus_times", L, U)
        assert last_axb_method().startswith("valdot")
        # the explicit gustavson/heap hint must bypass valdot
        C2 = mxm(C0, M, None, "plus_times", L, U,
                 Descriptor(axb_method="gustavson"))
        assert last_axb_method().startswith("esc")
        assert C.nvals == C2.nvals
        gi, gj, gx = _tosets(C)
        ei, ej, ex = _tosets(C2)
        assert np.array_equal(gi, ei) and np.array_equal(gj, ej)
        np.testing.assert_allclose(gx, ex, rtol=5e-5, atol=1e-4)
    finally:
        bd._MIN_LANES = old


@pytest.mark.parametrize("dtype,t", [(np.float32, "FP32"),
                                     (np.int32, "INT32")])
def test_valdot_pass_matches_numpy(dtype, t):
    """The XLA gathered-row masked dot over padded live lists vs a numpy
    oracle: nlive < E, lanes with a negative panel row contribute the
    identity, both the bitmap-masked pass and the plus_times fast path
    (zero pads), f32 to roundoff and int32 exactly."""
    from graphblas_tpu.sparse.valdot import _slot_words, _valdot_pass
    r = np.random.default_rng(5)
    sr = semiring.plus_times[getattr(gb, t)]
    na, nb, S = 96, 80, 1024
    W = _slot_words(S)
    Ab = r.integers(0, 1 << 32, (na, W), dtype=np.uint64).astype(np.uint32)
    Bb = r.integers(0, 1 << 32, (nb, W), dtype=np.uint64).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)

    def bits(words):
        return (((words[:, :, None] >> shifts) & 1) != 0
                ).reshape(len(words), W * 32)[:, :S]

    # values live only under their row's bits, as the plan packs them
    Av = (r.integers(1, 7, (na, S)) * bits(Ab)).astype(dtype)
    Bv = (r.integers(1, 7, (nb, S)) * bits(Bb)).astype(dtype)
    E, nlive = 384, 301
    ai = r.integers(-1, na, E).astype(np.int32)
    bj = r.integers(0, nb, E).astype(np.int32)
    want = np.zeros(E, np.float64)
    ok = np.arange(E) < nlive
    ok &= ai >= 0
    want[ok] = np.einsum("es,es->e", Av[ai[ok]].astype(np.float64),
                         Bv[bj[ok]].astype(np.float64))
    for use_bits in (True, False):
        got = np.asarray(_valdot_pass(
            sr, jnp.asarray(Av), jnp.asarray(Bv), jnp.asarray(Ab),
            jnp.asarray(Bb), jnp.asarray(ai), jnp.asarray(bj), nlive,
            use_bits=use_bits))
        assert got.shape == (E,)
        if dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert np.array_equal(got, want.astype(np.int64))
