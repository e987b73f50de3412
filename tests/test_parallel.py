"""Distributed ops/algorithms on the 8-virtual-device CPU mesh
(conftest forces JAX_PLATFORMS=cpu + 8 host devices, mirroring the
driver's multichip dryrun environment)."""

import jax
import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import parallel as par
from graphblas_tpu.core.semirings import semiring


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should give 8 cpu devices"
    return par.make_mesh(8)


@pytest.fixture(scope="module")
def mesh2d():
    return par.make_mesh(8, shape=(4, 2), axis_names=("i", "j"))


def _random_graph(n, p, seed, symmetric=True):
    rng = np.random.default_rng(seed)
    Ap = rng.random((n, n)) < p
    np.fill_diagonal(Ap, False)
    if symmetric:
        Ap = Ap | Ap.T
    return gb.Matrix.from_dense(Ap.astype(np.float64), gb.FP64, pattern=Ap)


def test_distribute_collect_roundtrip(mesh):
    A = _random_graph(37, 0.2, 0)  # 37 not divisible by 8: exercises pad
    D = par.distribute(A, mesh)
    B = par.collect(D)
    assert np.array_equal(A.pattern_np(), B.pattern_np())
    assert np.allclose(A.to_dense(), B.to_dense())


def test_dist_vxm_matches_local(mesh):
    A = _random_graph(40, 0.2, 1)
    u = gb.Vector.from_dense(np.arange(40, dtype=np.float64))
    want = gb.vxm(gb.Vector.new(gb.FP64, 40), None, None,
                  semiring.plus_times[gb.FP64], u, A)
    D = par.distribute(A, mesh)
    du = par.distribute(u, mesh, spec=par.P("i"))
    w = par.dist_vxm(semiring.plus_times[gb.FP64], du, D)
    got = par.collect(w)
    assert np.allclose(got.to_dense(), want.to_dense())
    assert np.array_equal(got.pattern_np(), want.pattern_np())


def test_dist_vxm_bool_lor_land(mesh):
    A = _random_graph(24, 0.3, 2)
    Ab = gb.Matrix(A.pattern, A.pattern, gb.BOOL)
    q = np.zeros(24, bool)
    q[3] = True
    u = gb.Vector.from_dense(q, gb.BOOL, pattern=q)
    want = gb.vxm(gb.Vector.new(gb.BOOL, 24), None, None,
                  semiring.lor_land[gb.BOOL], u, Ab)
    du = par.distribute(u, mesh, spec=par.P("i"))
    D = par.distribute(Ab, mesh)
    got = par.collect(par.dist_vxm(semiring.lor_land[gb.BOOL], du, D))
    assert np.array_equal(got.to_dense() != 0, want.to_dense() != 0)


def test_dist_mxm_masked(mesh):
    A = _random_graph(32, 0.25, 3)
    want = gb.mxm(gb.Matrix.new(gb.FP64, 32, 32), A, None,
                  semiring.plus_times[gb.FP64], A, A)
    D = par.distribute(A, mesh)
    C = par.dist_mxm(semiring.plus_times[gb.FP64], D, D, M=D)
    got = par.collect(C)
    assert np.allclose(got.to_dense(), want.to_dense())


def test_dist_mxm_summa(mesh2d):
    A = _random_graph(32, 0.25, 4)
    B = _random_graph(32, 0.25, 5)
    want = gb.mxm(gb.Matrix.new(gb.FP64, 32, 32), None, None,
                  semiring.plus_times[gb.FP64], A, B)
    DA = par.distribute(A, mesh2d)
    DB = par.distribute(B, mesh2d)
    got = par.collect(par.dist_mxm_summa(semiring.plus_times[gb.FP64],
                                         DA, DB))
    assert np.allclose(got.to_dense(), want.to_dense())


@pytest.fixture(scope="module")
def mesh_sq():
    return par.make_mesh(4, shape=(2, 2), axis_names=("i", "j"))


def test_dist_mxm_summa_kstep(mesh_sq):
    """Square mesh -> the k-step pipeline (block broadcasts per step)
    must match the dense product for both a ring and a plus-times
    semiring."""
    A = _random_graph(40, 0.3, 14)
    B = _random_graph(40, 0.3, 15)
    for srname in ("plus_times", "min_plus"):
        sr = semiring[srname][gb.FP64]
        want = gb.mxm(gb.Matrix.new(gb.FP64, 40, 40), None, None,
                      sr, A, B)
        DA = par.distribute(A, mesh_sq)
        DB = par.distribute(B, mesh_sq)
        got = par.collect(par.dist_mxm_summa(sr, DA, DB))
        assert np.allclose(got.to_dense(), want.to_dense()), srname
        assert np.array_equal(got.pattern_np(), want.pattern_np()), srname


def test_dist_mxm_bshard_matches_replicated(mesh):
    A = _random_graph(48, 0.2, 16)
    B = _random_graph(48, 0.2, 17)
    Mk = _random_graph(48, 0.4, 18)
    sr = semiring.plus_times[gb.FP64]
    DA = par.distribute(A, mesh)
    DB = par.distribute(B, mesh)
    DM = par.distribute(Mk, mesh)
    want = par.collect(par.dist_mxm(sr, DA, DB, M=DM))
    got = par.collect(par.dist_mxm_bshard(sr, DA, DB, M=DM))
    assert np.allclose(got.to_dense(), want.to_dense())
    assert np.array_equal(got.pattern_np(), want.pattern_np())


def test_dist_bfs(mesh):
    A = _random_graph(50, 0.08, 6)
    from graphblas_tpu import models
    want = models.bfs_jit(A, 0)
    got = par.dist_bfs(A, 0, mesh)
    assert np.array_equal(got, want)


def test_dist_pagerank(mesh):
    A = _random_graph(40, 0.15, 7)
    from graphblas_tpu import models
    want = models.pagerank_jit(A, iters=20)
    got = par.dist_pagerank(A, iters=20, mesh=mesh)
    assert np.allclose(got, want, atol=1e-10)


def test_dist_tricount(mesh):
    A = _random_graph(48, 0.2, 8)
    Ap = A.pattern_np()
    want = int(((Ap.astype(np.int64) @ Ap) * Ap).sum()) // 6
    got = par.dist_tricount(A, mesh)
    assert got == want


def test_step_functions_compile(mesh):
    # the dryrun surface: single sharded steps compile and run
    n = 16
    Ap = _random_graph(n, 0.3, 9).pattern
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    Apd = jax.device_put(Ap, NamedSharding(mesh, par.P("i", None)))
    step = par.bfs_step_sharded(mesh)
    v = jnp.zeros((n,), jnp.int32)
    q = jnp.zeros((n,), bool).at[0].set(True)
    v2, q2 = step(v, q, Apd, jnp.int32(1))
    assert bool(v2[0] == 1)
    pstep = par.pagerank_step_sharded(mesh)
    Cv = jax.device_put(jnp.asarray(np.random.default_rng(0).random(
        (n, n))), NamedSharding(mesh, par.P("i", None)))
    r = jnp.full((n,), 1.0 / n)
    r2 = pstep(Cv, r, jnp.asarray(0.15 / n))
    assert np.isfinite(np.asarray(r2)).all()


# ---------------------------------------------------------------------------
# sharded-CSR distribution (memory-scalable path)
# ---------------------------------------------------------------------------

def test_dist_csr_mxv(mesh):
    A = _random_graph(53, 0.15, 20)  # non-divisible by 8
    x = np.random.default_rng(0).random(53).astype(np.float32)
    D = par.dist_csr_from_matrix(A, mesh)
    y = np.asarray(par.dist_csr_mxv(D, x))
    want = (A.pattern_np() * A.to_dense()) @ x
    assert np.allclose(y, want, rtol=1e-5)


def test_dist_csr_pagerank(mesh):
    from graphblas_tpu import models
    A = _random_graph(40, 0.15, 21)
    want = models.pagerank_jit(A, iters=15)
    got = par.dist_csr_pagerank(A, iters=15, mesh=mesh)
    assert np.allclose(got, want, atol=1e-5)


def test_dist_csr_pagerank_csr_operand(mesh):
    """A CsrMatrix operand is row-scaled and transposed on the host
    (no densify) and matches the single-device CSR PageRank."""
    from graphblas_tpu import sparse as sp
    A = _random_graph(45, 0.12, 23)
    I, J, _ = A.extractTuples()
    Ac = sp.CsrMatrix.from_coo(np.asarray(I), np.asarray(J),
                               np.ones(len(I), bool), 45, 45,
                               type=gb.BOOL)
    got = par.dist_csr_pagerank(Ac, iters=15, mesh=mesh)
    want = sp.pagerank_csr(Ac, iters=15)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.allclose(got, par.dist_csr_pagerank(A, iters=15, mesh=mesh),
                       atol=1e-6)


def test_dist_csr_bfs(mesh):
    from graphblas_tpu import models
    A = _random_graph(60, 0.07, 22)
    want = models.bfs_jit(A, 0)
    got = par.dist_csr_bfs(A, 0, mesh)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# regression tests for review findings
# ---------------------------------------------------------------------------

def test_dist_vxm_min_plus_identity_combine(mesh):
    # a column whose only contribution lives on one shard must not be
    # poisoned by other shards' zero-filled absent partials
    n = 16
    Ap = np.zeros((n, n), bool)
    Ap[0, 5] = True          # only shard 0 contributes to column 5
    Ad = np.where(Ap, 5.0, 0.0)
    A = gb.Matrix.from_dense(Ad, gb.FP64, pattern=Ap)
    u = gb.Vector.from_dense(np.full(n, 1.0))
    sr = semiring.min_plus[gb.FP64]
    want = gb.vxm(gb.Vector.new(gb.FP64, n), None, None, sr, u, A)
    du = par.distribute(u, mesh, spec=par.P("i"))
    D = par.distribute(A, mesh)
    got = par.collect(par.dist_vxm(sr, du, D))
    assert got.extractElement(5) == want.extractElement(5) == 6.0


def test_dist_pagerank_nondivisible_n(mesh):
    from graphblas_tpu import models
    A = _random_graph(37, 0.2, 30)  # 37 % 8 != 0
    want = models.pagerank_jit(A, iters=20)
    got = par.dist_pagerank(A, iters=20, mesh=mesh)
    assert np.allclose(got, want, atol=1e-10)


def test_dist_mxm_valued_mask_and_rectangular(mesh):
    # valued mask: explicit zeros in M suppress output (default path)
    n = 16
    rng = np.random.default_rng(31)
    A = _random_graph(n, 0.4, 31)
    Mv = rng.integers(0, 2, (n, n)).astype(np.float64)
    Mp = np.ones((n, n), bool)
    M = gb.Matrix.from_dense(Mv, gb.FP64, pattern=Mp)
    want = gb.mxm(gb.Matrix.new(gb.FP64, n, n), M, None,
                  semiring.plus_times[gb.FP64], A, A)
    D = par.distribute(A, mesh)
    DM = par.distribute(M, mesh)
    got = par.collect(par.dist_mxm(semiring.plus_times[gb.FP64], D, D,
                                   M=DM))
    assert np.array_equal(got.pattern_np(), want.pattern_np())
    assert np.allclose(got.to_dense(), want.to_dense())
    # rectangular unmasked product must not shape-error
    B = gb.Matrix.from_dense(np.random.default_rng(32).random((n, 24)))
    DB = par.distribute(B, mesh, spec=par.P(None, None))
    got2 = par.collect(par.dist_mxm(semiring.plus_times[gb.FP64], D, DB))
    assert got2.shape == (n, 24)


# ---------------------------------------------------------------------------
# round 3: distributed generality (VERDICT round-2 next #8)
# ---------------------------------------------------------------------------

def _rand_pair(n, density, seed):
    rng = np.random.default_rng(seed)
    Ap = rng.random((n, n)) < density
    Bp = rng.random((n, n)) < density
    Av = np.where(Ap, rng.normal(size=(n, n)), 0.0)
    Bv = np.where(Bp, rng.normal(size=(n, n)), 0.0)
    return Ap, Av, Bp, Bv


@pytest.mark.parametrize("srname,ty", [
    ("plus_times", "FP64"), ("min_plus", "FP64"), ("max_times", "FP64"),
    ("plus_pair", "INT32"), ("lor_land", "BOOL"),
    ("lxor_land", "BOOL"),   # LXOR: no scatter fold -> generic sort path
])
def test_dist_masked_spgemm_semirings(mesh, srname, ty):
    from graphblas_tpu.core.semirings import semiring
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.esc import csr_spgemm
    t = getattr(gb, ty)
    n = 96
    Ap, Av, Bp, Bv = _rand_pair(n, 0.12, 11)
    rng = np.random.default_rng(12)
    Mp = rng.random((n, n)) < 0.3
    if t is gb.BOOL:
        Av, Bv = Ap, Bp
    elif t is gb.INT32:
        Av = (Av * 5).astype(np.int32)
        Bv = (Bv * 5).astype(np.int32)
    I, J = np.nonzero(Ap)
    A = CsrMatrix.from_coo(I, J, Av[I, J], n, n, type=t)
    I, J = np.nonzero(Bp)
    B = CsrMatrix.from_coo(I, J, Bv[I, J], n, n, type=t)
    I, J = np.nonzero(Mp)
    M = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL)
    sr = getattr(semiring, srname)[t]
    got = par.dist_masked_spgemm(sr, A, B, M, mesh=mesh)
    want = csr_spgemm(sr, A, B, mask=M)
    gI, gJ, gX = got.extractTuples()
    wI, wJ, wX = want.extractTuples()
    assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
    if t is gb.FP64:
        assert np.allclose(np.asarray(gX), np.asarray(wX), rtol=1e-12)
    else:
        assert np.array_equal(np.asarray(gX), np.asarray(wX))


def test_dist_spgemm_unmasked(mesh):
    from graphblas_tpu.core.semirings import semiring
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.esc import csr_spgemm
    n = 80
    Ap, Av, Bp, Bv = _rand_pair(n, 0.1, 13)
    I, J = np.nonzero(Ap)
    A = CsrMatrix.from_coo(I, J, Av[I, J], n, n, type=gb.FP64)
    I, J = np.nonzero(Bp)
    B = CsrMatrix.from_coo(I, J, Bv[I, J], n, n, type=gb.FP64)
    sr = semiring.plus_times[gb.FP64]
    got = par.dist_spgemm(sr, A, B, mesh=mesh)
    want = csr_spgemm(sr, A, B)
    gI, gJ, gX = got.extractTuples()
    wI, wJ, wX = want.extractTuples()
    assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
    assert np.allclose(np.asarray(gX), np.asarray(wX), rtol=1e-12)


def test_dist_csr_mxv_udt_vector(mesh):
    """Distributed UDT SpMV: one PageRank-semiring step over the mesh
    vs the single-chip csr_mxv UDT path (dpagerank2_csr machinery)."""
    import jax.numpy as jnp
    from graphblas_tpu.core.ops import BinaryOp
    from graphblas_tpu.core.semirings import semiring_new
    from graphblas_tpu.models.pagerank import PAGERANK_TYPE, pagerank_ops
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.spmv import csr_mxv
    n = 64
    rng = np.random.default_rng(15)
    Ap = rng.random((n, n)) < 0.15
    np.fill_diagonal(Ap, False)
    I, J = np.nonzero(Ap.T)  # A' rows for the vxm form
    AT = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                            type=gb.BOOL)
    pr_mult, _, pr_monoid, _ = pagerank_ops()
    flip = BinaryOp("PR_FLIP", lambda a, x: pr_mult.fn(x, a),
                    PAGERANK_TYPE, gb.BOOL, PAGERANK_TYPE)
    sr = semiring_new(pr_monoid, flip)
    deg = Ap.sum(1).astype(np.float64)
    r = {"rank": jnp.asarray(np.full(n, 1.0 / n)),
         "invdegree": jnp.asarray(1.0 / np.maximum(deg, 1.0))}
    want, _ = csr_mxv(sr, AT, r)
    D = par.dist_csr_from_matrix(AT, mesh)
    got = par.dist_csr_mxv(D, r, sr)
    assert np.allclose(np.asarray(got["rank"]),
                       np.asarray(want["rank"]), rtol=1e-12)


def test_dist_csr_udt_matrix_values(mesh):
    """DistCsr holding UDT struct values (round 3): SpMV with a UDT
    matrix against the single-chip UDT kernel."""
    import jax.numpy as jnp
    from graphblas_tpu.core.ops import BinaryOp
    from graphblas_tpu.core.monoids import monoid_new
    from graphblas_tpu.core.semirings import semiring_new
    from graphblas_tpu.core.types import Type
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.spmv import csr_mxv
    W = Type.udt("wt", a=gb.FP64, b=gb.FP64)
    n = 48
    rng = np.random.default_rng(16)
    Ap = rng.random((n, n)) < 0.2
    I, J = np.nonzero(Ap)
    vals = {"a": rng.normal(size=len(I)), "b": rng.normal(size=len(I))}
    A = CsrMatrix.from_coo(I, J, vals, n, n, type=W,
                           sum_duplicates=False)
    mult = BinaryOp("WMULT", lambda e, x: {
        "a": e["a"] * x, "b": e["b"] + x}, W, W, gb.FP64)
    add = BinaryOp("WADD", lambda x, y: {
        "a": x["a"] + y["a"], "b": jnp.maximum(x["b"], y["b"])}, W, W, W)
    mon = monoid_new(add, {"a": 0.0, "b": -np.inf})
    sr = semiring_new(mon, mult)
    x = jnp.asarray(rng.normal(size=n))
    want, _ = csr_mxv(sr, A, x)
    D = par.dist_csr_from_matrix(A, mesh)
    got = par.dist_csr_mxv(D, x, sr)
    assert np.allclose(np.asarray(got["a"]), np.asarray(want["a"]),
                       rtol=1e-12)
    assert np.allclose(np.asarray(got["b"]), np.asarray(want["b"]),
                       rtol=1e-12)
