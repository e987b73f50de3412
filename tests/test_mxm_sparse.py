"""gb.mxm dispatch on CsrMatrix containers: ESC engine + sparse
accum/mask epilogue vs the dense oracle (VERDICT round-2 #1/#2: stop
densifying, wire the cost model into dispatch)."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.core.descriptor import Descriptor
from graphblas_tpu.core.semirings import semiring
from graphblas_tpu.core.types import BOOL, FP32, FP64, INT32
from graphblas_tpu.ops.flopcount import choose_axb_method, last_axb_method
from graphblas_tpu.ops.mxm import mxm
from graphblas_tpu.sparse.container import CsrMatrix
from graphblas_tpu.sparse.mask import csr_accum_mask

import tests.oracle as orc
from tests.helpers import rand_om
from tests.test_esc import to_csr, csr_to_om, check


# ---------------------------------------------------------------------------
# cost-model regimes (one asserted method per regime, VERDICT #2 'done')
# ---------------------------------------------------------------------------

def test_choose_axb_regimes():
    # small dense-ish: the matmul bitmap engine
    assert choose_axb_method(512, 512, 512, 80_000, 80_000) == "dense-mxu"
    # small + sparse mask: the bitpack dot engine
    assert choose_axb_method(8192, 8192, 8192, 100_000, 100_000,
                             mnnz=50_000) == "bitpack"
    # small + clustered tiles: BSR
    assert choose_axb_method(8192, 8192, 8192, 500_000, 500_000,
                             ntile_triples=40) == "bsr"
    # large dimension: dense infeasible -> ESC regardless
    assert choose_axb_method(1 << 20, 1 << 20, 1 << 20,
                             1 << 22, 1 << 22) == "esc"
    # large + mask: still ESC (dense arrays impossible)
    assert choose_axb_method(1 << 20, 1 << 20, 1 << 20, 1 << 22, 1 << 22,
                             mnnz=1 << 20) == "esc"


def test_mxm_csr_routes_to_esc(rng):
    n = 100_000
    nnz = 2000
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    X = rng.random(nnz).astype(np.float32)
    A = CsrMatrix.from_coo(I, J, X, n, n, type=FP32)
    C = mxm(gb.sparse.csr_clear(A), None, None, semiring.plus_times[FP32],
            A, A)
    assert isinstance(C, CsrMatrix)
    assert last_axb_method() == "esc:csr_spgemm"


def test_mxm_csr_small_routes_dense(rng):
    # tiny + dense-ish: the cost model picks the matmul engine even for
    # CSR containers (output still comes back as CsrMatrix)
    A = rand_om(rng, (40, 40), np.float32, density=0.5)
    Ac = to_csr(A, FP32)
    C = mxm(gb.sparse.csr_clear(Ac), None, None,
            semiring.plus_times[FP32], Ac, Ac)
    assert isinstance(C, CsrMatrix)
    assert last_axb_method().startswith("mxu:")
    expect = orc.o_mxm("plus", "times", np.float32, A, A)
    check(csr_to_om(C), expect, np.float32)


# ---------------------------------------------------------------------------
# the sparse epilogue correctness surface: accum x mask x scmp x replace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum_name", [None, "plus", "second", "max"])
@pytest.mark.parametrize("maskmode", ["none", "mask", "scmp"])
@pytest.mark.parametrize("replace", [False, True])
def test_mxm_csr_epilogue_sweep(rng, accum_name, maskmode, replace):
    t = FP64
    dtype = np.float64
    A = rand_om(rng, (15, 12), dtype, density=0.35)
    B = rand_om(rng, (12, 18), dtype, density=0.35)
    C0 = rand_om(rng, (15, 18), dtype, density=0.3)
    M = rand_om(rng, (15, 18), dtype, density=0.5) \
        if maskmode != "none" else None
    accum = gb.binary[accum_name][t] if accum_name else None
    d = Descriptor(replace=replace, mask_scmp=(maskmode == "scmp"))
    got = mxm(to_csr(C0, t), to_csr(M, t) if M is not None else None,
              accum, semiring.plus_times[t], to_csr(A, t), to_csr(B, t),
              d)
    T = orc.o_mxm("plus", "times", dtype, A, B)
    expect = orc.o_accum_mask(C0, M, T, accum_name, dtype, dtype,
                              replace=replace, scmp=(maskmode == "scmp"))
    check(csr_to_om(got), expect, dtype)


@pytest.mark.parametrize("tran0,tran1", [(True, False), (False, True),
                                         (True, True)])
def test_mxm_csr_transposes(rng, tran0, tran1):
    t = FP32
    A = rand_om(rng, (9, 14), np.float32, density=0.4)
    B = rand_om(rng, (11, 14) if tran1 else (14, 11), np.float32,
                density=0.4)
    if tran0:
        A = orc.OM(A.m.T.copy(), A.p.T.copy())  # store A', compute A
        Astore, Aeff = A, orc.OM(A.m.T, A.p.T)
    else:
        Astore = Aeff = A
    Beff = orc.OM(B.m.T, B.p.T) if tran1 else B
    d = Descriptor(tran0=tran0, tran1=tran1)
    m, n = Aeff.p.shape[0], Beff.p.shape[1]
    C0 = orc.OM(np.zeros((m, n), np.float32), np.zeros((m, n), bool))
    got = mxm(to_csr(C0, t), None, None, semiring.plus_times[t],
              to_csr(Astore, t), to_csr(B, t), d)
    expect = orc.o_mxm("plus", "times", np.float32, Aeff, Beff)
    check(csr_to_om(got), expect, np.float32)


def test_csr_accum_mask_structural(rng):
    """Structural masks select on pattern, ignoring explicit zeros."""
    t = INT32
    C0 = rand_om(rng, (10, 10), np.int32, density=0.3)
    T = rand_om(rng, (10, 10), np.int32, density=0.4)
    M = rand_om(rng, (10, 10), np.int32, density=0.5)
    M.m[M.p] = 0  # all explicit zeros: valued mask = empty, structural = full
    d = Descriptor(mask_structure=True)
    got = csr_accum_mask(to_csr(C0, t), to_csr(M, t), to_csr(T, t),
                         None, d)
    # oracle with structural semantics: mk = M.p
    r = np.where(M.p, T.m, C0.m)
    rp = np.where(M.p, T.p, C0.p)
    expect = orc.OM(np.where(rp, r, 0), rp)
    check(csr_to_om(got), expect, np.int32)


def test_mxm_csr_mixed_containers(rng):
    """Bitmap A/B with CSR C: inputs convert, output stays sparse."""
    from tests.helpers import to_gb
    t = FP32
    A = rand_om(rng, (20, 20), np.float32, density=0.3)
    C0 = orc.OM(np.zeros((20, 20), np.float32), np.zeros((20, 20), bool))
    got = mxm(to_csr(C0, t), None, None, semiring.plus_times[t],
              to_gb(A, t), to_gb(A, t))
    assert isinstance(got, CsrMatrix)
    expect = orc.o_mxm("plus", "times", np.float32, A, A)
    check(csr_to_om(got), expect, np.float32)
