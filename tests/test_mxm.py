"""Differential tests for mxm/mxv/vxm vs the numpy oracle.

Mirrors the reference's Test/test{06,14,...}.m sweeps: semirings x types x
masks x accum x descriptors (SURVEY.md §4 Tier 2).
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from . import oracle as orc
from .helpers import TYPES, assert_same, rand_om, to_gb

# representative semiring sweep: all matmul fast paths + generic paths
SEMIRINGS = [
    ("plus", "times", "FP64"), ("plus", "times", "FP32"),
    ("plus", "times", "INT32"), ("plus", "times", "UINT32"),
    ("plus", "times", "INT8"), ("plus", "times", "UINT64"),
    ("plus", "first", "FP64"), ("plus", "second", "INT32"),
    ("plus", "land", "UINT32"), ("plus", "pair", "INT64"),
    ("lor", "land", "BOOL"), ("land", "lor", "BOOL"),
    ("lxor", "land", "BOOL"), ("lor", "first", "BOOL"),
    ("lor", "second", "BOOL"), ("land", "first", "BOOL"),
    ("eq", "eq", "BOOL"),
    ("min", "plus", "FP64"), ("max", "plus", "INT32"),
    ("min", "times", "FP32"), ("max", "first", "FP64"),
    ("min", "second", "INT16"), ("min", "max", "UINT8"),
    ("times", "plus", "INT32"), ("max", "div", "FP64"),
    ("min", "iseq", "FP64"), ("lor", "gt", "FP64"),
    ("land", "le", "INT32"), ("lxor", "ne", "FP32"),
]


@pytest.mark.parametrize("addn,multn,tname", SEMIRINGS)
def test_mxm_semirings(rng, addn, multn, tname):
    t = TYPES[tname]
    A = rand_om(rng, (5, 4), t.dtype, 0.6)
    B = rand_om(rng, (4, 6), t.dtype, 0.6)
    sr = gb.semiring[f"{addn}_{multn}"][t]
    want = orc.o_mxm(addn, multn, t.dtype, A, B)
    C0 = gb.Matrix.new(sr.ztype, 5, 6)
    got = gb.mxm(C0, None, None, sr, to_gb(A, t), to_gb(B, t))
    tol = 1e-5 if tname == "FP32" else 1e-12
    assert_same(got, want, tol=tol, msg=f"{addn}_{multn}_{tname}")


@pytest.mark.parametrize("scmp", [False, True])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("accum", [None, "plus", "second", "max"])
def test_mxm_mask_accum(rng, scmp, replace, accum):
    t = gb.FP64
    A = rand_om(rng, (5, 4), t.dtype, 0.5)
    B = rand_om(rng, (4, 5), t.dtype, 0.5)
    C = rand_om(rng, (5, 5), t.dtype, 0.5)
    M = rand_om(rng, (5, 5), np.bool_, 0.5)
    T = orc.o_mxm("plus", "times", t.dtype, A, B)
    want = orc.o_accum_mask(C, M, T, accum, t.dtype, t.dtype, replace, scmp)
    d = gb.Descriptor(replace=replace, mask_scmp=scmp)
    acc = gb.binary[accum][t] if accum else None
    got = gb.mxm(to_gb(C, t), to_gb(M, gb.BOOL), acc,
                 gb.semiring.plus_times[t], to_gb(A, t), to_gb(B, t), d)
    assert_same(got, want, tol=1e-12,
                msg=f"mask scmp={scmp} replace={replace} accum={accum}")


@pytest.mark.parametrize("tran0,tran1", [(True, False), (False, True),
                                         (True, True)])
def test_mxm_transpose_desc(rng, tran0, tran1):
    t = gb.FP32
    A = rand_om(rng, (4, 5) if tran0 else (5, 4), t.dtype, 0.6)
    B = rand_om(rng, (6, 4) if tran1 else (4, 6), t.dtype, 0.6)
    Ao = orc.OM(A.m.T, A.p.T) if tran0 else A
    Bo = orc.OM(B.m.T, B.p.T) if tran1 else B
    want = orc.o_mxm("plus", "times", t.dtype, Ao, Bo)
    d = gb.Descriptor(tran0=tran0, tran1=tran1)
    got = gb.mxm(gb.Matrix.new(t, 5, 6), None, None,
                 gb.semiring.plus_times[t], to_gb(A, t), to_gb(B, t), d)
    assert_same(got, want, tol=1e-5)


def test_mxv_vxm(rng):
    t = gb.FP64
    A = rand_om(rng, (5, 4), t.dtype, 0.6)
    u = rand_om(rng, (4,), t.dtype, 0.7)
    v5 = rand_om(rng, (5,), t.dtype, 0.7)
    # mxv: A*u
    want = orc.o_mxm("plus", "times", t.dtype,
                     A, orc.OM(u.m[:, None], u.p[:, None]))
    got = gb.mxv(gb.Vector.new(t, 5), None, None, gb.semiring.plus_times[t],
                 to_gb(A, t), to_gb(u, t))
    assert_same(got, orc.OM(want.m[:, 0], want.p[:, 0]), tol=1e-12)
    # vxm: v'*A
    want2 = orc.o_mxm("plus", "times", t.dtype,
                      orc.OM(v5.m[None, :], v5.p[None, :]), A)
    got2 = gb.vxm(gb.Vector.new(t, 4), None, None, gb.semiring.plus_times[t],
                  to_gb(v5, t), to_gb(A, t))
    assert_same(got2, orc.OM(want2.m[0], want2.p[0]), tol=1e-12)


def test_mxm_empty_and_typecast(rng):
    # empty B -> empty C; and input typecast int->fp64 semiring
    t = gb.FP64
    A = rand_om(rng, (3, 3), np.int32, 0.5)
    B = orc.OM(np.zeros((3, 3)), np.zeros((3, 3), bool))
    got = gb.mxm(gb.Matrix.new(t, 3, 3), None, None,
                 gb.semiring.plus_times[t], to_gb(A, gb.INT32),
                 to_gb(B, gb.FP64))
    assert got.nvals() == 0
    Acast = orc.OM(A.m.astype(np.float64), A.p)
    B2 = rand_om(rng, (3, 3), np.float64, 0.8)
    want = orc.o_mxm("plus", "times", np.float64, Acast, B2)
    got2 = gb.mxm(gb.Matrix.new(t, 3, 3), None, None,
                  gb.semiring.plus_times[t], to_gb(A, gb.INT32),
                  to_gb(B2, t))
    assert_same(got2, want, tol=1e-12)


def test_mxm_alias(rng):
    # C<C> = C*C must be legal (reference GB_mex_mxm_alias test)
    t = gb.BOOL
    C = rand_om(rng, (4, 4), np.bool_, 0.5)
    Cg = to_gb(C, t)
    want_T = orc.o_mxm("lor", "land", np.bool_, C, C)
    want = orc.o_accum_mask(C, C, want_T, None, np.bool_, np.bool_)
    got = gb.mxm(Cg, Cg, None, gb.semiring.lor_land[t], Cg, Cg)
    assert_same(got, want)
