"""Pure-numpy executable spec of GraphBLAS, independent of graphblas_tpu.

This is the analogue of the reference's MATLAB spec mimics
(``Test/GB_spec_*.m``): every operation is written as naive dense numpy
with explicit (matrix, pattern, class) handling, and test drivers compare
it against the JAX implementation — the reference's Tier-2 differential
testing strategy (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class OM:
    """Oracle matrix: dense values + pattern (GB_spec 'struct')."""
    m: np.ndarray   # values, zero at absent
    p: np.ndarray   # bool pattern

    def copy(self):
        return OM(self.m.copy(), self.p.copy())


def om(values, pattern=None):
    values = np.asarray(values)
    p = np.ones(values.shape, bool) if pattern is None else np.asarray(pattern, bool)
    v = np.where(p, values, np.zeros_like(values))
    return OM(v, p)


# ---- scalar ops (independent numpy semantics) -------------------------------

def _idiv(x, y, dtype):
    info = np.iinfo(dtype)
    signed = np.issubdtype(dtype, np.signedinteger)
    x = np.asarray(x, dtype)
    y = np.asarray(y, dtype)
    out = np.empty(np.broadcast_shapes(x.shape, y.shape), dtype)
    xb, yb = np.broadcast_arrays(x, y)
    with np.errstate(all="ignore"):
        flat = out.reshape(-1)
        xf = xb.reshape(-1)
        yf = yb.reshape(-1)
        for i in range(flat.size):
            xi, yi = int(xf[i]), int(yf[i])
            if yi == 0:
                flat[i] = 0 if xi == 0 else (info.min if xi < 0 else info.max)
            elif signed and yi == -1:
                flat[i] = np.asarray(-xi).astype(dtype)
            else:
                q = abs(xi) // abs(yi)
                if (xi < 0) != (yi < 0):
                    q = -q
                flat[i] = np.asarray(q).astype(dtype)
    return out


def binop(name, dtype):
    """Return a numpy fn for binary op `name` over dtype (z in dtype unless
    comparison)."""
    name = name.upper()
    isb = np.dtype(dtype) == np.bool_
    isint = np.issubdtype(dtype, np.integer)

    def W(f):  # wrap result to dtype
        return lambda x, y: np.asarray(f(np.asarray(x, dtype),
                                         np.asarray(y, dtype))).astype(dtype)
    if name == "FIRST":
        return lambda x, y: np.asarray(x, dtype)
    if name == "SECOND":
        return lambda x, y: np.asarray(y, dtype)
    if name == "PAIR":
        return lambda x, y: np.ones(np.broadcast_shapes(np.shape(x), np.shape(y)), dtype)
    if name == "MIN":
        return W(lambda x, y: x & y) if isb else W(np.fmin)
    if name == "MAX":
        return W(lambda x, y: x | y) if isb else W(np.fmax)
    if name == "PLUS":
        return W(lambda x, y: x | y) if isb else W(np.add)
    if name == "MINUS":
        return W(np.not_equal) if isb else W(np.subtract)
    if name == "RMINUS":
        return W(np.not_equal) if isb else W(lambda x, y: y - x)
    if name == "TIMES":
        return W(lambda x, y: x & y) if isb else W(np.multiply)
    if name == "DIV":
        if isb:
            return lambda x, y: np.asarray(x, dtype)
        if isint:
            return lambda x, y: _idiv(x, y, dtype)
        return W(lambda x, y: np.divide(x, y))
    if name == "RDIV":
        if isb:
            return lambda x, y: np.asarray(y, dtype)
        if isint:
            return lambda x, y: _idiv(y, x, dtype)
        return W(lambda x, y: np.divide(y, x))
    cmp = {"EQ": np.equal, "NE": np.not_equal, "GT": np.greater,
           "LT": np.less, "GE": np.greater_equal, "LE": np.less_equal}
    if name in cmp:
        return lambda x, y: cmp[name](np.asarray(x, dtype), np.asarray(y, dtype))
    if name.startswith("IS"):
        f = cmp[name[2:]]
        return lambda x, y: f(np.asarray(x, dtype),
                              np.asarray(y, dtype)).astype(dtype)
    logic = {"LOR": np.logical_or, "LAND": np.logical_and,
             "LXOR": np.logical_xor}
    if name in logic:
        f = logic[name]
        return lambda x, y: f(np.asarray(x) != 0,
                              np.asarray(y) != 0).astype(dtype)
    raise KeyError(name)


def unop(name, dtype):
    name = name.upper()
    isb = np.dtype(dtype) == np.bool_
    isint = np.issubdtype(dtype, np.integer)
    if name == "IDENTITY":
        return lambda x: np.asarray(x, dtype)
    if name == "AINV":
        if isb:
            return lambda x: np.asarray(x, dtype)
        return lambda x: (-np.asarray(x, dtype)).astype(dtype)
    if name == "MINV":
        if isb:
            return lambda x: np.ones_like(np.asarray(x, dtype))
        if isint:
            return lambda x: _idiv(np.ones_like(np.asarray(x, dtype)), x, dtype)
        return lambda x: (1.0 / np.asarray(x, dtype)).astype(dtype)
    if name == "LNOT":
        return lambda x: (~(np.asarray(x) != 0)).astype(dtype)
    if name == "ONE":
        return lambda x: np.ones_like(np.asarray(x, dtype))
    if name == "ABS":
        return lambda x: np.abs(np.asarray(x, dtype)).astype(dtype)
    raise KeyError(name)


_IDENT = {
    "PLUS": lambda dt: np.zeros((), dt)[()],
    "TIMES": lambda dt: np.ones((), dt)[()],
    "MIN": lambda dt: (np.bool_(True) if dt == np.bool_ else
                       (np.iinfo(dt).max if np.issubdtype(dt, np.integer)
                        else np.inf)),
    "MAX": lambda dt: (np.bool_(False) if dt == np.bool_ else
                       (np.iinfo(dt).min if np.issubdtype(dt, np.integer)
                        else -np.inf)),
    "LOR": lambda dt: np.bool_(False),
    "LAND": lambda dt: np.bool_(True),
    "LXOR": lambda dt: np.bool_(False),
    "EQ": lambda dt: np.bool_(True),
}


def identity_of(addname, dtype):
    return _IDENT[addname.upper()](np.dtype(dtype))


# ---- spec operations --------------------------------------------------------

def cast(x, dtype):
    dtype = np.dtype(dtype)
    x = np.asarray(x)
    if dtype == np.bool_:
        return x != 0
    if np.issubdtype(x.dtype, np.floating) and np.issubdtype(dtype, np.integer):
        x = np.where(np.isnan(x), 0, x)
        return np.trunc(x).astype(dtype)
    return x.astype(dtype)


def o_accum(accum_name, acc_dtype, C: OM, T: OM, c_dtype) -> OM:
    """GB_spec_accum."""
    if accum_name is None:
        z = np.zeros(C.m.shape, c_dtype)
        zp = T.p.copy()
        z[T.p] = cast(T.m[T.p], c_dtype)
        return OM(z, zp)
    f = binop(accum_name, acc_dtype)
    z = np.zeros(C.m.shape, c_dtype)
    both = C.p & T.p
    z[both] = cast(f(cast(C.m[both], acc_dtype), cast(T.m[both], acc_dtype)),
                   c_dtype)
    conly = C.p & ~T.p
    z[conly] = C.m[conly]
    tonly = T.p & ~C.p
    z[tonly] = cast(T.m[tonly], c_dtype)
    return OM(z, C.p | T.p)


def o_mask(C: OM, M: Optional[OM], Z: OM, replace=False, scmp=False) -> OM:
    """GB_spec_mask."""
    C = C.copy()
    if replace:
        Cm = np.zeros_like(C.m)
        Cp = np.zeros_like(C.p)
    else:
        Cm, Cp = C.m, C.p
    if M is None:
        if scmp:
            return OM(Cm, Cp)
        return Z.copy()
    mk = M.p & (M.m != 0)
    if scmp:
        mk = ~mk
    r = np.where(mk, Z.m, Cm)
    rp = np.where(mk, Z.p, Cp)
    r = np.where(rp, r, np.zeros_like(r))
    return OM(r, rp)


def o_accum_mask(C, M, T, accum_name, acc_dtype, c_dtype,
                 replace=False, scmp=False):
    if M is None and scmp:
        return o_mask(C, None, C, replace, scmp)
    Z = o_accum(accum_name, acc_dtype, C, T, c_dtype)
    return o_mask(C, M, Z, replace, scmp)


def o_mxm(addname, multname, dtype, A: OM, B: OM) -> OM:
    """naive triple-loop (broadcast) semiring matmul; z dtype = mult ztype."""
    mult = binop(multname, dtype)
    ztest = mult(np.zeros((), dtype), np.zeros((), dtype))
    zdt = np.asarray(ztest).dtype
    add = binop(addname, zdt)
    ident = identity_of(addname, zdt)
    m, k = A.p.shape
    n = B.p.shape[1]
    out = np.full((m, n), ident, zdt)
    outp = np.zeros((m, n), bool)
    a = cast(A.m, dtype)
    b = cast(B.m, dtype)
    for kk in range(k):
        pair = A.p[:, kk][:, None] & B.p[kk, :][None, :]
        z = mult(np.broadcast_to(a[:, kk][:, None], (m, n)),
                 np.broadcast_to(b[kk, :][None, :], (m, n)))
        out = np.where(pair, add(out, np.asarray(z, zdt)), out)
        outp |= pair
    out = np.where(outp, out, np.zeros_like(out))
    return OM(out.astype(zdt), outp)


def o_ewise(opname, dtype, A: OM, B: OM, union: bool) -> OM:
    f = binop(opname, dtype)
    ztest = f(np.zeros((), dtype), np.zeros((), dtype))
    zdt = np.asarray(ztest).dtype
    both = A.p & B.p
    out = np.zeros(A.m.shape, zdt)
    out[both] = np.asarray(f(cast(A.m, dtype)[both],
                             cast(B.m, dtype)[both]), zdt)
    if union:
        aonly = A.p & ~B.p
        bonly = B.p & ~A.p
        out[aonly] = cast(A.m[aonly], zdt)
        out[bonly] = cast(B.m[bonly], zdt)
        return OM(out, A.p | B.p)
    return OM(out, both)


def o_reduce_cols(addname, dtype, A: OM) -> OM:
    """reduce each row to a scalar -> column vector (values, pattern 1-D)."""
    add = binop(addname, dtype)
    ident = identity_of(addname, dtype)
    m, n = A.p.shape
    out = np.full((m,), ident, np.dtype(dtype))
    a = cast(A.m, dtype)
    for j in range(n):
        out = np.where(A.p[:, j], add(out, a[:, j]), out)
    outp = A.p.any(axis=1)
    out = np.where(outp, out, np.zeros_like(out))
    return OM(out, outp)


def o_reduce_scalar(addname, dtype, A: OM):
    add = binop(addname, dtype)
    val = identity_of(addname, dtype)
    a = cast(A.m, dtype)
    for x in a[A.p].reshape(-1):
        val = add(val, x)
    return np.asarray(val, dtype)[()]
