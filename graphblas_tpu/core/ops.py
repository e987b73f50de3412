"""GraphBLAS operators: unary, binary, and select ops.

The reference stamps out 45 unary and 256 binary typed operators from a C
template (``Source/Template/GB_ops_template.{c,h}``, ``Source/GB_ops.c``).
On JAX there is no need for code generation: an operator is a JAX-traceable
function plus type metadata, and ``jax.jit`` monomorphizes per dtype for
free.  Integer division follows the reference's MATLAB-style semantics
(``Source/GB.h:2769-2900``): x/0 is 0 for x==0, +/-"infinity" (type
max/min) otherwise; INT_MIN / -1 avoids overflow; bool division z = x.

User-defined operators (reference ``GrB_UnaryOp_new`` / ``GrB_BinaryOp_new``,
``Demo/Source/usercomplex.c``) are created by calling :class:`UnaryOp` /
:class:`BinaryOp` directly with any JAX-traceable function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import types as gbtypes
from .types import Type, BOOL, FP32, FP64, BUILTIN_TYPES, cast

__all__ = ["UnaryOp", "BinaryOp", "SelectOp", "unary", "binary", "select"]


# ---------------------------------------------------------------------------
# op descriptors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnaryOp:
    """z = f(x).  Reference: ``GrB_UnaryOp`` (GraphBLAS.h:598+)."""
    name: str
    fn: Callable  # fn(x) -> z, arrays of xtype -> ztype
    ztype: Type
    xtype: Type

    def __call__(self, x):
        return self.fn(x)

    def __repr__(self):  # pragma: no cover
        return f"UnaryOp({self.name}_{self.xtype.name})"


@dataclasses.dataclass(frozen=True)
class BinaryOp:
    """z = f(x, y).  Reference: ``GrB_BinaryOp`` (GraphBLAS.h:790+)."""
    name: str
    fn: Callable  # fn(x, y) -> z
    ztype: Type
    xtype: Type
    ytype: Type

    def __call__(self, x, y):
        return self.fn(x, y)

    def __repr__(self):  # pragma: no cover
        return f"BinaryOp({self.name}_{self.xtype.name})"


@dataclasses.dataclass(frozen=True)
class SelectOp:
    """keep = f(i, j, x, thunk), elementwise over the pattern.

    Reference: ``GxB_SelectOp`` (GB.h:625-649), ``GxB_TRIL`` etc.
    """
    name: str
    fn: Callable  # fn(i, j, x, k) -> bool array

    def __call__(self, i, j, x, k):
        return self.fn(i, j, x, k)


# ---------------------------------------------------------------------------
# MATLAB-style integer division (reference GB.h:2769-2900)
# ---------------------------------------------------------------------------

def _idiv(t: Type):
    info = np.iinfo(t.dtype)
    tmin, tmax = info.min, info.max

    if t.is_signed:
        def div(x, y):
            x = x.astype(t.dtype) if hasattr(x, "astype") else jnp.asarray(x, t.dtype)
            y = jnp.asarray(y, t.dtype)
            safe_y = jnp.where((y == 0) | (y == -1), jnp.asarray(1, t.dtype), y)
            q = jax.lax.div(jnp.asarray(x, t.dtype), safe_y)
            div0 = jnp.where(x == 0, 0, jnp.where(x < 0, tmin, tmax)).astype(t.dtype)
            return jnp.where(y == 0, div0, jnp.where(y == -1, (-x).astype(t.dtype), q))
    else:
        def div(x, y):
            y = jnp.asarray(y, t.dtype)
            safe_y = jnp.where(y == 0, jnp.asarray(1, t.dtype), y)
            q = jax.lax.div(jnp.asarray(x, t.dtype), safe_y)
            div0 = jnp.where(x == 0, 0, tmax).astype(t.dtype)
            return jnp.where(y == 0, div0, q)
    return div


def _iminv(t: Type):
    info = np.iinfo(t.dtype)
    tmax = info.max

    def minv(x):
        safe = jnp.where(x == 0, jnp.asarray(1, t.dtype), x)
        q = jax.lax.div(jnp.asarray(1, t.dtype), safe.astype(t.dtype))
        return jnp.where(x == 0, jnp.asarray(tmax, t.dtype), q)
    return minv


# ---------------------------------------------------------------------------
# families: op name -> per-type concrete op
# ---------------------------------------------------------------------------

class _Family:
    """A named operator family, indexed by type: ``binary.plus[FP64]``."""

    def __init__(self, name: str, make: Callable[[Type], object]):
        self.name = name
        self._make = make
        self._cache: Dict[str, object] = {}

    def __getitem__(self, t: Type):
        op = self._cache.get(t.name)
        if op is None:
            op = self._make(t)
            self._cache[t.name] = op
        return op

    def __repr__(self):  # pragma: no cover
        return f"OpFamily({self.name})"


def _unary_family(name: str, fn_of_t) -> _Family:
    def make(t: Type) -> UnaryOp:
        return UnaryOp(name, fn_of_t(t), t, t)
    return _Family(name, make)


def _wrap2(t: Type, f):
    """Ensure binary result is produced in type t (wraparound via astype)."""
    def fn(x, y):
        return f(x, y).astype(t.dtype) if not t.is_udt else f(x, y)
    return fn


def _binary_family(name: str, fn_of_t, ztype_of_t=lambda t: t) -> _Family:
    def make(t: Type) -> BinaryOp:
        return BinaryOp(name, fn_of_t(t), ztype_of_t(t), t, t)
    return _Family(name, make)


class _Namespace:
    def __init__(self, **families):
        self.__dict__.update(families)
        self._all = families

    def __getitem__(self, name):
        return self._all[name.lower()]

    def names(self):
        return list(self._all)


# ---- unary ops (reference GB_ops_template.h: IDENTITY AINV MINV LNOT ONE ABS)

def _u_identity(t):
    return lambda x: x


def _u_ainv(t):
    if t.is_bool:
        return lambda x: x
    return lambda x: (-jnp.asarray(x, t.dtype)).astype(t.dtype)


def _u_minv(t):
    if t.is_bool:
        return lambda x: jnp.ones_like(x, dtype=np.bool_)
    if t.is_integer:
        return _iminv(t)
    return lambda x: (jnp.asarray(1, t.dtype) / x).astype(t.dtype)


def _u_lnot(t):
    def fn(x):
        return cast(~(jnp.asarray(x) != 0), t)
    return fn


def _u_one(t):
    return lambda x: jnp.ones_like(jnp.asarray(x, t.dtype))


def _u_abs(t):
    if t.is_bool or t.is_unsigned:
        return lambda x: x
    return lambda x: jnp.abs(x).astype(t.dtype)


unary = _Namespace(
    identity=_unary_family("IDENTITY", _u_identity),
    ainv=_unary_family("AINV", _u_ainv),
    minv=_unary_family("MINV", _u_minv),
    lnot=_unary_family("LNOT", _u_lnot),
    one=_unary_family("ONE", _u_one),
    abs=_unary_family("ABS", _u_abs),
)


# ---- binary ops -----------------------------------------------------------

def _b_first(t):
    return lambda x, y: x


def _b_second(t):
    return lambda x, y: y


def _b_pair(t):
    # GxB_PAIR (later SuiteSparse versions); handy for structure-only semirings
    return lambda x, y: jnp.ones(jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y)), t.dtype)


def _b_min(t):
    if t.is_bool:
        return lambda x, y: x & y
    if t.is_float:
        # reference uses GB_IMIN / fminf semantics: NaN ignored like MATLAB min
        return lambda x, y: jnp.fmin(x, y).astype(t.dtype)
    return lambda x, y: jnp.minimum(x, y).astype(t.dtype)


def _b_max(t):
    if t.is_bool:
        return lambda x, y: x | y
    if t.is_float:
        return lambda x, y: jnp.fmax(x, y).astype(t.dtype)
    return lambda x, y: jnp.maximum(x, y).astype(t.dtype)


def _b_plus(t):
    if t.is_bool:
        return lambda x, y: x | y
    return _wrap2(t, lambda x, y: jnp.asarray(x, t.dtype) + jnp.asarray(y, t.dtype))


def _b_minus(t):
    if t.is_bool:
        return lambda x, y: x ^ y
    return _wrap2(t, lambda x, y: jnp.asarray(x, t.dtype) - jnp.asarray(y, t.dtype))


def _b_rminus(t):
    if t.is_bool:
        return lambda x, y: x ^ y
    return _wrap2(t, lambda x, y: jnp.asarray(y, t.dtype) - jnp.asarray(x, t.dtype))


def _b_times(t):
    if t.is_bool:
        return lambda x, y: x & y
    return _wrap2(t, lambda x, y: jnp.asarray(x, t.dtype) * jnp.asarray(y, t.dtype))


def _b_div(t):
    if t.is_bool:
        return lambda x, y: x  # bool div == first (GB.h:2889-2900)
    if t.is_integer:
        return _idiv(t)
    return lambda x, y: (x / y).astype(t.dtype)


def _b_rdiv(t):
    f = _b_div(t)
    if t.is_bool:
        return lambda x, y: y
    return lambda x, y: f(y, x)


def _cmp(fn):
    def of_t(t):
        return lambda x, y: fn(x, y)
    return of_t


# IS* ops: comparison returning the operand type (0/1), reference GB_ops.c
def _is_of(fn):
    def of_t(t):
        def f(x, y):
            return cast(fn(x, y), t)
        return f
    return of_t


def _b_lor(t):
    def fn(x, y):
        return cast((jnp.asarray(x) != 0) | (jnp.asarray(y) != 0), t)
    return fn


def _b_land(t):
    def fn(x, y):
        return cast((jnp.asarray(x) != 0) & (jnp.asarray(y) != 0), t)
    return fn


def _b_lxor(t):
    def fn(x, y):
        return cast((jnp.asarray(x) != 0) ^ (jnp.asarray(y) != 0), t)
    return fn


def _b_any(t):
    # GxB_ANY (3.x extension): pick either operand; we pick the second to
    # match SuiteSparse's sequential last-write behavior closely enough.
    return lambda x, y: y


binary = _Namespace(
    first=_binary_family("FIRST", _b_first),
    second=_binary_family("SECOND", _b_second),
    pair=_binary_family("PAIR", _b_pair),
    any=_binary_family("ANY", _b_any),
    min=_binary_family("MIN", _b_min),
    max=_binary_family("MAX", _b_max),
    plus=_binary_family("PLUS", _b_plus),
    minus=_binary_family("MINUS", _b_minus),
    rminus=_binary_family("RMINUS", _b_rminus),
    times=_binary_family("TIMES", _b_times),
    div=_binary_family("DIV", _b_div),
    rdiv=_binary_family("RDIV", _b_rdiv),
    iseq=_binary_family("ISEQ", _is_of(lambda x, y: x == y)),
    isne=_binary_family("ISNE", _is_of(lambda x, y: x != y)),
    isgt=_binary_family("ISGT", _is_of(lambda x, y: x > y)),
    islt=_binary_family("ISLT", _is_of(lambda x, y: x < y)),
    isge=_binary_family("ISGE", _is_of(lambda x, y: x >= y)),
    isle=_binary_family("ISLE", _is_of(lambda x, y: x <= y)),
    lor=_binary_family("LOR", _b_lor),
    land=_binary_family("LAND", _b_land),
    lxor=_binary_family("LXOR", _b_lxor),
    eq=_binary_family("EQ", _cmp(lambda x, y: x == y), lambda t: BOOL),
    ne=_binary_family("NE", _cmp(lambda x, y: x != y), lambda t: BOOL),
    gt=_binary_family("GT", _cmp(lambda x, y: x > y), lambda t: BOOL),
    lt=_binary_family("LT", _cmp(lambda x, y: x < y), lambda t: BOOL),
    ge=_binary_family("GE", _cmp(lambda x, y: x >= y), lambda t: BOOL),
    le=_binary_family("LE", _cmp(lambda x, y: x <= y), lambda t: BOOL),
)

# boolean renames, mirroring GB_boolean_rename.c: on BOOL, many ops coincide.
# (our per-type factories already implement the bool specializations directly)


# ---- select ops (GxB_TRIL/TRIU/DIAG/OFFDIAG/NONZERO + user) ----------------

select = _Namespace(
    tril=SelectOp("TRIL", lambda i, j, x, k: (j - i) <= k),
    triu=SelectOp("TRIU", lambda i, j, x, k: (j - i) >= k),
    diag=SelectOp("DIAG", lambda i, j, x, k: (j - i) == k),
    offdiag=SelectOp("OFFDIAG", lambda i, j, x, k: (j - i) != k),
    nonzero=SelectOp("NONZERO", lambda i, j, x, k: x != 0),
)


# ---- typed-name lookup: e.g. op("PLUS", FP64), op("GrB_PLUS_FP64") ----------

_TYPES_BY_NAME = {t.name: t for t in BUILTIN_TYPES + (gbtypes.FC32, gbtypes.FC64)}


def binary_op(name: str, typ: Optional[Type] = None) -> BinaryOp:
    """Look up a binary op by GraphBLAS-style name, e.g. ``PLUS_FP64``."""
    name = name.upper().replace("GRB_", "").replace("GXB_", "")
    if typ is None:
        base, _, tname = name.rpartition("_")
        typ = _TYPES_BY_NAME[tname]
        name = base
    return binary[name.lower()][typ]


def unary_op(name: str, typ: Optional[Type] = None) -> UnaryOp:
    name = name.upper().replace("GRB_", "").replace("GXB_", "")
    if typ is None:
        base, _, tname = name.rpartition("_")
        typ = _TYPES_BY_NAME[tname]
        name = base
    return unary[name.lower()][typ]
