"""Semirings: an additive monoid x a multiplicative binary op.

The reference predefines 960 semirings and stamps a specialized C worker
file for each (``Source/Generated/``, 247 KLoC; generated by
``Source/axb.m`` from ``Source/Generator/GB_AxB.c``).  On JAX the entire
code-generation layer disappears: a semiring is a pair of traceable
functions, and ``jax.jit`` specializes the handful of polymorphic matmul
kernels per (monoid, mult, dtype) at trace time.

The predefined catalog (Include/GraphBLAS.h:5165-5200):
  * 680: {MIN,MAX,PLUS,TIMES} add monoids x 17 mult ops x 10 non-bool types
  * 240: {LOR,LAND,LXOR,EQ} bool monoids x {EQ,NE,GT,LT,GE,LE} x 10 types
  *  40: 4 bool monoids x 10 bool mult ops
"""

from __future__ import annotations

import dataclasses

from .monoids import Monoid, monoid
from .ops import BinaryOp, binary
from .types import Type, BOOL, BUILTIN_TYPES

__all__ = ["Semiring", "semiring", "SEMIRINGS"]


@dataclasses.dataclass(frozen=True)
class Semiring:
    add: Monoid
    mult: BinaryOp

    @property
    def name(self) -> str:
        return f"{self.add.op.name}_{self.mult.name}_{self.mult.xtype.name}"

    @property
    def ztype(self) -> Type:
        return self.add.type

    @property
    def xtype(self) -> Type:
        return self.mult.xtype

    @property
    def ytype(self) -> Type:
        return self.mult.ytype

    def __repr__(self):  # pragma: no cover
        return f"Semiring({self.name})"


def semiring_new(add: Monoid, mult: BinaryOp) -> Semiring:
    """User semiring constructor (reference ``GrB_Semiring_new``)."""
    if not add.type.is_udt and add.type.name != mult.ztype.name:
        raise TypeError(
            f"monoid type {add.type.name} != mult output {mult.ztype.name}")
    return Semiring(add, mult)


class _SemiringLookup:
    """``semiring.plus_times[FP64]`` / ``semiring['lor_land'][BOOL]``."""

    def __init__(self):
        self._cache = {}

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return _SemiringFamily(key)

    def __getitem__(self, key):
        return _SemiringFamily(key)


class _SemiringFamily:
    def __init__(self, key: str):
        addname, multname = key.lower().split("_", 1)
        self._addname, self._multname = addname, multname

    def __getitem__(self, t: Type) -> Semiring:
        mult = binary[self._multname][t]
        add = monoid[self._addname][mult.ztype]
        return Semiring(add, mult)


semiring = _SemiringLookup()

# ---------------------------------------------------------------------------
# the predefined 960-name catalog — generated programmatically instead of
# 247 KLoC of stamped C files.
# ---------------------------------------------------------------------------

_MULT17 = ("first", "second", "min", "max", "plus", "minus", "times", "div",
           "iseq", "isne", "isgt", "islt", "isge", "isle", "lor", "land",
           "lxor")
_CMP6 = ("eq", "ne", "gt", "lt", "ge", "le")
_BOOLMULT10 = ("first", "second", "lor", "land", "lxor", "eq", "gt", "lt",
               "ge", "le")

SEMIRINGS = {}


def _register(addname, multname, t):
    mult = binary[multname][t]
    add = monoid[addname][mult.ztype]
    s = Semiring(add, mult)
    SEMIRINGS[f"GxB_{addname.upper()}_{multname.upper()}_{t.name}"] = s
    return s


for _t in BUILTIN_TYPES:
    if _t.is_bool:
        continue
    for _add in ("min", "max", "plus", "times"):
        for _mult in _MULT17:
            _register(_add, _mult, _t)
    for _add in ("lor", "land", "lxor", "eq"):
        for _mult in _CMP6:
            _register(_add, _mult, _t)
for _add in ("lor", "land", "lxor", "eq"):
    for _mult in _BOOLMULT10:
        _register(_add, _mult, BOOL)


def lookup(name: str) -> Semiring:
    """Look up a semiring by its GxB_ name or 'add_mult_TYPE' shorthand."""
    if name in SEMIRINGS:
        return SEMIRINGS[name]
    key = "GxB_" + name.upper().replace("GXB_", "").replace("GRB_", "")
    return SEMIRINGS[key]
