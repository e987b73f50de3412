"""GraphBLAS type system on JAX dtypes.

The reference (SuiteSparse:GraphBLAS v2.3.3) defines 11 built-in types as
opaque structs (``Source/GB_ops.c:21-48``) plus user-defined types of
arbitrary byte size (``Source/GB_Type_new.c``).  Here a type is a small
frozen descriptor over a JAX dtype; user-defined types are pytrees of
arrays (struct-of-arrays), declared with :func:`Type.udt`.

Typecasting follows the reference's C-style semantics
(``Source/GB.h:2900-2960``): float->int truncates toward zero, int->int
wraps modularly, anything->bool is ``x != 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Type", "BOOL", "INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32",
    "INT64", "UINT64", "FP32", "FP64", "FC32", "FC64", "BUILTIN_TYPES",
    "cast", "cast_value", "type_of_dtype", "zero_of",
]


@dataclasses.dataclass(frozen=True)
class Type:
    """A GraphBLAS scalar type.

    For built-in types ``dtype`` is a numpy dtype.  For user-defined types
    (struct types, cf. reference ``GrB_Type_new``, ``Demo/Source/
    usercomplex.c``) ``fields`` maps field names to member Types and values
    are carried as dicts of arrays (struct-of-arrays layout, which is the
    accelerator-friendly representation of arrays-of-structs).
    """

    name: str
    dtype: Optional[np.dtype] = None
    fields: Optional[Tuple[Tuple[str, "Type"], ...]] = None

    # ---- classification ----------------------------------------------------
    @property
    def is_udt(self) -> bool:
        return self.fields is not None

    @property
    def is_bool(self) -> bool:
        return self.dtype is not None and self.dtype == np.bool_

    @property
    def is_integer(self) -> bool:
        return self.dtype is not None and np.issubdtype(self.dtype, np.integer)

    @property
    def is_signed(self) -> bool:
        return self.dtype is not None and np.issubdtype(self.dtype, np.signedinteger)

    @property
    def is_unsigned(self) -> bool:
        return self.dtype is not None and np.issubdtype(self.dtype, np.unsignedinteger)

    @property
    def is_float(self) -> bool:
        return self.dtype is not None and np.issubdtype(self.dtype, np.floating)

    @property
    def is_complex(self) -> bool:
        return self.dtype is not None and np.issubdtype(self.dtype, np.complexfloating)

    @property
    def is_builtin(self) -> bool:
        return not self.is_udt

    @property
    def nbits(self) -> int:
        return np.dtype(self.dtype).itemsize * 8 if self.dtype is not None else 0

    # ---- value helpers -----------------------------------------------------
    def zero(self):
        """The canonical padding value stored at absent entries."""
        if self.is_udt:
            return {k: t.zero() for k, t in self.fields}
        return np.zeros((), dtype=self.dtype)[()]

    def min_value(self):
        if self.is_bool:
            return False
        if self.is_integer:
            return np.iinfo(self.dtype).min
        return -np.inf

    def max_value(self):
        if self.is_bool:
            return True
        if self.is_integer:
            return np.iinfo(self.dtype).max
        return np.inf

    def __repr__(self) -> str:  # pragma: no cover
        return f"Type({self.name})"

    def __hash__(self):
        return hash((self.name, None if self.dtype is None else str(self.dtype)))

    # ---- user-defined struct types ------------------------------------------
    @staticmethod
    def udt(name: str, **field_types: "Type") -> "Type":
        """Create a user-defined struct type (reference: ``GrB_Type_new``)."""
        return Type(name=name, dtype=None, fields=tuple(field_types.items()))


BOOL = Type("BOOL", np.dtype(np.bool_))
INT8 = Type("INT8", np.dtype(np.int8))
UINT8 = Type("UINT8", np.dtype(np.uint8))
INT16 = Type("INT16", np.dtype(np.int16))
UINT16 = Type("UINT16", np.dtype(np.uint16))
INT32 = Type("INT32", np.dtype(np.int32))
UINT32 = Type("UINT32", np.dtype(np.uint32))
INT64 = Type("INT64", np.dtype(np.int64))
UINT64 = Type("UINT64", np.dtype(np.uint64))
FP32 = Type("FP32", np.dtype(np.float32))
FP64 = Type("FP64", np.dtype(np.float64))
# Complex types: the reference builds these as a user-defined type
# (Demo/Source/usercomplex.c); we provide them natively.
FC32 = Type("FC32", np.dtype(np.complex64))
FC64 = Type("FC64", np.dtype(np.complex128))

BUILTIN_TYPES = (BOOL, INT8, UINT8, INT16, UINT16, INT32, UINT32, INT64,
                 UINT64, FP32, FP64)

_BY_DTYPE = {t.dtype: t for t in BUILTIN_TYPES + (FC32, FC64)}


def type_of_dtype(dtype) -> Type:
    """Look up the GraphBLAS Type for a numpy/jax dtype."""
    d = np.dtype(dtype)
    if d not in _BY_DTYPE:
        raise TypeError(f"no GraphBLAS type for dtype {d}")
    return _BY_DTYPE[d]


# Code lattice for implicit output-type deduction, mirroring the reference's
# GB_code_* ordering (Source/GB_code_type.c): bool < int8 < uint8 < ... < fp64.
_ORDER = {t.name: i for i, t in enumerate(BUILTIN_TYPES)}


def promote(a: Type, b: Type) -> Type:
    return a if _ORDER[a.name] >= _ORDER[b.name] else b


def cast(x: jnp.ndarray, to_type: Type) -> jnp.ndarray:
    """Cast an array to ``to_type`` with GraphBLAS (C-style) semantics.

    Reference: ``Source/GB_cast_factory.c`` / ``Template/GB_2type_template.c``.
    """
    if to_type.is_udt:
        raise TypeError("cannot cast builtin values to a user-defined type")
    if isinstance(x, dict):
        raise TypeError("cannot cast user-defined values to a builtin type")
    x = jnp.asarray(x)
    src = x.dtype
    dst = to_type.dtype
    if src == dst:
        return x
    if to_type.is_bool:
        return x != 0
    if np.issubdtype(src, np.floating) and to_type.is_integer:
        # Truncate toward zero for in-range values; NaN -> 0, and both
        # infinities AND finite out-of-range values saturate to int
        # min/max.  The reference leaves finite out-of-range to the C
        # compiler (GB_CAST, GB.h:2900-2948); we pick saturation because
        # it is deterministic and identical on host (cast_value) and
        # device (XLA convert semantics vary by backend).
        #
        # Threshold compares (not clip): float(int64 max) rounds UP to
        # 2^63, so clipping to it passes out-of-range values through the
        # convert.  Every representable float strictly below the rounded
        # bound is <= the true max, so >=/<= saturation is exact even
        # when the bound itself is not representable.
        info = np.iinfo(dst)
        x = jnp.where(jnp.isnan(x), 0, x)
        t = jnp.trunc(x)
        hi = jnp.asarray(float(info.max), t.dtype)
        lo = jnp.asarray(float(info.min), t.dtype)
        in_range = (t < hi) & (t > lo)
        conv = jnp.where(in_range, t, 0).astype(dst)
        conv = jnp.where(t >= hi, jnp.asarray(info.max, dst), conv)
        conv = jnp.where(t <= lo, jnp.asarray(info.min, dst), conv)
        return conv
    return x.astype(dst)


def cast_value(x, to_type: Type):
    """Cast a python/numpy scalar to a numpy scalar of ``to_type``."""
    if to_type.is_udt:
        return {k: cast_value(x[k], t) for k, t in to_type.fields}
    if to_type.is_bool:
        return np.bool_(x != 0)
    if to_type.is_integer and isinstance(x, (float, np.floating)):
        # same rule as cast(): NaN -> 0, out-of-range (incl. +-Inf)
        # saturates — keeps host-assembled pending tuples bit-identical
        # to device-cast arrays
        info = np.iinfo(to_type.dtype)
        if np.isnan(x):
            return np.asarray(0, to_type.dtype)[()]
        xi = np.trunc(x)
        if xi >= float(info.max):
            return np.asarray(info.max, to_type.dtype)[()]
        if xi <= float(info.min):
            return np.asarray(info.min, to_type.dtype)[()]
        return np.asarray(int(xi), dtype=to_type.dtype)[()]
    return np.asarray(x).astype(to_type.dtype)[()]


def zero_of(t: Type):
    return t.zero()


def tree_where(mask: jnp.ndarray, a, b):
    """``where`` lifted over UDT value pytrees (mask broadcasts per leaf)."""
    return jax.tree_util.tree_map(lambda x, y: jnp.where(mask, x, y), a, b)


def zeros_like_typed(shape, t: Type):
    if t.is_udt:
        return {k: zeros_like_typed(shape, ft) for k, ft in t.fields}
    return jnp.zeros(shape, dtype=t.dtype)
