"""Monoids: an associative binary op + identity (+ optional terminal).

Reference: ``Source/GB_Monoid_new.c``, ``GxB_Monoid_terminal_new.c`` and the
44 predefined monoids in ``Include/GraphBLAS.h:5100-5162``.  The terminal
value enables early exit in reductions (MIN/MAX/LOR/LAND/EQ and integer
TIMES); here we use it both to short-circuit host-side iteration and to
keep reductions exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from .ops import BinaryOp, binary
from .types import Type, BOOL, BUILTIN_TYPES

__all__ = ["Monoid", "monoid", "MONOIDS"]


@dataclasses.dataclass(frozen=True)
class Monoid:
    op: BinaryOp
    identity: Any
    terminal: Optional[Any] = None

    @property
    def type(self) -> Type:
        return self.op.ztype

    @property
    def name(self) -> str:
        return f"{self.op.name}_{self.type.name}_MONOID"

    def __call__(self, x, y):
        return self.op(x, y)

    def identity_array(self, shape=()):
        if self.type.is_udt:
            import jax
            return jax.tree_util.tree_map(
                lambda v: jnp.full(shape, v), self.identity)
        return jnp.full(shape, self.identity, dtype=self.type.dtype)

    def reduce(self, x, axis=None, where=None):
        """Reduce an array with this monoid along ``axis``.

        ``where`` masks out absent entries (they contribute identity).
        Uses exact jnp reductions for the standard monoids and a generic
        log-depth pairwise reduction otherwise.
        """
        nm = self.op.name
        t = self.type
        if where is not None:
            if t.is_udt:
                import jax
                x = jax.tree_util.tree_map(
                    lambda a, ident: jnp.where(where, a, jnp.asarray(
                        ident, a.dtype)), x, dict(self.identity))
            else:
                x = jnp.where(where, x, jnp.asarray(self.identity, x.dtype))
        if nm == "PLUS" and not t.is_bool:
            return jnp.sum(x, axis=axis, dtype=x.dtype)
        if nm == "TIMES" and not t.is_bool:
            return jnp.prod(x, axis=axis, dtype=x.dtype)
        # MIN/MAX ignore NaN (fmin/fmax semantics, matching binary.min/
        # max and the reference's fminf-based monoids) — jnp.nanmin on
        # floats, plain min/max on ints/bool
        if nm == "MIN" or (nm in ("LAND", "TIMES") and t.is_bool):
            if t.is_float:
                return jnp.nanmin(x, axis=axis)
            return jnp.min(x, axis=axis)
        if nm == "MAX" or (nm in ("LOR", "PLUS") and t.is_bool):
            if t.is_float:
                return jnp.nanmax(x, axis=axis)
            return jnp.max(x, axis=axis)
        if nm == "LOR":
            return jnp.max(x, axis=axis)
        if nm == "LAND":
            return jnp.min(x, axis=axis)
        if nm in ("LXOR", "MINUS") and t.is_bool:
            return jnp.sum(x.astype(np.int32), axis=axis) % 2 != 0
        if nm == "LXOR":
            return (jnp.sum((x != 0).astype(np.int32), axis=axis) % 2 != 0).astype(x.dtype)
        if nm == "EQ":
            # EQ monoid = XNOR: identity true
            return jnp.sum((~(x != 0)).astype(np.int32), axis=axis) % 2 == 0
        # generic associative fold (log-depth pairwise)
        return _pairwise_reduce(self.op, x, axis, self.identity)

    def __repr__(self):  # pragma: no cover
        return f"Monoid({self.name})"


def _pairwise_reduce(op: BinaryOp, x, axis, identity):
    """Log-depth associative fold; works on UDT pytrees of arrays too."""
    import jax
    tmap = jax.tree_util.tree_map
    if axis is None:
        x = tmap(lambda a: jnp.reshape(a, (-1,)), x)
        axis = 0
    lead = jax.tree_util.tree_leaves(x)[0]
    if axis < 0:
        axis += lead.ndim
    x = tmap(lambda a: jnp.moveaxis(a, axis, 0), x)
    n = jax.tree_util.tree_leaves(x)[0].shape[0]
    while n > 1:
        half = n // 2
        lo = tmap(lambda a: a[:half], x)
        hi = tmap(lambda a: a[half:2 * half], x)
        merged = op(lo, hi)
        if n % 2:
            merged = tmap(lambda mm, a: jnp.concatenate(
                [mm, a[2 * half:2 * half + 1]], axis=0), merged, x)
        x = merged
        n = jax.tree_util.tree_leaves(x)[0].shape[0]
    if n == 0:
        return tmap(jnp.asarray, identity)
    return tmap(lambda a: a[0], x)


class _MonoidFamily:
    def __init__(self, opfam, identity_of, terminal_of=lambda t: None):
        self._opfam = opfam
        self._identity_of = identity_of
        self._terminal_of = terminal_of
        self._cache = {}

    def __getitem__(self, t: Type) -> Monoid:
        m = self._cache.get(t.name)
        if m is None:
            m = Monoid(self._opfam[t], self._identity_of(t), self._terminal_of(t))
            self._cache[t.name] = m
        return m


def monoid_new(op: BinaryOp, identity, terminal=None) -> Monoid:
    """User monoid constructor (reference ``GrB_Monoid_new``)."""
    return Monoid(op, identity, terminal)


class _Namespace:
    def __init__(self, **fams):
        self.__dict__.update(fams)
        self._all = fams

    def __getitem__(self, name):
        return self._all[name.lower()]


monoid = _Namespace(
    min=_MonoidFamily(binary.min, lambda t: t.max_value(), lambda t: t.min_value() if t.is_integer or t.is_bool else -np.inf),
    max=_MonoidFamily(binary.max, lambda t: t.min_value(), lambda t: t.max_value() if t.is_integer or t.is_bool else np.inf),
    plus=_MonoidFamily(binary.plus, lambda t: t.zero()),
    times=_MonoidFamily(binary.times, lambda t: True if t.is_bool else np.asarray(1, t.dtype)[()],
                        lambda t: np.asarray(0, t.dtype)[()] if t.is_integer else None),
    lor=_MonoidFamily(binary.lor, lambda t: False, lambda t: True),
    land=_MonoidFamily(binary.land, lambda t: True, lambda t: False),
    lxor=_MonoidFamily(binary.lxor, lambda t: False),
    eq=_MonoidFamily(binary.eq, lambda t: True),
)

# The reference's 44 predefined monoids: MIN/MAX/PLUS/TIMES x 10 non-bool
# types + LOR/LAND/LXOR/EQ on BOOL (Include/GraphBLAS.h:5100-5162).
MONOIDS = {}
for _fam in ("min", "max", "plus", "times"):
    for _t in BUILTIN_TYPES:
        if _t.is_bool:
            continue
        _m = monoid[_fam][_t]
        MONOIDS[f"GxB_{_fam.upper()}_{_t.name}_MONOID"] = _m
for _fam in ("lor", "land", "lxor", "eq"):
    MONOIDS[f"GxB_{_fam.upper()}_BOOL_MONOID"] = monoid[_fam][BOOL]
