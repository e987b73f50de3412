"""The accumulate/mask epilogue: C<M> = accum(C, T).

Direct array transcription of the reference's executable specs
``Test/GB_spec_accum.m`` (also embedded at ``GB_accum_mask.c:59-117``) and
``Test/GB_spec_mask.m`` (embedded at ``GB_mask.c:29-120``).  Unlike the
reference — which routes small updates through ``GB_subassign_kernel`` and
large ones through ``GB_add`` + ``GB_mask`` (``GB_accum_mask.c:216-318``) —
the bitmap layout lets us fuse the whole epilogue into a couple of
vectorized selects, which XLA in turn fuses into the producing kernel.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .descriptor import Descriptor, desc_of
from .errors import DimensionMismatch
from .ops import BinaryOp
from .types import Type, cast

__all__ = ["accum_values", "apply_mask", "accum_mask"]


def _tree_where(mask, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(mask, x, y), a, b)


def _cast_vals(vals, src: Type, dst: Type):
    if dst.is_udt or src.is_udt:
        if src.name != dst.name:
            raise TypeError(f"cannot typecast UDT {src.name} -> {dst.name}")
        return vals
    return cast(vals, dst)


def accum_values(C, T, accum: Optional[BinaryOp]):
    """Z = accum(C, T) per GB_spec_accum: returns (zvals, zpat).

    - no accum: Z = T (cast to C's type)
    - accum:    intersection -> accum(c, t); C-only -> c; T-only -> cast(t)
    """
    ct = C.type
    if accum is None:
        zvals = _cast_vals(T.values, T.type, ct)
        zpat = T.pattern
        zvals = _tree_where(zpat, zvals, jax.tree_util.tree_map(
            jnp.zeros_like, zvals))
        return zvals, zpat
    both = C.pattern & T.pattern
    # cast C and T into the accum's domain, apply, cast back to C's type
    cvals = _cast_vals(C.values, ct, accum.xtype)
    tvals = _cast_vals(T.values, T.type, accum.ytype)
    zvals_both = _cast_vals(accum(cvals, tvals), accum.ztype, ct)
    t_in_c = _cast_vals(T.values, T.type, ct)
    zvals = _tree_where(both, zvals_both,
                        _tree_where(C.pattern, C.values, t_in_c))
    zpat = C.pattern | T.pattern
    zvals = _tree_where(zpat, zvals,
                        jax.tree_util.tree_map(jnp.zeros_like, zvals))
    return zvals, zpat


def effective_mask(M, scmp: bool, structural: bool):
    """Boolean mask array from a mask object (GB_spec_mask: Mask ~= 0,
    restricted to the mask's pattern; explicit zeros count as false)."""
    if M is None:
        return None
    if structural or M.type.is_udt:
        mk = M.pattern
    else:
        mk = M.pattern & cast(M.values, _BOOLT)
    return ~mk if scmp else mk


from .types import BOOL as _BOOLT  # placed after def to avoid cycle noise


def apply_mask(C, M, zvals, zpat, desc: Descriptor):
    """R = C<M> = Z per GB_spec_mask, with C_replace / SCMP handling."""
    if M is not None and M.shape != C.shape:
        raise DimensionMismatch(
            f"mask shape {M.shape} != output shape {C.shape}")
    if M is None:
        if desc.mask_scmp:
            # complemented empty mask: C unchanged unless replace clears it
            if desc.replace:
                return C.clear()
            return C
        out = C._replace(values=zvals, pattern=zpat, type=C.type, pending=[])
        return out.canonical()
    mk = effective_mask(M, desc.mask_scmp, desc.mask_structure)
    if desc.replace:
        cvals, cpat = jax.tree_util.tree_map(jnp.zeros_like, C.values), \
            jnp.zeros_like(C.pattern)
    else:
        cvals, cpat = C.values, C.pattern
    rpat = jnp.where(mk, zpat, cpat)
    rvals = _tree_where(mk, zvals, cvals)
    out = C._replace(values=rvals, pattern=rpat, pending=[])
    return out.canonical()


def accum_mask(C, M, T, accum: Optional[BinaryOp], desc: Optional[Descriptor]):
    """Full epilogue C<M> = accum(C, T) (reference ``GB_accum_mask.c``)."""
    desc = desc_of(desc)
    C = C.wait()
    if M is not None:
        M = M.wait()
    if T.shape != C.shape:
        raise DimensionMismatch(f"T shape {T.shape} != C shape {C.shape}")
    if M is None and desc.mask_scmp:
        # Z never needs computing (GB_spec_mask: R = C)
        return C.clear() if desc.replace else C
    zvals, zpat = accum_values(C, T, accum)
    return apply_mask(C, M, zvals, zpat, desc)
