"""Descriptors: per-call option bundle.

Reference: ``Source/GB_Descriptor_get.c``, ``Include/GraphBLAS.h:2737-2820``.
Fields: OUTP (REPLACE), MASK (SCMP), INP0/INP1 (TRAN), AxB method hint, and
nthreads (which here becomes a block-size / device-mesh hint).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Descriptor", "REPLACE", "SCMP", "TRAN0", "TRAN1", "NULL_DESC",
           "RT", "ST", "RST", "TT", "desc_of"]


@dataclasses.dataclass(frozen=True)
class Descriptor:
    replace: bool = False        # GrB_OUTP = GrB_REPLACE
    mask_scmp: bool = False      # GrB_MASK = GrB_SCMP (complement the mask)
    mask_structure: bool = False # structural mask (GxB extension, 3.x)
    tran0: bool = False          # GrB_INP0 = GrB_TRAN
    tran1: bool = False          # GrB_INP1 = GrB_TRAN
    axb_method: Optional[str] = None  # 'gustavson' | 'heap' | 'dot' | None

    def with_(self, **kw) -> "Descriptor":
        return dataclasses.replace(self, **kw)


NULL_DESC = Descriptor()
REPLACE = Descriptor(replace=True)
SCMP = Descriptor(mask_scmp=True)
TRAN0 = Descriptor(tran0=True)
TRAN1 = Descriptor(tran1=True)
RT = Descriptor(replace=True, tran0=True)
ST = Descriptor(mask_scmp=True, tran0=True)
RST = Descriptor(replace=True, mask_scmp=True, tran0=True)
TT = Descriptor(tran0=True, tran1=True)


def desc_of(desc: Optional[Descriptor]) -> Descriptor:
    return NULL_DESC if desc is None else desc
