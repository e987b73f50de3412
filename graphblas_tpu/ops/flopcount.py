"""Flop counting + AxB method selection — the cost model.

Reference: ``GB_AxB_flopcount.c`` (per-column flops of C<M>=A*B, used to
discard cheap masks and to plan balanced slices) and ``GB_AxB_select.c``
(Gustavson vs heap vs dot heuristic).  This library keeps the idea and
changes the menu: the candidate engines are

  dense-mxu  — one bitmap matmul on the matrix units (best when density
               or n is small enough that n*k*m MACs are cheaper than
               moving sparse metadata)
  bsr        — block-sparse tile-triple products (``sparse/bsr.py``);
               work scales with nonempty 128^3 tile triples
  bitpack    — per-masked-edge row intersection (gather+popcount); work
               scales with nnz(M) * n/32 lanes
  generic    — k-blocked scan (any semiring / UDT)

Selection compares modeled device work at the engines' throughputs;
``method_used`` is recorded for introspection (the reference's
per-matrix ``AxB_method_used``, ``GB_matrix.h:351``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["axb_flopcount", "choose_axb_method", "last_axb_method",
           "record_axb_method"]

_LAST_METHOD = {"method": None}


def record_axb_method(method: str) -> None:
    _LAST_METHOD["method"] = method
    from ..utils import counters
    counters.record_method(method)


def last_axb_method() -> Optional[str]:
    """Method used by the most recent mxm/mxv/vxm (AxB_method_used)."""
    return _LAST_METHOD["method"]


def axb_flopcount(A_pattern, B_pattern, M_pattern=None) -> int:
    """# of multiply-adds to compute C<M>=A*B on the sparse pattern
    (reference ``GB_AxB_flopcount.c``: Σ_j Σ_{k∈B(:,j)} nnz(A(:,k));
    the masked count only visits columns j where M(:,j) is nonempty)."""
    Ap = np.asarray(A_pattern)
    Bp = np.asarray(B_pattern)
    acol = Ap.sum(axis=0).astype(np.int64)          # nnz(A(:,k))
    if M_pattern is not None:
        mcol = np.asarray(M_pattern).any(axis=0)
        Bp = Bp[:, mcol] if mcol.ndim == 1 else Bp
    return int((Bp.T.astype(np.int64) @ acol).sum())


# per-op throughputs (ops/sec): unmeasured routing weights on the card
# (ROADMAP 3.3); only their ratios steer the choice
_DENSE_MACS_PER_S = 2.0e14      # int8/bf16 matmul effective
_TILE_MACS_PER_S = 1.8e14      # BSR tile triples
_BITPACK_LANES_PER_S = 5.0e9   # gather-bound word-AND-popcount lanes
_GENERIC_OPS_PER_S = 5.0e11    # elementwise
_ESC_LANES_PER_S = 2.0e9       # sort-bound expand/sort/compress lanes

# a dense engine is only *feasible* when the bitmap operands/output fit
# comfortably in HBM (the reference's analogue is Gustavson's
# cvlen-sized Sauna: fine for any practical vector length, but our dense
# engines allocate m*n).  2^28 f32 elements = 1 GB per array.
_DENSE_LIMIT = 1 << 28          # elements per dense array


def choose_axb_method(m: int, k: int, n: int,
                      annz: int, bnnz: int,
                      mnnz: Optional[int] = None,
                      ntile_triples: Optional[int] = None,
                      mxu_capable: bool = True,
                      tile: int = 128,
                      est_flops: Optional[int] = None) -> str:
    """Pick the cheapest *feasible* engine by modeled device time
    (``GB_AxB_select.c:93-159`` analogue, with this library's engines).

    ``est_flops``: expected multiply count for the sparse ESC engine
    (exact flopcount or the annz*bnnz/k estimate); when given, the
    sparse CSR engine competes.  Dense engines are excluded outright
    when any of the three bitmaps would exceed ``_DENSE_LIMIT``.
    """
    if not mxu_capable:
        return "generic"
    dense_ok = max(m * k, k * n, m * n) <= _DENSE_LIMIT
    best, t_best = None, float("inf")
    if dense_ok:
        best, t_best = "dense-mxu", (m * k * n) / _DENSE_MACS_PER_S
        if ntile_triples is not None:
            t_bsr = (ntile_triples * tile ** 3) / _TILE_MACS_PER_S
            if t_bsr < t_best:
                best, t_best = "bsr", t_bsr
        if mnnz is not None:
            words = max(1, (n + 31) // 32)
            t_bitpack = (mnnz * words) / _BITPACK_LANES_PER_S
            if t_bitpack < t_best:
                best, t_best = "bitpack", t_bitpack
    if est_flops is None and not dense_ok:
        est_flops = max(1, (annz * bnnz) // max(k, 1))
    if est_flops is not None:
        lanes = max(est_flops, 1)
        t_esc = lanes * max(np.log2(lanes), 1) / _ESC_LANES_PER_S
        if t_esc < t_best:
            best, t_best = "esc", t_esc
    return best or "esc"
