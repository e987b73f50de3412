"""Block-sparse (BSR) masked SpGEMM on dense tiles.

Matrix units want dense tiles; real graphs want sparsity.  BSR is the
meeting point (SURVEY.md §7): the pattern is cut into 128x128 tiles,
empty tiles are dropped, and a masked product C<M> = A ⊕.⊗ B' becomes a
*batch of tile matmuls* — one ``int8 x int8 -> int32`` (or f32 value)
contraction per (I,J,K) tile triple where A(I,K), B(J,K) and the output
mask M(I,J) are all nonempty — followed by a segment-sum over K.  Work
scales with the number of nonempty tile triples (for banded/clustered
graphs, ~linear in n) instead of n³.

This replaces the reference's Gustavson/heap/dot saxpy variants
(``GB_AxB_Gustavson.c``, ``GB_AxB_heap.c``, ``GB_AxB_dot.c``) as the
large-graph masked-SpGEMM engine; the auto-select between this, the
dense-bitmap matmul, and the bitpacked gather path is the analogue of
``GB_AxB_select``'s flop-count heuristic.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["tile_pattern", "tile_pattern_from_coo", "tile_matrix",
           "bsr_masked_mm", "build_schedule", "masked_mxm", "tricount_bsr",
           "TilePattern"]

TILE = 128


class TilePattern:
    """Host-built BSR decomposition of a boolean pattern.

    tiles:   [ntiles, T, T] int8 device array (stacked nonempty tiles)
    grid:    [Tm, Tn] bool  (which tiles are nonempty)
    index:   [Tm, Tn] int32 (tile id, or 0 for empty — masked by grid)
    """

    def __init__(self, tiles, grid, index, shape, T=TILE):
        self.tiles = tiles
        self.grid = grid
        self.index = index
        self.shape = shape
        self.T = T

    @property
    def ntiles(self):
        return int(self.tiles.shape[0])


def tile_pattern(pattern: np.ndarray, T: int = TILE) -> TilePattern:
    """Cut an [m, n] bool pattern into its nonempty TxT tiles."""
    pattern = np.asarray(pattern)
    m, n = pattern.shape
    Tm, Tn = -(-m // T), -(-n // T)
    padded = np.zeros((Tm * T, Tn * T), dtype=bool)
    padded[:m, :n] = pattern
    blocks = padded.reshape(Tm, T, Tn, T).transpose(0, 2, 1, 3)
    grid = blocks.any(axis=(2, 3))
    ids = np.nonzero(grid)
    tiles = blocks[ids[0], ids[1]].astype(np.int8)
    index = np.zeros((Tm, Tn), np.int32)
    index[ids] = np.arange(len(ids[0]), dtype=np.int32)
    return TilePattern(jnp.asarray(tiles), grid, index, (m, n), T)


def tile_pattern_from_coo(I, J, shape, T: int = TILE) -> TilePattern:
    """BSR decomposition straight from an edge list — no dense [m, n]
    intermediate, so it scales to graphs whose dense pattern would not
    fit host memory.  Only nonempty tiles are materialized."""
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    m, n = shape
    Tm, Tn = -(-m // T), -(-n // T)
    ti, tj = I // T, J // T
    tid = ti * Tn + tj
    order = np.argsort(tid, kind="stable")
    tid_s = tid[order]
    uniq, starts = np.unique(tid_s, return_index=True)
    ntiles = len(uniq)
    tiles = np.zeros((ntiles, T, T), np.int8)
    # scatter each edge's (local row, local col) bit into its tile slot
    slot_of = np.zeros(Tm * Tn, np.int64)
    slot_of[uniq] = np.arange(ntiles)
    li = (I % T)[order]
    lj = (J % T)[order]
    tiles[slot_of[tid_s], li, lj] = 1
    grid = np.zeros((Tm, Tn), bool)
    grid[uniq // Tn, uniq % Tn] = True
    index = np.zeros((Tm, Tn), np.int32)
    index[uniq // Tn, uniq % Tn] = np.arange(ntiles, dtype=np.int32)
    return TilePattern(jnp.asarray(tiles), grid, index, (m, n), T)


def tile_matrix(values: np.ndarray, pattern: np.ndarray, T: int = TILE,
                dtype=np.float32) -> TilePattern:
    """Cut an [m, n] value matrix (zeros at absent positions) into its
    pattern-nonempty TxT value tiles — the BSR value form for
    PLUS_TIMES products."""
    pattern = np.asarray(pattern)
    values = np.asarray(values)
    m, n = pattern.shape
    Tm, Tn = -(-m // T), -(-n // T)
    ppad = np.zeros((Tm * T, Tn * T), dtype=bool)
    ppad[:m, :n] = pattern
    vpad = np.zeros((Tm * T, Tn * T), dtype=dtype)
    vpad[:m, :n] = np.where(pattern, values, 0).astype(dtype)
    pblocks = ppad.reshape(Tm, T, Tn, T).transpose(0, 2, 1, 3)
    vblocks = vpad.reshape(Tm, T, Tn, T).transpose(0, 2, 1, 3)
    grid = pblocks.any(axis=(2, 3))
    ids = np.nonzero(grid)
    tiles = vblocks[ids[0], ids[1]]
    index = np.zeros((Tm, Tn), np.int32)
    index[ids] = np.arange(len(ids[0]), dtype=np.int32)
    return TilePattern(jnp.asarray(tiles), grid, index, (m, n), T)


def tricount_bsr(Lp: np.ndarray, Up: np.ndarray, T: int = TILE) -> int:
    """SandiaDot triangle count on the BSR path:
    ntri = sum((L · U') .* L) with tile-triple matmuls."""
    Lt = tile_pattern(Lp, T)
    C, _ = bsr_masked_mm(Lt, Lt, tile_pattern(Up, T))
    return int(jnp.sum(C.astype(jnp.int64)))


def build_schedule(Mp: TilePattern, Ap: TilePattern, Bp: TilePattern):
    """Host-side tile-triple schedule of C<M> = A · B' over M's nonempty
    tiles: returns (outid, ta, tb, Mtiles, outs) — per triple its output
    tile and its A and B tile slots, M's tiles in output order, and the
    output tile coordinates — or None when there is no work."""
    ga, gb, gm = Ap.grid, Bp.grid, Mp.grid
    trip = gm[:, :, None] & ga[:, None, :] & gb[None, :, :]
    I, J, K = np.nonzero(trip)
    outs = np.nonzero(gm)
    nout = len(outs[0])
    if len(I) == 0 or nout == 0:
        return None
    out_index = np.zeros(gm.shape, np.int32)
    out_index[outs] = np.arange(nout, dtype=np.int32)
    ta = jnp.asarray(Ap.index[I, K], jnp.int32)
    tb = jnp.asarray(Bp.index[J, K], jnp.int32)
    Mtiles = jnp.take(
        Mp.tiles, jnp.asarray(Mp.index[outs[0], outs[1]], jnp.int32),
        axis=0)
    return (jnp.asarray(out_index[I, J]), ta, tb, Mtiles,
            np.stack(outs, 1))


@partial(jax.jit, static_argnums=(6, 7))
def _bsr_masked_jit(Atiles, Btiles, ta, tb, outid, Mtiles, nout,
                    acc_dtype):
    """C_out[outid[t]] += A_tile[ta[t]] @ B_tile[tb[t]]^T in
    ``acc_dtype`` (int32 from int8 0/1 tiles, f32 from value tiles),
    then zero outside M's tile pattern.  HIGHEST keeps f32 tiles off
    TF32: GraphBLAS results must match the reference within f32
    roundoff."""
    La = jnp.take(Atiles, ta, axis=0)            # [nt, T, T]
    Ub = jnp.take(Btiles, tb, axis=0)
    prec = (jax.lax.Precision.HIGHEST
            if jnp.issubdtype(acc_dtype, jnp.floating) else None)
    prod = jax.lax.dot_general(
        La, Ub, (((2,), (2,)), ((0,), (0,))),     # contract k, batch t
        preferred_element_type=acc_dtype, precision=prec)
    C = jax.ops.segment_sum(prod, outid, num_segments=nout)
    return C * (Mtiles != 0).astype(acc_dtype)


def bsr_masked_mm(Mp: TilePattern, Ap: TilePattern, Bp: TilePattern,
                  acc_dtype=jnp.int32) -> Tuple[jnp.ndarray, np.ndarray]:
    """General BSR product C<M> = A · B' over M's nonempty tiles,
    returning (Ctiles [nout, T, T], out tile coordinates [nout, 2]).
    With int8 0/1 tiles this is the counting (PLUS_LAND) semiring; with
    value tiles and ``acc_dtype=f32`` it is PLUS_TIMES.  ``masked_mxm``
    passes an all-ones mask over the tile-grid product for unmasked
    products."""
    T = Ap.T
    sched = build_schedule(Mp, Ap, Bp)
    if sched is None:
        outs = np.nonzero(Mp.grid)
        return (jnp.zeros((len(outs[0]), T, T), acc_dtype),
                np.stack(outs, 1))
    outid, ta, tb, Mtiles, outs = sched
    C = _bsr_masked_jit(Ap.tiles, Bp.tiles, ta, tb, outid, Mtiles,
                        len(outs), acc_dtype)
    return C, outs


def masked_mxm(M, A, B, semiring=None, T: int = TILE):
    """High-level large-graph mxm: C<M> = A (+.x) B through the BSR
    tile engine.

    M/A/B: bitmap Matrix or CsrMatrix; ``M=None`` computes the unmasked
    product (output structure bounded by the tile-grid product).
    PLUS_TIMES (float) uses f32 value tiles; boolean/counting semirings
    use int8 pattern tiles.  Returns a bitmap Matrix on the exact
    structure of the product intersected with the mask.
    """
    from ..core.matrix import Matrix, np_bool
    from ..core.types import BOOL, FP32, INT32
    from .container import CsrMatrix
    from ..ops.flopcount import record_axb_method

    def to_np(X):
        if isinstance(X, CsrMatrix):
            X = X.to_matrix()
        X = X.wait()
        return (np.asarray(jax.device_get(X.values)) if not X.type.is_udt
                else None), np_bool(X.pattern), X.type

    Av, Apat, At = to_np(A)
    Bv, Bpat, Bt = to_np(B)
    # dispatch: which algebra does the tile engine run?
    #   None           -> structural pair counts (INT32)
    #   PLUS_PAIR      -> structural pair counts (INT32)
    #   PLUS_LAND      -> truthy pair counts (INT32)
    #   LOR_LAND       -> truthy reachability (BOOL)
    #   PLUS_TIMES     -> float product (FP32)
    # anything else is not tile-expressible here — raise rather than
    # silently computing a different semiring (use gb.mxm instead).
    if semiring is None:
        mode = "count_structural"
    else:
        pair = (semiring.add.op.name, semiring.mult.name)
        if semiring.ztype.is_bool:
            # boolean renames (GB_boolean_rename): PLUS≡MAX≡LOR,
            # TIMES≡MIN≡LAND on bool
            ren = {"PLUS": "LOR", "MAX": "LOR", "TIMES": "LAND",
                   "MIN": "LAND"}
            pair = (ren.get(pair[0], pair[0]), ren.get(pair[1], pair[1]))
        if pair == ("PLUS", "TIMES"):
            mode = "values"
        elif pair == ("PLUS", "PAIR"):
            mode = "count_structural"
        elif pair == ("PLUS", "LAND"):
            mode = "count_truthy"
        elif pair in (("LOR", "LAND"), ("LOR", "PAIR")):
            mode = "bool"
        else:
            raise NotImplementedError(
                f"semiring {pair} is not expressible on the BSR tile "
                f"engine; use gb.mxm (bitmap backend) instead")
    # keep the structural pattern for the output (GraphBLAS: the result
    # pattern is the structural product, even when values reduce over
    # truthy pairs only)
    Apat_struct, Bpat_struct = Apat, Bpat
    if mode in ("count_truthy", "bool") and Av is not None:
        Apat = Apat & (Av != 0)
        Bpat = Bpat & (Bv != 0)
    Apt = tile_pattern(Apat, T)
    Bpt = tile_pattern(Bpat.T, T)
    Apt_s = (Apt if Apat is Apat_struct
             else tile_pattern(Apat_struct, T))
    Bpt_s = (Bpt if Bpat is Bpat_struct
             else tile_pattern(Bpat_struct.T, T))
    if M is None:
        Mpat = np.ones((Apat.shape[0], Bpat.shape[1]), bool)
        grid_out = np.einsum("ik,jk->ij", Apt_s.grid, Bpt_s.grid) > 0
        ones = jnp.ones((1, T, T), jnp.int8)
        Mt_tiles = TilePattern(
            ones, grid_out, np.zeros(grid_out.shape, np.int32),
            (grid_out.shape[0] * T, grid_out.shape[1] * T), T)
    else:
        _, Mpat, _ = to_np(M)
        Mt_tiles = tile_pattern(Mpat, T)
    # structural pattern of T = positions with >= 1 contributing pair of
    # PRESENT entries (the result pattern is M ∩ structural-pattern(A·B'),
    # even when the values reduce over truthy pairs only)
    Cnt_s, outs = bsr_masked_mm(Mt_tiles, Apt_s, Bpt_s, jnp.int32)
    if mode == "values":
        # value tiles run at f32; silently computing an FP64 PLUS_TIMES
        # at f32 would break the "match the reference within roundoff"
        # policy, so route f64 callers to gb.mxm (which accumulates in
        # f64) instead of degrading precision
        if any(t is not None and np.dtype(t.dtype) == np.float64
               for t in (At, Bt)) or (
                semiring is not None
                and np.dtype(semiring.ztype.dtype) == np.float64):
            raise TypeError(
                "BSR value tiles compute at f32 precision; FP64 "
                "PLUS_TIMES must go through gb.mxm (f64 accumulation)")
        Ap = tile_matrix(Av, Apat, T, np.float32)
        Bp = tile_matrix(Bv.T, Bpat.T, T, np.float32)
        C, outs = bsr_masked_mm(Mt_tiles, Ap, Bp, jnp.float32)
        out_t = FP32
        record_axb_method("bsr:values")
    elif mode == "count_structural":
        C = Cnt_s
        out_t = INT32
        record_axb_method("bsr:count")
    else:  # count_truthy / bool: counts over truthy pairs
        C, outs = bsr_masked_mm(Mt_tiles, Apt, Bpt, jnp.int32)
        out_t = INT32
        record_axb_method("bsr:count")
    # reassemble the bitmap result on M ∩ structure(A·B')
    m, n = Mpat.shape
    Cnp = np.asarray(C)
    Cntp = np.asarray(Cnt_s)
    Tm = Mt_tiles.grid.shape[0] * T
    Tn = Mt_tiles.grid.shape[1] * T
    Cn = np.zeros((Tm, Tn), Cnp.dtype)
    Sp = np.zeros((Tm, Tn), bool)
    for t_, (I, J) in enumerate(outs):
        Cn[I * T:(I + 1) * T, J * T:(J + 1) * T] = Cnp[t_]
        Sp[I * T:(I + 1) * T, J * T:(J + 1) * T] = Cntp[t_] > 0
    Cn = Cn[:m, :n]
    pat = Mpat & Sp[:m, :n]
    if mode == "bool":
        return Matrix(jnp.asarray(pat & (Cn > 0)), jnp.asarray(pat), BOOL)
    return Matrix(jnp.asarray(np.where(pat, Cn, 0)),
                  jnp.asarray(pat), out_t)
