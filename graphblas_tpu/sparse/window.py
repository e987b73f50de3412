"""Window-panel masked SpGEMM: banded/clustered graphs as one dense
batched contraction.

A tile-triple BSR schedule (:mod:`bsr`) runs one 128^3 contraction per
(I,J,K) tile triple.  At FEM/banded tile densities (~1-2%) padding
costs ~50x the useful flops and the schedule pays a fixed per-triple
cost.  This engine exploits the structure those graphs actually have:
each 128-row block I of A touches a narrow contiguous window of
columns, and the masked output blocks J sit in a narrow window too.
The masked product then collapses to ONE batched dense contraction

    C_I = P_I @ Q_I^T        (P_I = A[I-rows, window], dense int8;
                              Q_I = B'[J-rows, window] stacked)

followed by a mask-multiply and a sum: a single XLA program per call.

Two forms of the masked count are kept side by side: the XLA form
(:func:`window_masked_count_sum`, a batched int8 ``dot_general`` whose
(nI, 128, nJmax*128) int32 product goes through device memory) and a
Pallas kernel for the GPU through Triton
(:func:`window_count_sum_triton`: one program per 128-row block
and 128-column tile, product tiles reduced in registers, one int32
partial row per program).  On the GPU ``tricount_auto`` takes the
kernel, the faster of the two there (PERF.md); elsewhere the XLA form.

Plan building is host-side from the CSR/COO pattern (O(nnz), no dense
n^2 intermediate) and cached per (A, B, M) pattern identity, like the
ESC plan cache.  ``build_window_plan`` returns None when the window
structure is too wide to pay (power-law graphs): callers fall back to
the sort-merge engines; this is the structural analogue of
``GB_AxB_select.c``'s method heuristic.

Reference counterpart: the masked-dot tricount workload
(``Demo/Source/tricount.c`` SandiaDot, ``Template/GB_AxB_dot_mask.c``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["WindowPlan", "build_window_plan", "window_masked_count_sum",
           "window_count_sum_triton", "window_masked_mm",
           "tricount_window"]

T = 128

#: reject plans whose contraction window exceeds this many 128-blocks —
#: wider windows mean the dense panels are mostly padding and the
#: sort-merge engines win
MAX_W_BLOCKS = 16
#: panel memory budget (bytes) for P+Q+M on device
MAX_PANEL_BYTES = 1 << 31


class WindowPlan:
    """Device panels + metadata for the batched window product."""

    def __init__(self, P, Q, M, nI, Wmax, nJmax, k0, j0, ntriples,
                 shape, mshape):
        self.P = P            # (nI, T, Wmax*T)
        self.Q = Q            # (nI, Wmax*T, nJmax*T) — B' panels, transposed
        self.M = M            # (nI, T, nJmax*T)
        self.nI = nI
        self.Wmax = Wmax
        self.nJmax = nJmax
        self.k0 = k0          # (nI,) window start block per I
        self.j0 = j0          # (nI,) output block start per I
        self.ntriples = ntriples   # real tile-triple count (flop truth)
        self.shape = shape
        self.mshape = mshape

    @property
    def panel_bytes(self):
        return self.P.nbytes + self.Q.nbytes + self.M.nbytes


def _block_panels(rows, cols, nrows, lo, hi, width, starts, dtype,
                  vals=None):
    """Scatter COO entries into per-block dense panels.

    rows/cols: COO (sorted by row); for block b (0-based over
    ``len(lo)`` blocks), rows in [lo[b], hi[b]) land in panel b at
    local (row - lo[b], col - starts[b]) when the col is inside
    [starts[b], starts[b]+width).  Returns (nb, maxrows, width)."""
    nb = len(lo)
    maxrows = int((hi - lo).max()) if nb else 0
    out = np.zeros((nb, maxrows, width), dtype)
    # entries may belong to several overlapping blocks -> loop blocks,
    # slice by row range (rows sorted, searchsorted)
    r0 = np.searchsorted(rows, lo)
    r1 = np.searchsorted(rows, hi - 1, side="right")
    for b in range(nb):
        s, e = r0[b], r1[b]
        if s == e:
            continue
        lr = rows[s:e] - lo[b]
        lc = cols[s:e] - starts[b]
        keep = (lc >= 0) & (lc < width)
        if vals is None:
            out[b, lr[keep], lc[keep]] = 1
        else:
            out[b, lr[keep], lc[keep]] = vals[s:e][keep]
    return out


def _host_coo(X) -> Optional[Tuple[np.ndarray, np.ndarray, int, int]]:
    """(rows, cols, nrows, ncols) host pattern of a CsrMatrix, in row
    order, or None when unavailable without a device pull."""
    hp = X._options.get("host_pattern")
    if hp is None:
        return None
    rows, cols = hp
    rows = np.asarray(rows[:X.nvals])
    cols = np.asarray(cols[:X.nvals])
    if len(rows) > 1 and not (rows[:-1] <= rows[1:]).all():
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
    return rows, cols, X.nrows, X.ncols


def build_window_plan(A, B, M):
    """Host-side plan for C<M> = A · B^T on CsrMatrix patterns (B given
    in ROW form: Q panels take B's rows, matching the tile-triple
    schedule's B(J,K) orientation).  Returns a WindowPlan or None when
    the window structure doesn't pay.  Cached on A._options keyed by
    the operand identities."""
    key = ("_window_plan", id(B), id(M))
    plan = A._options.get(key)
    if plan is not None:
        return plan if isinstance(plan, WindowPlan) else None
    hA, hB, hM = _host_coo(A), _host_coo(B), _host_coo(M)
    if hA is None or hB is None or hM is None:
        return None
    ra, ca, m, k = hA
    rb, cb, nB, kB = hB
    rm, cm, mM, nM = hM
    nI = -(-m // T)
    nKb = -(-k // T)
    nJb = -(-nM // T)
    # per-block-row column window of A
    ba = ra // T
    k0 = np.full(nI, 0, np.int64)
    kw = np.zeros(nI, np.int64)
    first = np.searchsorted(ba, np.arange(nI))
    last = np.searchsorted(ba, np.arange(nI), side="right")
    for I in range(nI):
        if first[I] == last[I]:
            continue
        cs = ca[first[I]:last[I]]
        b0, b1 = cs.min() // T, cs.max() // T + 1
        k0[I] = b0
        kw[I] = b1 - b0
    # per-block-row output window of M
    bm = rm // T
    j0 = np.zeros(nI, np.int64)
    jw = np.zeros(nI, np.int64)
    firstm = np.searchsorted(bm, np.arange(nI))
    lastm = np.searchsorted(bm, np.arange(nI), side="right")
    for I in range(nI):
        if firstm[I] == lastm[I]:
            continue
        cs = cm[firstm[I]:lastm[I]]
        b0, b1 = cs.min() // T, cs.max() // T + 1
        j0[I] = b0
        jw[I] = b1 - b0
    Wmax = int(kw.max()) if nI else 0
    nJmax = int(jw.max()) if nI else 0
    ok = (Wmax and nJmax and Wmax <= MAX_W_BLOCKS
          and nJmax <= MAX_W_BLOCKS)
    if ok:
        pb = (nI * T * Wmax * T + nI * nJmax * T * Wmax * T
              + nI * T * nJmax * T)
        ok = pb <= MAX_PANEL_BYTES
    # B-side windows must also be narrow for Q to be dense-packable:
    # Q rows are B's rows over A's window — coverage is guaranteed by
    # construction (zeros outside), no extra condition needed.
    if not ok:
        A._options[key] = False
        return None
    dt = np.int8
    # P panels: A block-rows [I*T, (I+1)*T) over their windows
    P = _block_panels(ra, ca, m, np.arange(nI) * T, np.arange(nI) * T + T,
                      Wmax * T, k0 * T, dt)
    # Q panels: B rows [j0*T, (j0+nJmax)*T) over A's window cols —
    # stored TRANSPOSED (window, rows) so the device contraction is a
    # plain A @ B, the layout both the batched dot and the kernel's
    # tile loads want
    Q = _block_panels(rb, cb, nB, j0 * T, j0 * T + nJmax * T,
                      Wmax * T, k0 * T, dt).transpose(0, 2, 1).copy()
    # M panels: mask block-rows over output cols [j0*T, (j0+nJmax)*T)
    Mm = _block_panels(rm, cm, mM, np.arange(nI) * T,
                       np.arange(nI) * T + T, nJmax * T, j0 * T, np.int8)
    # real tile-triple count for honest device-flop accounting
    occA = np.zeros((nI, nKb), bool)
    occA[ba, ca // T] = True
    occB = np.zeros((-(-nB // T), nKb), bool)
    occB[rb // T, cb // T] = True
    occM = np.zeros((nI, -(-nM // T)), bool)
    occM[bm, cm // T] = True
    ntr = int(np.einsum("ik,jk,ij->", occA.astype(np.int64),
                        occB.astype(np.int64), occM.astype(np.int64)))
    plan = WindowPlan(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(Mm),
                      nI, Wmax, nJmax, k0, j0, ntr, (m, k), (mM, nM))
    A._options[key] = plan
    return plan


@jax.jit
def _count_sum_jit(P, Q, M):
    C = jax.lax.dot_general(P, Q, (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.int32)
    # exact grand total in int64 (per-entry counts fit int32 easily;
    # the sum does not at large scale)
    return jnp.sum((C * M.astype(jnp.int32)).astype(jnp.int64))


def window_masked_count_sum(plan: WindowPlan):
    """sum over mask entries of the structural product — ONE program.
    (The tricount kernel: the masked wedge total IS the triangle
    count for the SandiaDot formulation.)"""
    from ..ops.flopcount import record_axb_method
    record_axb_method("window:count_sum")
    return _count_sum_jit(plan.P, plan.Q, plan.M)


#: Triton kernel shape, tuned on the card (PERF.md): contraction chunk
#: and output-column tile (both divide every plan's W*128 and
#: nJmax*128), warps per program, software-pipeline stages
_TK = 128
_TN = 128
_WARPS = 4
_STAGES = 3


def _count_kernel(p_ref, q_ref, m_ref, o_ref):
    """One (128-row block, 128-column tile) program: masked column sums
    of P @ Q kept in registers.  0/1 operands go to the tensor cores as
    fp16 with f32 accumulation; every count is at most W*128 <= 2048,
    so both are exact."""
    i32 = jnp.int32

    def kstep(k, acc):
        ks = pl.ds(k * _TK, _TK)
        p = p_ref[:, ks].astype(jnp.float16)
        q = q_ref[ks, :].astype(jnp.float16)
        return acc + jax.lax.dot(p, q, preferred_element_type=jnp.float32)

    acc = jax.lax.fori_loop(i32(0), i32(p_ref.shape[1] // _TK), kstep,
                            jnp.zeros((T, _TN), jnp.float32))
    o_ref[...] = jnp.sum(acc.astype(i32) * m_ref[...].astype(i32), axis=0,
                         dtype=i32)


@partial(jax.jit, static_argnums=(3,))
def _count_triton_jit(P, Q, M, interpret: bool):
    nI, _, K = P.shape
    N = Q.shape[2]
    parts = pl.pallas_call(
        _count_kernel,
        grid=(nI, N // _TN),
        in_specs=[pl.BlockSpec((None, T, K), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((None, K, _TN), lambda i, j: (i, 0, j)),
                  pl.BlockSpec((None, T, _TN), lambda i, j: (i, 0, j))],
        out_specs=pl.BlockSpec((None, _TN), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((nI, N), jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=_WARPS,
                                             num_stages=_STAGES),
        backend="triton",
        interpret=interpret,
        name="window_count",
    )(P, Q, M)
    # each column sum is bounded by 128 * 2048; the total is not
    return jnp.sum(parts.astype(jnp.int64))


def window_count_sum_triton(plan: WindowPlan, interpret: bool = False):
    """Same value as :func:`window_masked_count_sum` through the Pallas
    Triton kernel: the (nI, 128, nJmax*128) product never reaches device
    memory.  ``interpret=True`` runs the kernel on the CPU (tests)."""
    from ..ops.flopcount import record_axb_method
    record_axb_method("window:count_triton")
    return _count_triton_jit(plan.P, plan.Q, plan.M, interpret)


@jax.jit
def _masked_mm_jit(P, Q, M):
    C = jax.lax.dot_general(P, Q, (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.int32)
    return C * M.astype(jnp.int32)


def window_masked_mm(plan: WindowPlan):
    """Masked product panels (nI, T, nJmax*T): C_I = (P_I @ Q_I') ⊙ M_I.
    Host assembly maps panel (I, r, c) -> global (I*T + r, j0[I]*T + c)."""
    from ..ops.flopcount import record_axb_method
    record_axb_method("window:masked_mm")
    return _masked_mm_jit(plan.P, plan.Q, plan.M)


def tricount_window(L, U) -> Optional[int]:
    """SandiaDot triangle count via the window engine: ntri =
    sum over L of (L · U')(i,j).  Returns None when the plan rejects
    the structure (fall back to the tile/sort engines)."""
    plan = build_window_plan(L, U, L)
    if plan is None:
        return None
    return int(np.asarray(window_masked_count_sum(plan)))
