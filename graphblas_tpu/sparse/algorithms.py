"""Whole-loop graph algorithms on the padded-CSR backend, fully jitted.

The bitmap `models.bfs_jit` / `pagerank_jit` run dense O(n²) SpMVs; at
large scale these edge-parallel forms do O(nnz) work per iteration and
the *entire* level/power loop compiles into one XLA program
(`lax.while_loop` / `fori_loop`) — zero host round-trips, the shape a
production serving system runs.

Frontier expansion is one gather + one segment-max; PageRank's SpMV is
one gather + multiply + segment-sum.  Both use the containers' sentinel
padding so no masking branches appear in the hot loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .container import CsrMatrix

__all__ = ["bfs_csr", "pagerank_csr"]


@partial(jax.jit, static_argnums=(3,))
def _bfs_csr_impl(rows, cols, s, n):
    """Levels via edge-parallel frontier expansion.

    rows/cols: the COO dual of A (sentinel-padded); frontier q gathers
    at rows, lands at cols with a segment-max OR.
    """
    rows_c = jnp.minimum(rows, n)     # sentinel -> dropped segment
    cols_c = jnp.minimum(cols, n)

    def cond(state):
        level, lev, q = state
        return jnp.any(q) & (level <= n)

    def body(state):
        level, lev, q = state
        lev = jnp.where(q, level, lev)
        qg = jnp.take(jnp.concatenate([q, jnp.zeros((1,), bool)]),
                      rows_c, axis=0)
        hit = jax.ops.segment_max(qg.astype(jnp.int32), cols_c,
                                  num_segments=n + 1)[:n] > 0
        q = hit & (lev == 0)
        return level + 1, lev, q

    q0 = jnp.zeros((n,), bool).at[s].set(True)
    lev0 = jnp.zeros((n,), jnp.int32)
    _, lev, _ = jax.lax.while_loop(cond, body, (jnp.int32(1), lev0, q0))
    return lev


def bfs_csr(A: CsrMatrix, s: int) -> np.ndarray:
    """BFS levels (1 = source, 0 = unreachable), one compiled loop."""
    return np.asarray(_bfs_csr_impl(A.rowids, A.indices, jnp.int32(s),
                                    A.nrows))


@partial(jax.jit, static_argnums=(3, 4))
def _pagerank_csr_impl(rows, cols, inv_deg_vals, n, iters):
    """Damped power iteration, edge-parallel: one segment-sum SpMV per
    step.  inv_deg_vals[k] = 1/outdeg(row of edge k) (prescaled)."""
    rows_c = jnp.minimum(rows, n)
    cols_c = jnp.minimum(cols, n)
    damp = jnp.float32(0.85)
    tele = jnp.float32(0.15 / n)

    def body(_, r):
        # contribution of edge (i,j): r[i]/deg(i)
        r_ext = jnp.concatenate([r, jnp.zeros((1,), r.dtype)])
        contrib = jnp.take(r_ext, rows_c, axis=0) * inv_deg_vals
        nxt = jax.ops.segment_sum(contrib, cols_c,
                                  num_segments=n + 1)[:n]
        # dangling nodes redistribute uniformly (matches drowscale's
        # empty-row handling of the demo: their rank mass drops)
        return damp * nxt + tele * jnp.sum(r)

    r0 = jnp.full((n,), 1.0 / n, jnp.float32)
    return jax.lax.fori_loop(0, iters, body, r0)


def pagerank_csr(A: CsrMatrix, iters: int = 20) -> np.ndarray:
    """PageRank ranks (normalized), one compiled loop over the edges."""
    rid = np.asarray(A.rowids)[:A.nvals]
    deg = np.bincount(rid, minlength=A.nrows).astype(np.float32)
    inv = np.zeros(A.nzmax, np.float32)
    inv[:A.nvals] = 1.0 / deg[rid]
    r = _pagerank_csr_impl(A.rowids, A.indices, jnp.asarray(inv),
                           A.nrows, iters)
    r = np.asarray(r)
    return r / r.sum()
