"""Distributed graph algorithms over the device mesh.

These are the scaled versions of :mod:`graphblas_tpu.models` — same math,
but the adjacency matrix is row-block-sharded with ``shard_map`` and the
per-iteration exchanges are XLA collectives (psum/pmax over ICI), the
design the reference sketched but never built
(``GB_AxB_parallel.c:52-74``; SURVEY.md §7 step 8).

Every step function here is a single jitted SPMD program: the whole BFS /
PageRank iteration loop runs on-device in a ``lax.while_loop`` /
``fori_loop``, with one collective per iteration and no host round trips.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.matrix import Matrix
from ..core.semirings import semiring
from ..core.types import BOOL, INT32, UINT32
from .dist import DistMatrix, distribute
from .mesh import make_mesh

__all__ = ["dist_bfs", "dist_pagerank", "dist_tricount",
           "bfs_step_sharded", "pagerank_step_sharded"]


# ---------------------------------------------------------------------------
# BFS: the frontier loop as one SPMD while_loop
# ---------------------------------------------------------------------------

_PROG_CACHE = {}


def _cached(key, build):
    f = _PROG_CACHE.get(key)
    if f is None:
        f = build()
        _PROG_CACHE[key] = f
    return f


def _bfs_spmd_cached(mesh: Mesh, n: int):
    return _cached(("bfs", id(mesh), n), lambda: _bfs_spmd(mesh, n))


def _bfs_spmd(mesh: Mesh, n: int):
    """Build the sharded BFS program for an n-row (padded) matrix."""

    def local(Ap, s):
        # Ap: this device's row block [blk, n]; all vectors replicated.
        blk = Ap.shape[0]
        di = jax.lax.axis_index("i")
        row0 = di * blk

        def cond(state):
            level, v, q = state
            return jnp.any(q) & (level <= n)

        def body(state):
            level, v, q = state
            v = jnp.where(q, level, v)
            # local partial: my frontier rows x my row block
            qblk = jax.lax.dynamic_slice(q, (row0,), (blk,))
            part = jnp.matmul(qblk[None, :].astype(jnp.float32),
                              Ap.astype(jnp.float32),
                              preferred_element_type=jnp.float32)[0]
            # frontier exchange: one psum over the row shards
            nxt = jax.lax.psum(part, "i") > 0
            q = nxt & (v == 0)
            return level + 1, v, q

        q0 = (jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
              == s)
        v0 = jnp.zeros((n,), jnp.int32)
        _, v, _ = jax.lax.while_loop(cond, body, (jnp.int32(1), v0, q0))
        return v

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None), P()),
        out_specs=P(None)))


def dist_bfs(A, s: int, mesh: Optional[Mesh] = None) -> np.ndarray:
    """BFS levels at scale: A row-sharded, one psum per level.

    Accepts a Matrix (sharded here) or a DistMatrix.
    """
    if isinstance(A, Matrix):
        A = distribute(A, mesh or make_mesh(), square=True)
    n = A.pattern.shape[1]
    prog = _bfs_spmd_cached(A.mesh, n)
    from . import introspect
    introspect.record("dist_bfs", prog, (A.pattern, jnp.int32(s)))
    v = prog(A.pattern, jnp.int32(s))
    return np.asarray(v)[:A.nrows]


# exported step for the multichip dryrun: one masked frontier expansion
def bfs_step_sharded(mesh: Mesh):
    """(v, q, Ap) -> (v', q'): one BFS level as an SPMD step."""
    def local(v, q, Ap, level):
        blk = Ap.shape[0]
        di = jax.lax.axis_index("i")
        qblk = jax.lax.dynamic_slice(q, (di * blk,), (blk,))
        v = jnp.where(q, level, v)
        part = jnp.matmul(qblk[None, :].astype(jnp.float32),
                          Ap.astype(jnp.float32),
                          preferred_element_type=jnp.float32)[0]
        nxt = jax.lax.psum(part, "i") > 0
        return v, nxt & (v == 0)
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P("i", None), P()),
        out_specs=(P(None), P(None))))


# ---------------------------------------------------------------------------
# PageRank: damped power iteration, fori_loop of psum-SpMV
# ---------------------------------------------------------------------------

def _pagerank_spmd(mesh: Mesh, iters: int, n: int):
    def local(Cv, r0, a_scalar):
        blk = Cv.shape[0]
        n_pad = Cv.shape[1]
        di = jax.lax.axis_index("i")
        row0 = di * blk
        # zero the padded lanes after the teleport add, else jnp.sum(r)
        # counts phantom teleport mass on non-divisible n
        valid = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)[:, 0] < n

        def body(_, r):
            s = a_scalar * jnp.sum(r)
            rblk = jax.lax.dynamic_slice(0.85 * r, (row0,), (blk,))
            part = jnp.matmul(rblk[None, :], Cv,
                              preferred_element_type=Cv.dtype,
                              precision=jax.lax.Precision.HIGHEST)[0]
            r = jax.lax.psum(part, "i") + s
            return jnp.where(valid, r, 0)

        return jax.lax.fori_loop(0, iters, body, r0)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None), P(), P()),
        out_specs=P(None)))


def dist_pagerank(A, iters: int = 20,
                  mesh: Optional[Mesh] = None) -> np.ndarray:
    """Damped PageRank at scale (matches models.pagerank_jit)."""
    from ..models.pagerank import drowscale
    if isinstance(A, Matrix):
        C = drowscale(A)
        D = distribute(C, mesh or make_mesh(), square=True)
    else:
        D = A
    n_pad = D.pattern.shape[1]
    n = D.nrows
    prog = _cached(("pagerank", id(D.mesh), iters, n),
                   lambda: _pagerank_spmd(D.mesh, iters, n))
    r0 = jnp.full((n_pad,), 1.0 / n, jnp.asarray(D.values).dtype)
    r0 = jnp.where(jnp.arange(n_pad) < n, r0, 0.0)
    from . import introspect
    a_s = jnp.asarray((1 - 0.85) / n, jnp.asarray(D.values).dtype)
    introspect.record("dist_pagerank", prog, (D.values, r0, a_s))
    r = prog(D.values, r0, a_s)
    r = np.asarray(r)[:n]
    return r / r.sum()


def pagerank_step_sharded(mesh: Mesh):
    """(Cv, r, a) -> r': one distributed PageRank iteration (for the
    multichip dryrun and external training-style loops)."""
    def local(Cv, r, a_scalar):
        blk = Cv.shape[0]
        di = jax.lax.axis_index("i")
        s = a_scalar * jnp.sum(r)
        rblk = jax.lax.dynamic_slice(0.85 * r, (di * blk,), (blk,))
        part = jnp.matmul(rblk[None, :], Cv,
                          preferred_element_type=Cv.dtype,
                          precision=jax.lax.Precision.HIGHEST)[0]
        return jax.lax.psum(part, "i") + s
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None), P(), P()),
        out_specs=P(None)))


# ---------------------------------------------------------------------------
# Triangle counting: masked SpGEMM, row-sharded, mask fused
# ---------------------------------------------------------------------------

def _tricount_spmd(mesh: Mesh):
    def local(Lp, Up_full):
        # this device's row block of (L*U').*L : one matmul with the
        # mask applied in-register; count-sum via psum.
        prod = jnp.matmul(Lp.astype(jnp.float32),
                          Up_full.astype(jnp.float32).T,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        cnt = jnp.sum(jnp.where(Lp, prod, 0.0))
        total = jax.lax.psum(cnt, "i")
        return total[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("i", None), P(None, None)),
        out_specs=P(None)))


def dist_tricount(A, mesh: Optional[Mesh] = None) -> int:
    """SandiaDot triangle count (L*U').*L at scale: L row-sharded, U
    replicated, mask fused into the local block product."""
    from ..models.tricount import tricount_prep
    if isinstance(A, Matrix):
        mesh = mesh or make_mesh()
        L, U = tricount_prep(A)
        Ld = distribute(L, mesh, square=True)
        rep = NamedSharding(mesh, P(None, None))
        Up = jax.device_put(jnp.pad(
            U.wait().pattern,
            ((0, Ld.pattern.shape[0] - U.nrows),
             (0, Ld.pattern.shape[1] - U.ncols))), rep)
    else:
        raise TypeError("dist_tricount expects a Matrix")
    prog = _cached(("tricount", id(mesh)),
                   lambda: _tricount_spmd(mesh))
    total = prog(Ld.pattern, Up)
    return int(np.asarray(total)[0])
