"""Breadth-first search, level labelling.

Reference algorithms (re-expressed on this framework's API, not ported):

* ``Demo/Source/bfs5m.c`` — the "vector assign & reduce" formulation:
  per level, ``v<q> = level`` (masked assign), ``q<!v> = q ||.&& A``
  (vxm over the LOR-LAND semiring with complemented mask + REPLACE),
  stop when ``reduce(q, LOR)`` finds no successor.
* ``Demo/Source/bfs6.c`` — the "apply" formulation: v accumulates
  level*q via apply + eWise add.
* ``Demo/Source/bfs_level.c`` — single-step level update used by bfs6.

The *_check variants (``bfs5m_check.c`` / ``bfs6_check.c``) differ only by
error checking in C; here errors are exceptions, so one implementation
serves both — aliases are exported for API parity.

Device notes: each level is one masked SpMV as a matmul (bitmap backend)
or a gather/segment-reduce (CSR backend); the whole level loop can also
run fully jitted via ``lax.while_loop`` (``bfs_jit``) which is the form
used by the benchmark and the distributed driver.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.descriptor import Descriptor
from ..core.matrix import Matrix, Vector
from ..core.semirings import semiring
from ..core.monoids import monoid
from ..core.types import BOOL, INT32
from ..ops.assign import assign_vector
from ..ops.mxm import vxm
from ..ops.reduce import reduce_to_scalar

__all__ = ["bfs5m", "bfs6", "bfs", "bfs_level", "bfs_jit",
           "bfs5m_check", "bfs6_check"]

_SR_DESC = Descriptor(mask_scmp=True, replace=True)


def bfs5m(A: Matrix, s: int) -> Vector:
    """BFS levels via masked assign + vxm (reference ``bfs5m.c:33-95``).

    v[i] = level of node i (1 for the source), 0 if unreachable.
    """
    n = A.nrows
    v = Vector.from_dense(np.zeros(n, np.int32), INT32)        # dense v = 0
    q = Vector.new(BOOL, n).setElement(True, s)                # q[s] = true
    boolean = semiring.lor_land[BOOL]
    lor = monoid.lor[BOOL]

    successor = True
    level = 1
    while successor and level <= n:
        # v<q> = level
        v = assign_vector(v, q, None, level, None, None, scalar=True)
        # q<!v> = q ||.&& A   (complemented mask: v!=0 marks visited)
        q = vxm(q, v, None, boolean, q, A, _SR_DESC)
        # successor = ||(q)
        successor = bool(reduce_to_scalar(None, lor, q))
        level += 1

    # make v sparse: v<v> = v with REPLACE (drops the explicit zeros)
    v = assign_vector(v, v, None, v, None, Descriptor(replace=True))
    return v


def bfs_level(v: Vector, q: Vector, level: int) -> Vector:
    """One level update v += level*q (reference ``bfs_level.c``:
    apply with a level-binding unary op)."""
    from ..core.ops import UnaryOp
    from ..ops.ewise import apply as gb_apply
    from ..core.ops import binary
    op = UnaryOp(f"LEVEL{level}", lambda x: jnp.full_like(
        jnp.asarray(x, jnp.int32), level), INT32, BOOL)
    return gb_apply(v, None, binary.plus[INT32], op, q, None)


def bfs6(A: Matrix, s: int) -> Vector:
    """BFS via apply (reference ``bfs6.c``): v accumulates level masks."""
    n = A.nrows
    v = Vector.new(INT32, n)
    q = Vector.new(BOOL, n).setElement(True, s)
    boolean = semiring.lor_land[BOOL]
    lor = monoid.lor[BOOL]
    anyq = True
    level = 1
    while anyq and level <= n:
        v = bfs_level(v, q, level)
        # q<!v> = q ||.&& A
        q = vxm(q, v, None, boolean, q, A, _SR_DESC)
        anyq = bool(reduce_to_scalar(None, lor, q))
        level += 1
    return v


# checked variants: identical here (errors are exceptions)
bfs5m_check = bfs5m
bfs6_check = bfs6
bfs = bfs5m


@partial(jax.jit, static_argnums=(3,))
def _bfs_jit_impl(apat, avals, s, n):
    """Fully-jitted BFS on the boolean pattern: lax.while_loop over
    frontier SpMV.  Returns int32 levels (0 = unreachable)."""
    A = apat  # [n, n] bool adjacency pattern

    def cond(state):
        level, v, q = state
        return jnp.any(q) & (level <= n)

    def body(state):
        level, v, q = state
        v = jnp.where(q, level, v)
        # frontier = q OR.AND A, masked by unvisited
        nxt = (jnp.matmul(q[None, :].astype(jnp.float32),
                          A.astype(jnp.float32),
                          preferred_element_type=jnp.float32)[0] > 0)
        q = nxt & (v == 0)
        return level + 1, v, q

    q0 = jnp.zeros((A.shape[0],), bool).at[s].set(True)
    v0 = jnp.zeros((A.shape[0],), jnp.int32)
    _, v, _ = jax.lax.while_loop(cond, body, (jnp.int32(1), v0, q0))
    return v


def bfs_jit(A: Matrix, s: int) -> np.ndarray:
    """Benchmark-grade BFS: one compiled while_loop, no host round-trips."""
    A = A.wait()
    return np.asarray(_bfs_jit_impl(A.pattern, A.values, s, A.nrows))
