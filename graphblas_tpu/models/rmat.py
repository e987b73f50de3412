"""R-MAT / Kronecker power-law graph generator (Graph500-style).

The reference generates Kronecker graphs by explicit tuple expansion
(``Extras/ExactKronGen``); the R-MAT recursive form generates the same
family directly at scale: each edge picks one quadrant per bit level
with probabilities (a, b, c, d).  Two vectorized generators of the same
family: ``rmat_edges`` on the host (numpy's stream) and
``rmat_edges_device``, which draws, symmetrizes, sorts and dedups on the
default device and only brings the final edge list to the host — the
form that reaches scale 22 and beyond in seconds.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["rmat_edges", "rmat_edges_device", "rmat_graph",
           "symmetrize_pattern"]


def rmat_edges(scale: int, edge_factor: int = 16,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               seed: int = 1,
               dedup: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(I, J) of an undirected R-MAT graph: 2^scale nodes,
    ~edge_factor * 2^scale edges (Graph500 parameters by default)."""
    n = 1 << scale
    ne = edge_factor * n
    rng = np.random.default_rng(seed)
    I = np.zeros(ne, np.int64)
    J = np.zeros(ne, np.int64)
    ab = a + b
    c_norm = c / (1 - ab)
    a_norm = a / ab
    for depth in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        i_bit = r1 > ab
        j_bit = np.where(i_bit, r2 > c_norm, r2 > a_norm)
        I |= (i_bit.astype(np.int64) << depth)
        J |= (j_bit.astype(np.int64) << depth)
    # symmetrize + drop self edges
    keep = I != J
    I, J = I[keep], J[keep]
    I2 = np.concatenate([I, J])
    J2 = np.concatenate([J, I])
    if dedup:
        lin = I2 * n + J2
        lin = np.unique(lin)
        I2, J2 = lin // n, lin % n
    return I2, J2


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _rmat_sorted_keys(scale: int, ne: int, a: float, b: float, c: float,
                      key):
    """Sorted symmetrized keys i*n+j of ``ne`` R-MAT draws, with a mask
    of the first copy of each key off the diagonal."""
    ab = a + b
    c_norm = c / (1 - ab)
    a_norm = a / ab

    def level(d, IJ):
        I, J = IJ
        k1, k2 = jax.random.split(jax.random.fold_in(key, d))
        r1 = jax.random.uniform(k1, (ne,), jnp.float32)
        r2 = jax.random.uniform(k2, (ne,), jnp.float32)
        i_bit = r1 > ab
        j_bit = jnp.where(i_bit, r2 > c_norm, r2 > a_norm)
        return (I | (i_bit.astype(jnp.int64) << d),
                J | (j_bit.astype(jnp.int64) << d))

    zero = jnp.zeros((ne,), jnp.int64)
    I, J = jax.lax.fori_loop(0, scale, level, (zero, zero))
    lin = jnp.sort(jnp.concatenate([(I << scale) | J, (J << scale) | I]))
    first = jnp.concatenate([jnp.ones((1,), bool), lin[1:] != lin[:-1]])
    return lin, first & ((lin >> scale) != (lin & ((1 << scale) - 1)))


def rmat_edges_device(scale: int, edge_factor: int = 16,
                      a: float = 0.57, b: float = 0.19, c: float = 0.19,
                      seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Same family and contract as :func:`rmat_edges` (undirected,
    deduplicated, no self edges, row-major sorted host int64 arrays),
    drawn on the default device with ``jax.random`` — a different
    random stream, so a different graph for the same seed."""
    lin, keep = _rmat_sorted_keys(scale, edge_factor << scale, a, b, c,
                                  jax.random.key(seed))
    lin = np.asarray(lin)[np.asarray(keep)]
    return lin >> scale, lin & ((1 << scale) - 1)


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 1):
    """R-MAT graph as a CsrMatrix (boolean structure, fp32 ones)."""
    from ..sparse.container import csr_from_coo
    from ..core.types import FP32
    I, J = rmat_edges(scale, edge_factor, seed=seed)
    n = 1 << scale
    return csr_from_coo(I, J, np.ones(len(I), np.float32), n, n,
                        type=FP32, sum_duplicates=False)


def symmetrize_pattern(I: np.ndarray, J: np.ndarray, n: int):
    """Sorted unique {(i,j)} U {(j,i)} minus the diagonal — the
    standard undirected-graph prep of every runner.  Uses the native
    OpenMP radix path when built (numpy fallback is bit-identical)."""
    import os
    if os.environ.get("GBTPU_NATIVE_SYM"):
        # opt-in: the radix path wins on many-core hosts; on a few
        # cores numpy's unique is competitive
        from ..io.native import sym_dedup_native
        nat = sym_dedup_native(np.asarray(I, np.int64),
                               np.asarray(J, np.int64), n)
        if nat is not None:
            return nat
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    return lin // n, lin % n
