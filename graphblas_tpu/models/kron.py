"""Kronecker graph generation (reference ``Extras/ExactKronGen``).

The reference's MPI program gives each rank a contiguous slice of A's
tuples, computes ``GxB_kron(my_A, B)`` locally, and writes its block —
zero inter-rank communication (``kron_mpi.c:56-96``,
``kron_submatrix.c:138-141``).  The device-mesh equivalent keeps that
communication-free 1-D tuple partition but maps shards onto the device
mesh (or hosts) instead of MPI ranks; each shard is a pure tuple
computation: tuple (ia,ja,xa) of A x tuple (ib,jb,xb) of B produces
entry (ia*bm+ib, ja*bn+jb, xa*xb) of C.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.matrix import Matrix
from ..core.ops import BinaryOp, binary
from ..core.types import FP64

__all__ = ["kron_tuples", "kron_submatrix", "kron_generate"]


def kron_tuples(IA, JA, XA, IB, JB, XB, bm: int, bn: int,
                op: Optional[BinaryOp] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All |A|*|B| Kronecker tuples, vectorized (the per-shard compute).
    ``op`` is the GxB_kron multiply operator (default TIMES)."""
    IA = np.asarray(IA, np.int64)[:, None]
    JA = np.asarray(JA, np.int64)[:, None]
    XA = np.asarray(XA, np.float64)[:, None]
    IB = np.asarray(IB, np.int64)[None, :]
    JB = np.asarray(JB, np.int64)[None, :]
    XB = np.asarray(XB, np.float64)[None, :]
    I = (IA * bm + IB).reshape(-1)
    J = (JA * bn + JB).reshape(-1)
    if op is None or op.name == "TIMES":
        X = (XA * XB).reshape(-1)
    else:
        import jax
        import jax.numpy as jnp
        X = np.asarray(jax.device_get(op(
            jnp.asarray(np.broadcast_to(XA, (XA.shape[0], XB.shape[1]))),
            jnp.asarray(np.broadcast_to(XB, (XA.shape[0], XB.shape[1])))
        ))).reshape(-1)
    return I, J, X


def kron_submatrix(IA, JA, XA, IB, JB, XB, bm: int, bn: int,
                   pid: int, np_: int, op: Optional[BinaryOp] = None):
    """The pid-th of np_ shards: slice A's tuples contiguously
    (``kron_submatrix.c:138-141``) and expand against all of B."""
    ntuples = len(IA)
    lo = (pid * ntuples) // np_
    hi = ((pid + 1) * ntuples) // np_
    return kron_tuples(IA[lo:hi], JA[lo:hi], XA[lo:hi], IB, JB, XB,
                       bm, bn, op=op)


def kron_generate(A: Matrix, B: Matrix, nshards: int = 1,
                  op: Optional[BinaryOp] = None) -> Matrix:
    """C = kron(A, B) via the sharded tuple expansion; with nshards > 1
    the shards are computed independently (communication-free) and
    concatenated, bit-identical to the MPI reference's gathered output."""
    A = A.wait()
    B = B.wait()
    IA, JA, XA = A.extractTuples()
    IB, JB, XB = B.extractTuples()
    bm, bn = B.nrows, B.ncols
    parts = [kron_submatrix(IA, JA, XA, IB, JB, XB, bm, bn, p, nshards,
                            op=op)
             for p in range(nshards)]
    I = np.concatenate([p[0] for p in parts])
    J = np.concatenate([p[1] for p in parts])
    X = np.concatenate([p[2] for p in parts])
    return Matrix.from_coo(I, J, X, A.nrows * bm, A.ncols * bn, type=FP64,
                           dup=binary.plus[FP64])
