"""Triangle counting — the north-star masked-SpGEMM workload.

Reference ``Demo/Source/tricount.c``: six methods over a symmetric binary
adjacency matrix A (E = edge incidence, L = tril(A), U = triu(A)):

  0 minitri:   ntri = nnz(A*E == 2) / 3
  1 Burkhardt: ntri = sum(sum((A*A) .* A)) / 6
  2 Cohen:     ntri = sum(sum((L*U) .* A)) / 2
  3 Sandia:    ntri = sum(sum((L*L) .* L))
  4 Sandia2:   ntri = sum(sum((U*U) .* U))
  5 SandiaDot: ntri = sum(sum((L*U') .* L))   (dot-product method)

On the bitmap backend every masked mxm is a single pattern-matmul with the mask
fused; the ".*" masks are the mxm mask argument exactly as in the
reference.  ``tricount_prep`` builds L and U with GxB_select (tril/triu).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.descriptor import Descriptor, TRAN1
from ..core.matrix import Matrix
from ..core.monoids import monoid
from ..core.ops import UnaryOp, select as selectops
from ..core.semirings import semiring
from ..core.types import INT64, UINT32
from ..ops.ewise import apply as gb_apply, select as gb_select
from ..ops.mxm import mxm
from ..ops.reduce import reduce_to_scalar

__all__ = ["tricount", "tricount_prep", "METHODS"]

METHODS = ("minitri", "Burkhardt", "Cohen", "Sandia", "Sandia2", "SandiaDot")


def tricount_prep(A: Matrix) -> Tuple[Matrix, Matrix]:
    """L = tril(A,-1), U = triu(A,1) via GxB_select (``tri_demo.c``)."""
    n = A.nrows
    L = gb_select(Matrix.new(A.type, n, n), None, None, selectops.tril,
                  A, -1)
    U = gb_select(Matrix.new(A.type, n, n), None, None, selectops.triu,
                  A, 1)
    return L, U


def edge_incidence(A: Matrix) -> Matrix:
    """E: n x ne edge incidence matrix of the undirected graph A
    (for minitri; ``tricount.m`` definition: E(:,e) has 1s at both
    endpoints of edge e, one column per upper-triangular edge)."""
    Ap = A.wait().pattern_np()
    iu, ju = np.nonzero(np.triu(Ap, 1))
    ne = len(iu)
    I = np.concatenate([iu, ju])
    J = np.concatenate([np.arange(ne), np.arange(ne)])
    X = np.ones(2 * ne, np.uint32)
    return Matrix.from_coo(I, J, X, A.nrows, ne, type=UINT32)


def tricount(method, A: Optional[Matrix] = None, E: Optional[Matrix] = None,
             L: Optional[Matrix] = None, U: Optional[Matrix] = None) -> int:
    """# of triangles by the named/numbered method (reference
    ``tricount.c:75-191``)."""
    if isinstance(method, str):
        method = METHODS.index(method)
    plus_times = semiring.plus_times[UINT32]
    plus_int64 = monoid.plus[INT64]

    if method == 0:       # minitri
        if E is None:
            E = edge_incidence(A)
        n, ne = A.nrows, E.ncols
        C = mxm(Matrix.new(UINT32, n, ne), None, None, plus_times, A, E)
        two = UnaryOp("TWO", lambda x: (x == 2).astype(jnp.uint32),
                      UINT32, UINT32)
        S = gb_apply(Matrix.new(UINT32, n, ne), None, None, two, C)
        ntri = int(reduce_to_scalar(None, plus_int64, S)) // 3
    elif method == 1:     # Burkhardt
        n = A.nrows
        C = mxm(Matrix.new(UINT32, n, n), A, None, plus_times, A, A)
        ntri = int(reduce_to_scalar(None, plus_int64, C)) // 6
    elif method == 2:     # Cohen
        n = A.nrows
        C = mxm(Matrix.new(UINT32, n, n), A, None, plus_times, L, U)
        ntri = int(reduce_to_scalar(None, plus_int64, C)) // 2
    elif method == 3:     # Sandia: (L*L).*L
        n = L.nrows
        C = mxm(Matrix.new(UINT32, n, n), L, None, plus_times, L, L)
        ntri = int(reduce_to_scalar(None, plus_int64, C))
    elif method == 4:     # Sandia2: (U*U).*U
        n = U.nrows
        C = mxm(Matrix.new(UINT32, n, n), U, None, plus_times, U, U)
        ntri = int(reduce_to_scalar(None, plus_int64, C))
    elif method == 5:     # SandiaDot: (L*U').*L
        n = U.nrows
        C = mxm(Matrix.new(UINT32, n, n), L, None, plus_times, L, U, TRAN1)
        ntri = int(reduce_to_scalar(None, plus_int64, C))
    else:
        raise ValueError(f"invalid tricount method {method}")
    return ntri
