"""k-truss and all-k-truss decomposition.

Reference: ``Extras/ktruss/ktruss_graphblas.c`` (C_k = largest subgraph
where every edge is in >= k-2 triangles of C_k: iterate
``C<C> = C*C (plus_land)`` then prune entries with support < k-2 until the
edge count stops changing) and ``Extras/ktruss/allktruss.c`` /
``allktruss_graphblas.c`` (sweep k = 3.. until the truss is empty,
reusing the k-truss of k-1 as the starting point).

Each iteration is one masked matmul + one select; on the bitmap
backend the plus_land support count is the pattern matmul itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.matrix import Matrix
from ..core.ops import SelectOp
from ..core.semirings import semiring
from ..core.types import INT64
from ..ops.ewise import select as gb_select
from ..ops.mxm import mxm

__all__ = ["ktruss", "allktruss"]

# user select op: keep entries with x >= support (support_function in
# ktruss_graphblas.c)
_support_op = SelectOp("SUPPORT", lambda i, j, x, k: x >= k)


def ktruss(A: Matrix, k: int,
           max_steps: Optional[int] = None) -> Tuple[Matrix, int]:
    """(C, nsteps): the k-truss of the symmetric boolean matrix A.

    C(i,j) = # of triangles the surviving edge (i,j) participates in.
    """
    if k < 3:
        raise ValueError("k must be >= 3")
    n = A.nrows
    support = k - 2
    plus_land = semiring.plus_land[INT64]
    last_cnz = A.nvals()
    C = None
    nsteps = 0
    while True:
        nsteps += 1
        Cin = A if C is None else C
        # C<Cin> = Cin * Cin (plus_land): per-edge triangle support
        C = mxm(Matrix.new(INT64, n, n), Cin, None, plus_land, Cin, Cin)
        # prune edges with support < k-2
        C = gb_select(Matrix.new(INT64, n, n), None, None, _support_op,
                      C, support)
        cnz = C.nvals()
        if cnz == last_cnz or (max_steps and nsteps >= max_steps):
            return C, nsteps
        last_cnz = cnz


def allktruss(A: Matrix, kmax: Optional[int] = None
              ) -> Dict[int, Dict[str, int]]:
    """All-k-truss sweep (reference ``allktruss.c``): stats per k until
    the truss vanishes.  Returns {k: {nedges, nsteps, nt}}."""
    n = A.nrows
    plus_land = semiring.plus_land[INT64]
    out: Dict[int, Dict[str, int]] = {}
    C = A
    k = 3
    last_cnz = A.nvals()
    while kmax is None or k <= kmax:
        support = k - 2
        nsteps = 0
        while True:
            nsteps += 1
            T = mxm(Matrix.new(INT64, n, n), C, None, plus_land, C, C)
            T = gb_select(Matrix.new(INT64, n, n), None, None,
                          _support_op, T, support)
            cnz = T.nvals()
            C = T
            if cnz == last_cnz:
                break
            last_cnz = cnz
        import numpy as _np
        total = C.to_dense().astype(_np.int64).sum()
        out[k] = {"nedges": cnz // 2, "nsteps": nsteps,
                  "nt": int(total) // 6}
        if cnz == 0:
            break
        k += 1
    return out
