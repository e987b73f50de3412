#!/usr/bin/env python
"""Distributed demo — the device-mesh replacement for the reference's
pthread/openmp/MPI demos: BFS, PageRank, and triangle counting over a
device mesh with psum frontier exchange.

Run on 1 or more GPUs, or on N virtual CPU devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python demos/dist_demo.py
"""
import sys

import numpy as np

sys.path.insert(0, ".")
import _common  # noqa: F401,E402
import jax                                                    # noqa: E402
import graphblas_tpu as gb                                    # noqa: E402
from graphblas_tpu import models, parallel as par             # noqa: E402


def main():
    print(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}")
    mesh = par.make_mesh()
    pat = models.wathen_pattern(6, 6)
    np.fill_diagonal(pat, False)
    A = gb.Matrix.from_dense(pat, gb.BOOL, pattern=pat)
    n = A.nrows
    print(f"graph: {n} nodes, {int(pat.sum())//2} edges, "
          f"mesh {mesh.devices.shape}")

    lev = par.dist_bfs(A, 0, mesh)
    print(f"dist_bfs: {int((lev != 0).sum())} reachable, "
          f"max level {int(lev.max())}")
    assert np.array_equal(lev, models.bfs_jit(A, 0))

    r = par.dist_pagerank(A, iters=20, mesh=mesh)
    print(f"dist_pagerank: top node {int(np.argmax(r))} "
          f"rank {r.max():.6f}")

    ntri = par.dist_tricount(A, mesh)
    want = int(((pat.astype(np.float64) @ pat) * pat).sum()) // 6
    print(f"dist_tricount: {ntri} triangles")
    assert ntri == want
    print("dist_demo OK")


if __name__ == "__main__":
    main()
