"""Scale runs: tricount, BFS and PageRank on R-MAT graphs at scale 18
and 20 on one device, each timed to a host pull of its result.  Prints
one JSON line per (algorithm, scale) with time, rate, device memory and
the device it ran on.

Usage: python tools/scale_run.py [scales...]   (default: 18 20)

This is the analogue of the reference's committed measurement
databases (``Extras/tri/tri_grb_results.m``).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax                                          # noqa: E402
import jax.numpy as jnp                             # noqa: E402
import graphblas_tpu as gb                          # noqa: E402
from graphblas_tpu.core.semirings import semiring   # noqa: E402
from graphblas_tpu.models.rmat import rmat_edges    # noqa: E402
from graphblas_tpu.sparse import CsrMatrix          # noqa: E402
from graphblas_tpu.sparse import csr_mxv            # noqa: E402
from graphblas_tpu.sparse.tri import (tricount_esc,        # noqa: E402
                                      tricount_prep_csr)


def devmem():
    try:
        st = jax.local_devices()[0].memory_stats()
        return int(st.get("peak_bytes_in_use", st.get("bytes_in_use", 0)))
    except Exception:
        return None


def build(scale):
    n = 1 << scale
    I, J = rmat_edges(scale, 16, seed=7)
    # symmetrize + dedup + no self loops (host; native radix when
    # GBTPU_NATIVE_SYM=1, bit-identical numpy otherwise)
    from graphblas_tpu.models.rmat import symmetrize_pattern
    I, J = symmetrize_pattern(I, J, n)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL, sum_duplicates=False)
    return A, n, len(I)


def run_tricount(A, n, nnz, scale):
    # degree-ordered prep (the reference's tri_prep): orients each edge
    # from the lower-degree endpoint — orders of magnitude fewer wedges
    # on power-law graphs
    t0 = time.perf_counter()
    L, U = tricount_prep_csr(A)
    prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntri = tricount_esc(L, U)           # host int return = full sync
    cold = time.perf_counter() - t0     # includes jit compiles
    t0 = time.perf_counter()
    ntri2 = tricount_esc(L, U)
    dt = time.perf_counter() - t0       # warm: the kernel rate
    assert ntri == ntri2
    print(json.dumps({
        "alg": "tricount", "scale": scale, "n": n, "nnz": nnz,
        "ntri": ntri, "prep_s": prep, "cold_s": cold, "time_s": dt,
        "nnz_per_s": nnz / dt, "edges_per_s": (nnz // 2) / dt,
        "peak_dev_bytes": devmem(),
    }), flush=True)


def run_bfs(A, n, nnz, scale, src=0):
    sr = semiring.lor_land[gb.BOOL]
    # warm the kernel (the first compile of this shape is set-up; the
    # measurement is the graph walk)
    qw = jnp.zeros(n, bool).at[src].set(True)
    yw, _ = csr_mxv(sr, A, qw)
    int(jnp.sum(jnp.asarray(yw, bool)))
    v = np.zeros(n, bool)
    q = jnp.zeros(n, bool).at[src].set(True)
    v[src] = True
    vj = jnp.asarray(v)
    t0 = time.perf_counter()
    levels = 0
    nvisited = 1
    while True:
        y, _ = csr_mxv(sr, A, q)        # frontier expansion (A sym)
        q = jnp.asarray(y, bool) & ~vj
        newc = int(jnp.sum(q))          # host pull = sync per level
        if newc == 0:
            break
        vj = vj | q
        levels += 1
        nvisited += newc
    dt = time.perf_counter() - t0
    print(json.dumps({
        "alg": "bfs", "scale": scale, "n": n, "nnz": nnz,
        "levels": levels, "visited": nvisited, "time_s": dt,
        "traversed_edges_per_s": nnz * levels / dt,
        "peak_dev_bytes": devmem(),
    }), flush=True)


def run_pagerank(A, n, nnz, scale, iters=20):
    # row-stochastic scaling on the pattern: val(i,j) = 1/deg(i);
    # r' = A' (0.85 r) + teleport  via csr_mxv on A' slabs
    deg = np.asarray(A.row_degrees()).astype(np.float32)
    inv = 1.0 / np.maximum(deg, 1.0)
    # A values: since A is symmetric boolean, A' = A; scale by source
    # degree via x' = 0.85 * r * inv broadcast BEFORE the SpMV
    sr = semiring.plus_times[gb.FP32]
    Af = CsrMatrix(A.indptr, A.indices, A.rowids,
                   jnp.ones((A.nzmax,), jnp.float32), A.nvals, n, n,
                   gb.FP32)
    r = jnp.full(n, 1.0 / n, jnp.float32)
    invd = jnp.asarray(inv)
    a = 0.15 / n
    yw, _ = csr_mxv(sr, Af, 0.85 * r * invd)   # warm/compile
    float(jnp.sum(yw))
    t0 = time.perf_counter()
    for _ in range(iters):
        y, _ = csr_mxv(sr, Af, 0.85 * r * invd)
        r = y + a
    s = float(jnp.sum(r))               # sync
    dt = time.perf_counter() - t0
    print(json.dumps({
        "alg": "pagerank", "scale": scale, "n": n, "nnz": nnz,
        "iters": iters, "time_s": dt, "time_per_iter_s": dt / iters,
        "nnz_per_s_per_iter": nnz * iters / dt, "rank_sum": s,
        "peak_dev_bytes": devmem(),
    }), flush=True)


def main():
    scales = [int(a) for a in sys.argv[1:]] or [18, 20]
    algs = os.environ.get("SCALE_ALGS", "tricount,bfs,pagerank").split(",")
    for scale in scales:
        t0 = time.perf_counter()
        A, n, nnz = build(scale)
        dev = jax.devices()[0]
        print(json.dumps({"alg": "build", "scale": scale, "n": n,
                          "nnz": nnz,
                          "time_s": time.perf_counter() - t0,
                          "device": {"platform": dev.platform,
                                     "kind": dev.device_kind}}),
              flush=True)
        if "tricount" in algs:
            run_tricount(A, n, nnz, scale)
        if "bfs" in algs:
            run_bfs(A, n, nnz, scale)
        if "pagerank" in algs:
            run_pagerank(A, n, nnz, scale)


if __name__ == "__main__":
    main()
