"""Secondary benchmark: SpMV throughput (nnz/s per device) on an R-MAT
power-law graph through the edge-parallel CSR kernels — the BASELINE.json
"SpMV nnz/s per chip" metric.

Prints one JSON line naming the device.  The reference's core SpMV is
the sequential CSR walk inside its generated workers; published
single-core rates for such kernels are O(100 M) nnz/s.  Two device
kernels are timed, each call ended by ``block_until_ready``: the
one-gather edge-parallel form and the zero-gather sort-routed form
(``spmv.py``); the JSON reports the better, with both rates attached.
"""

import json
import os
import sys
import time

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import graphblas_tpu as gb                        # noqa: E402
from graphblas_tpu.core.semirings import semiring  # noqa: E402
from graphblas_tpu.models.rmat import rmat_edges   # noqa: E402
from graphblas_tpu.sparse import CsrMatrix, csr_mxv  # noqa: E402


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench_spmv: needs a GPU, JAX found "
                 f"{jax.devices()[0].platform}")
    scale = int(os.environ.get("SPMV_SCALE", "14"))
    n = 1 << scale
    I, J = rmat_edges(scale, 16, seed=7)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), np.float32), n, n,
                           type=gb.FP32, sum_duplicates=False)
    sr = semiring.plus_times[gb.FP32]
    x = jnp.asarray(np.random.default_rng(0).random(n).astype(np.float32))

    y, _ = csr_mxv(sr, A, x)
    y.block_until_ready()

    # kernel-rate timing: operand prep (casts/concats/plan) hoisted, the
    # fused jitted SpMV dispatched K times and blocked once.
    from graphblas_tpu.sparse.spmv import (_csr_mxv_densex_jit,
                                           _csr_mxv_sorted_jit, spmv_plan)
    x_ext = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
    gather_args = (sr.add.op.name, sr, A.nrows, sr.ztype.dtype, A.values,
                   A.indices, A.rowids, A.indptr, x_ext, sr.add.identity)
    avals_csc, rank, spp, scc = spmv_plan(A)
    sorted_args = (sr.add.op.name, sr, A.nrows, sr.ztype.dtype, avals_csc,
                   rank, spp, scc, A.rowids, A.indptr, x_ext,
                   sr.add.identity)

    def measure(kern, args, K=50):
        """Median seconds per call, each ended by block_until_ready."""
        jax.block_until_ready(kern(*args))  # warm
        times = []
        for _ in range(K):
            t0 = time.perf_counter()
            jax.block_until_ready(kern(*args))
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    dt_gather = measure(_csr_mxv_densex_jit, gather_args)
    dt_sorted = measure(_csr_mxv_sorted_jit, sorted_args)

    # SpMM (multi-vector) through the bucketed-ELL engine: the gather
    # cost is k-independent, so k vectors ride one random access.  k=32
    # keeps the slot intermediate < 2 GB at scale 18.
    from graphblas_tpu.sparse.spmm import spmm_plan, _spmm_jit
    plan = spmm_plan(A)
    kcols = 32
    Xk = jnp.asarray(np.random.default_rng(1).random(
        (n, kcols)).astype(np.float32))
    Xe = jnp.concatenate([Xk, jnp.zeros((1, kcols), jnp.float32)])
    Xpe = jnp.ones((1, 1), bool)
    avals_ext = jnp.concatenate([A.values, jnp.zeros((1,), jnp.float32)])
    spmm_args = ("PLUS", sr, A.nrows, np.dtype(np.float32), True,
                 plan.buckets, avals_ext, plan.cols_slot, plan.perm,
                 plan.rowids, Xe, Xpe, jnp.float32(0))
    dt_spmm = measure(_spmm_jit, spmm_args, K=30)

    # API rate: one public csr_mxv call
    api_call = measure(lambda: csr_mxv(sr, A, x)[0], (), K=10)

    dt = min(dt_gather, dt_sorted)
    rate = A.nvals / dt

    # correctness spot check against the host CSR arrays
    indptr = np.asarray(A.indptr)
    idx = np.asarray(A.indices)[:A.nvals]
    vals = np.asarray(A.values)[:A.nvals]
    xh = np.asarray(x)
    yh = np.asarray(y)
    for r in np.random.default_rng(1).integers(0, n, 32):
        want = (vals[indptr[r]:indptr[r + 1]] *
                xh[idx[indptr[r]:indptr[r + 1]]]).sum()
        assert np.isclose(yh[r], want, rtol=1e-4), r

    print(json.dumps({
        "metric": "spmv_nnz_per_s",
        "value": rate,
        "unit": "nnz/s",
        "vs_baseline": rate / 1e8,  # nominal 100 M nnz/s CPU-core rate
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "gather_nnz_per_s": A.nvals / dt_gather,
        "sorted_nnz_per_s": A.nvals / dt_sorted,
        "gflops": 2 * A.nvals / dt / 1e9,
        "spmm_k": kcols,
        "spmm_nnz_cols_per_s": A.nvals * kcols / dt_spmm,
        "spmm_gflops": 2 * A.nvals * kcols / dt_spmm / 1e9,
        "spmm_gather_gbps": plan.nslots * kcols * 4 / dt_spmm / 1e9,
        "api_spmv_nnz_per_s": A.nvals / api_call,
    }))


if __name__ == "__main__":
    main()
