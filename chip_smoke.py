#!/usr/bin/env python3
"""Smoke run of the library's main path on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-4 on one card
    python chip_smoke.py --cards 4    # the sharded path on four cards

Phases, all in this one process (a second JAX process on the card would
find its memory reserved):

  1. R-MAT scale 22 (Graph500 a=0.57, b=0.19, c=0.19, edge factor 16):
     ``sparse.bfs_csr`` from 4 roots against scipy's BFS, and
     ``sparse.pagerank_csr`` (20 iterations) against a float64 scipy
     power iteration.
  2. R-MAT scale 18: ``tricount_esc`` against a scipy masked product,
     and ``gb.mxm`` masked PLUS_TIMES[FP32] on CSR operands (routed to
     the valdot engine) against scipy.
  3. Wathen banded tricount through ``tricount_auto`` at the largest
     nx = ny the window plan accepts, against ``tricount_esc``; then the
     XLA window count against the Pallas Triton candidate, timed.
  4. The GPU test lane (``tests_gpu/``) through ``pytest.main``.

With ``--cards N`` only the sharded phase runs: ``dist_csr_bfs`` and
``dist_csr_pagerank`` at R-MAT 22 and the ring ``dist_tricount_csr`` at
R-MAT 18 on a 1-D mesh of N cards, each against the one-card result on
card 0.

Any failed check raises, so the script exits non-zero and prints no
result.  The last line of a passing run is one JSON object naming the
device.  Without a GPU the script exits with code 2 before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: PageRank tolerance against the float64 reference: f32 ranks, and
#: segment sums whose atomics add in a varying order (a few ulps of f32
#: per iteration, well inside 1e-4 relative after 20 iterations)
PR_RTOL = 1e-4
#: valued masked product against float64 scipy: f32 products summed in
#: another order (the tolerance of tests/test_valdot.py).  valdot
#: multiplies elementwise and sums, so TF32 never enters.
MXM_RTOL, MXM_ATOL = 2e-5, 2e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    """The card's name and power limit, read by a child process that
    stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def peak_bytes() -> str:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not available" if peak is None else f"{peak / 2**30:.3f} GiB"


def median_time(fn, *args, reps: int = 20) -> float:
    """Median seconds of ``reps`` calls after one warm-up call, each
    ended by ``block_until_ready`` (a host int result is already
    synchronous)."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# graphs and references
# ---------------------------------------------------------------------------

def rmat(scale: int, seed: int):
    """Symmetric R-MAT pattern as (CsrMatrix, I, J, n); (I, J) row-major,
    unique, no self edges."""
    import graphblas_tpu as gb
    from graphblas_tpu.models.rmat import rmat_edges_device
    from graphblas_tpu.sparse import CsrMatrix
    n = 1 << scale
    I, J = rmat_edges_device(scale, 16, seed=seed)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                           type=gb.BOOL, sum_duplicates=False)
    return A, I, J, n


def scipy_csr(rows, cols, n: int, vals=None):
    """scipy CSR from row-major (rows, cols) without a resort."""
    import scipy.sparse as ss
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    data = np.ones(len(rows)) if vals is None else np.asarray(vals,
                                                              np.float64)
    return ss.csr_matrix((data, np.asarray(cols), indptr), shape=(n, n))


def host_coo(X):
    rows, cols = X._options["host_pattern"]
    return np.asarray(rows[:X.nvals]), np.asarray(cols[:X.nvals])


def bfs_levels_ref(G, root: int) -> np.ndarray:
    """Levels as ``bfs_csr`` numbers them (1 = root, 0 = unreached),
    from scipy's BFS tree."""
    from scipy.sparse import csgraph
    order, pred = csgraph.breadth_first_order(
        G, root, directed=True, return_predecessors=True)
    lev = np.zeros(G.shape[0], np.int64)
    lev[root] = 1
    rest = order[1:]
    while True:                       # one pass per BFS depth
        new = lev[pred[rest]] + 1
        if np.array_equal(new, lev[rest]):
            return lev
        lev[rest] = new


def pagerank_ref(G, iters: int) -> np.ndarray:
    """float64 power iteration of the formula ``pagerank_csr`` runs."""
    n = G.shape[0]
    deg = np.diff(G.indptr).astype(np.float64)
    inv = np.divide(1.0, deg, out=np.zeros(n), where=deg > 0)
    GT = G.T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = 0.85 * (GT @ (r * inv)) + (0.15 / n) * r.sum()
    return r / r.sum()


def masked_product_ref(Ls, Us, Ms, rows_per_chunk: int = 1 << 14):
    """Row-chunked (Ls @ Us) .* pattern(Ms) as row-major (rows, cols,
    vals) float64, bounding scipy's product memory."""
    out_r, out_c, out_v = [], [], []
    n = Ls.shape[0]
    for a in range(0, n, rows_per_chunk):
        b = min(a + rows_per_chunk, n)
        P = (Ls[a:b] @ Us).multiply(Ms[a:b] != 0).tocsr()
        P.sort_indices()
        out_r.append(a + np.repeat(np.arange(b - a), np.diff(P.indptr)))
        out_c.append(P.indices)
        out_v.append(P.data)
    return (np.concatenate(out_r), np.concatenate(out_c),
            np.concatenate(out_v))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_bfs_pagerank(scale: int, seed: int = 7, roots: int = 4,
                       iters: int = 20) -> dict:
    from graphblas_tpu.sparse import bfs_csr, pagerank_csr
    t0 = time.perf_counter()
    A, I, J, n = rmat(scale, seed)
    build_s = time.perf_counter() - t0
    log(f"[1] R-MAT {scale}: n={n} nnz={len(I)} build {build_s:.2f} s (device generation + CSR)")
    G = scipy_csr(I, J, n)
    deg = np.diff(G.indptr)
    rng = np.random.default_rng(seed)
    srcs = rng.choice(np.nonzero(deg)[0], size=roots, replace=False)
    times = []
    for s in srcs:
        t0 = time.perf_counter()
        lev = bfs_csr(A, int(s))
        times.append(time.perf_counter() - t0)
        want = bfs_levels_ref(G, int(s))
        assert np.array_equal(lev, want), f"BFS levels differ from root {s}"
    log(f"[1] bfs_csr {roots} roots: levels equal scipy; first call "
        f"{times[0]:.3f} s (compile {times[0] - min(times[1:] or times):.3f}"
        f" s), warm median {statistics.median(times[1:] or times):.4f} s, "
        f"depth {int(lev.max())}")
    t0 = time.perf_counter()
    pr = pagerank_csr(A, iters=iters)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr = pagerank_csr(A, iters=iters)
    warm = time.perf_counter() - t0
    want = pagerank_ref(G, iters)
    np.testing.assert_allclose(pr, want, rtol=PR_RTOL)
    err = float(np.max(np.abs(pr - want) / want))
    log(f"[1] pagerank_csr {iters} iters: max rel err {err:.2e} "
        f"(rtol {PR_RTOL}); first call {first:.3f} s (compile "
        f"{first - warm:.3f} s), warm {warm:.4f} s")
    log(f"[1] peak device memory {peak_bytes()}")
    return {"n": n, "nnz": len(I), "bfs_warm_s": statistics.median(
        times[1:] or times), "pagerank_warm_s": warm, "build_s": build_s}


def phase_rmat_tri_mxm(scale: int, seed: int = 7) -> dict:
    import graphblas_tpu as gb
    from graphblas_tpu.ops.flopcount import last_axb_method
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.tri import tricount_esc, tricount_prep_csr
    A, I, J, n = rmat(scale, seed)
    L, U = tricount_prep_csr(A)
    t0 = time.perf_counter()
    ntri = tricount_esc(L, U)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert tricount_esc(L, U) == ntri
    warm = time.perf_counter() - t0
    engine = last_axb_method()
    Ls, Us = scipy_csr(*host_coo(L), n), scipy_csr(*host_coo(U), n)
    _, _, cnt = masked_product_ref(Ls, Us, Ls)
    want = int(round(cnt.sum()))
    assert ntri == want, f"tricount {ntri} != scipy {want}"
    log(f"[2] R-MAT {scale} tricount_esc = {ntri} equals scipy; engine "
        f"{engine}; first call {first:.3f} s, warm {warm:.4f} s")

    rng = np.random.default_rng(seed)

    def valued(X):
        rows, cols = host_coo(X)
        vals = (rng.random(len(rows)) + 0.5).astype(np.float32)
        return CsrMatrix.from_coo(rows, cols, vals, n, n, type=gb.FP32,
                                  sum_duplicates=False), vals

    (Lv, lv), (Uv, uv), (Mv, mv) = valued(L), valued(U), valued(L)
    C0 = CsrMatrix.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.float32), n, n, type=gb.FP32)
    sr = gb.semiring.plus_times[gb.FP32]
    t0 = time.perf_counter()
    C = gb.mxm(C0, Mv, None, sr, Lv, Uv)
    first = time.perf_counter() - t0
    method = last_axb_method()
    assert method.startswith("valdot"), f"masked mxm routed to {method}"
    t0 = time.perf_counter()
    C = gb.mxm(C0, Mv, None, sr, Lv, Uv)
    ci, cj, cx = (np.asarray(v) for v in C.extractTuples())
    warm = time.perf_counter() - t0
    wr, wc, wv = masked_product_ref(scipy_csr(*host_coo(L), n, lv),
                                    scipy_csr(*host_coo(U), n, uv),
                                    scipy_csr(*host_coo(L), n, mv))
    assert np.array_equal(ci, wr) and np.array_equal(cj, wc), \
        f"mxm pattern differs: {len(ci)} vs {len(wr)} entries"
    np.testing.assert_allclose(cx, wv, rtol=MXM_RTOL, atol=MXM_ATOL)
    log(f"[2] R-MAT {scale} masked plus_times[FP32] via {method}: nnzC "
        f"{len(ci)}, pattern equal, values within rtol {MXM_RTOL} atol "
        f"{MXM_ATOL} (elementwise products, no TF32); first call "
        f"{first:.3f} s, warm (with result pull) {warm:.4f} s")
    log(f"[2] peak device memory {peak_bytes()}")
    return {"ntri": ntri, "tri_warm_s": warm, "mxm_nnz": len(ci)}


def wathen_lu(nx: int):
    """Strict lower/upper Wathen patterns as CsrMatrix (L, U, n, edges)."""
    import graphblas_tpu as gb
    from graphblas_tpu.models.generate import wathen_coo
    from graphblas_tpu.sparse import CsrMatrix
    I, J, _, n = wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    iu, ju = iu[off], ju[off]
    lo, up = iu > ju, iu < ju
    L = CsrMatrix.from_coo(iu[lo], ju[lo], np.ones(lo.sum(), bool), n, n,
                           type=gb.BOOL, sum_duplicates=False)
    U = CsrMatrix.from_coo(iu[up], ju[up], np.ones(up.sum(), bool), n, n,
                           type=gb.BOOL, sum_duplicates=False)
    return L, U, n, len(iu) // 2


def _count_sum_f16(P, Q, M):
    """The XLA window count with fp16 operands (a measurement variant)."""
    import jax
    import jax.numpy as jnp
    C = jax.lax.dot_general(P.astype(jnp.float16), Q.astype(jnp.float16),
                            (((2,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32)
    return jnp.sum((C.astype(jnp.int32) * M.astype(jnp.int32))
                   .astype(jnp.int64))


def phase_wathen(nx_candidates, reps: int = 20,
                 interpret: bool = False) -> dict:
    """Banded tricount at the first candidate nx the window plan takes;
    then the window-count forms timed at that plan."""
    import re
    import jax
    from graphblas_tpu.ops.flopcount import last_axb_method
    from graphblas_tpu.sparse import window as W
    from graphblas_tpu.sparse.tri import tricount_auto, tricount_esc
    for nx in nx_candidates:
        L, U, n, nedges = wathen_lu(nx)
        plan = W.build_window_plan(L, U, L)
        if plan is not None:
            break
    else:
        raise AssertionError(f"no Wathen size in {list(nx_candidates)} "
                             "is accepted by the window plan")
    log(f"[3] Wathen nx=ny={nx}: n={n} edges={nedges} W={plan.Wmax} "
        f"nJmax={plan.nJmax} panels {plan.panel_bytes / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    ntri = tricount_auto(L, U)
    first = time.perf_counter() - t0
    engine = last_axb_method()
    want = tricount_esc(L, U)
    assert ntri == want, f"tricount_auto {ntri} != tricount_esc {want}"
    log(f"[3] tricount_auto = {ntri} via {engine} equals tricount_esc; "
        f"first call {first:.3f} s")

    # device programs at the same plan, then the public-level calls
    # (record, dispatch, host pull of the count), in turns
    forms = {
        "xla_int8": jax.jit(W._count_sum_jit),
        "xla_f16": jax.jit(_count_sum_f16),
        "triton": jax.jit(lambda P, Q, M: W._count_triton_jit(
            P, Q, M, interpret)),
    }
    calls = {
        "api_xla": lambda: int(W.window_masked_count_sum(plan)),
        "api_triton": lambda: int(W.window_count_sum_triton(
            plan, interpret)),
    }
    args = (plan.P, plan.Q, plan.M)
    hlo = forms["xla_int8"].lower(*args).compile().as_text()
    kinds = sorted(set(re.findall(r'"kind":"(__\w+)"', hlo)))
    log(f"[3] XLA int8 window count: fusion kinds {kinds or 'none'}")
    out = {"nx": nx, "n": n, "ntri": ntri}
    timed = [(k, f, args) for k, f in forms.items()]
    timed += [(k, f, ()) for k, f in calls.items()]
    timed += [(k + "_again", f, ()) for k, f in reversed(calls.items())]
    for name, fn, a in timed:
        got = int(fn(*a))
        assert got == ntri, f"window count {name} = {got} != {ntri}"
        t = median_time(fn, *a, reps=reps)
        out[f"{name}_s"] = t
        log(f"[3] window count {name}: {t * 1e3:.4f} ms (median of {reps})"
            f", {nedges / t / 1e9:.3f} G edges/s")
    log(f"[3] peak device memory {peak_bytes()}")
    return out


def phase_gpu_tests() -> None:
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests_gpu")])
    assert rc == 0, f"tests_gpu failed (pytest exit code {rc})"
    log("[4] tests_gpu passed")


def phase_cards(ncards: int, scale: int, tri_scale: int = 18,
                seed: int = 7, iters: int = 20) -> dict:
    """The sharded path on a 1-D mesh of ``ncards`` devices against the
    one-device result on device 0."""
    from graphblas_tpu.parallel import (dist_csr_bfs, dist_csr_pagerank,
                                        dist_tricount_csr, make_mesh)
    from graphblas_tpu.sparse import bfs_csr, pagerank_csr
    from graphblas_tpu.sparse.tri import csr_tril, tricount_esc
    mesh = make_mesh(ncards)
    A, I, J, n = rmat(scale, seed)
    src = int(I[0])
    t0 = time.perf_counter()
    lev_d = dist_csr_bfs(A, src, mesh)
    t_d = time.perf_counter() - t0
    lev_1 = bfs_csr(A, src)
    assert np.array_equal(lev_d, lev_1), "sharded BFS differs from 1 card"
    log(f"[5] R-MAT {scale} dist_csr_bfs on {ncards} cards equals bfs_csr "
        f"(depth {int(lev_1.max())}); {t_d:.2f} s incl. sharding")
    t0 = time.perf_counter()
    pr_d = dist_csr_pagerank(A, iters=iters, mesh=mesh)
    t_d = time.perf_counter() - t0
    pr_1 = pagerank_csr(A, iters=iters)
    np.testing.assert_allclose(pr_d, pr_1, rtol=PR_RTOL)
    log(f"[5] R-MAT {scale} dist_csr_pagerank on {ncards} cards within "
        f"rtol {PR_RTOL} of pagerank_csr; {t_d:.2f} s incl. sharding")
    del A
    A18, _, _, _ = rmat(tri_scale, seed)
    t0 = time.perf_counter()
    nt_d = dist_tricount_csr(A18, mesh)
    t_d = time.perf_counter() - t0
    nt_1 = tricount_esc(csr_tril(A18))
    assert nt_d == nt_1, f"ring tricount {nt_d} != 1 card {nt_1}"
    log(f"[5] R-MAT {tri_scale} dist_tricount_csr on {ncards} cards = "
        f"{nt_d} equals tricount_esc; {t_d:.2f} s")
    log(f"[5] peak device memory (card 0) {peak_bytes()}")
    return {"ntri": nt_d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the sharded phase on this many cards")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but {len(devs)} devices",
              file=sys.stderr)
        return 2
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    # host-only build of the optional native sort (numpy path otherwise)
    subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                   capture_output=True, check=False)
    t0 = time.perf_counter()
    if args.cards > 1:
        phase_cards(args.cards, 22)
    else:
        phase_bfs_pagerank(22)
        phase_rmat_tri_mxm(18)
        phase_wathen(range(264, 255, -1))
        phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
