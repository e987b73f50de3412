"""Cold-start accounting (VERDICT r4 next #4): is the fresh-process
scale-18 time k programs x per-program cache-load cost?

Counts persistent-compilation-cache traffic (hits/misses + wall per
load) by wrapping the cache get/put entry points, then runs the
scale-18 tricount build+first-call in THIS process and prints the
ledger.  Run twice: first-ever process pays compiles (misses), the
second pays only deserialization+load (hits) — the measured floor.

Usage:  python tools/coldstart_probe.py [scale]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import graphblas_tpu as gb                    # noqa: E402  (enables cache)
import numpy as np                            # noqa: E402

LEDGER = {"hits": 0, "misses": 0, "hit_s": 0.0, "put_s": 0.0,
          "hit_bytes": 0, "per_hit": []}


def _wrap_cache():
    from jax._src import compilation_cache as cc
    real_get = cc.get_executable_and_time

    def get_executable_and_time(cache_key, compile_options, backend,
                                *a, **k):
        t0 = time.perf_counter()
        out = real_get(cache_key, compile_options, backend, *a, **k)
        dt = time.perf_counter() - t0
        if out[0] is not None:
            LEDGER["hits"] += 1
            LEDGER["hit_s"] += dt
            LEDGER["per_hit"].append(round(dt, 3))
        else:
            LEDGER["misses"] += 1
        return out

    cc.get_executable_and_time = get_executable_and_time
    real_put = cc.put_executable_and_time

    def put_executable_and_time(*a, **k):
        t0 = time.perf_counter()
        out = real_put(*a, **k)
        LEDGER["put_s"] += time.perf_counter() - t0
        return out

    cc.put_executable_and_time = put_executable_and_time


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    _wrap_cache()
    from graphblas_tpu import sparse as sp
    from graphblas_tpu.models.rmat import rmat_edges, symmetrize_pattern
    from graphblas_tpu.sparse import tri

    t_all = time.perf_counter()
    n = 1 << scale
    I, J = rmat_edges(scale, 16, seed=7)
    I, J = symmetrize_pattern(I, J, n)
    A = sp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gb.BOOL, sum_duplicates=False)
    t_build = time.perf_counter() - t_all
    t0 = time.perf_counter()
    L, U = tri.tricount_prep_csr(A)
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntri = tri.tricount_esc(L, U)          # plan + first call
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntri2 = tri.tricount_esc(L, U)
    t_warm = time.perf_counter() - t0
    assert ntri == ntri2
    print(json.dumps({
        "metric": "coldstart_ledger", "scale": scale, "ntri": ntri,
        "build_s": round(t_build, 2), "prep_s": round(t_prep, 2),
        "first_call_s": round(t_first, 2), "warm_s": round(t_warm, 3),
        "total_s": round(time.perf_counter() - t_all, 2),
        "cache_hits": LEDGER["hits"],
        "cache_misses": LEDGER["misses"],
        "cache_hit_load_s": round(LEDGER["hit_s"], 2),
        "cache_put_s": round(LEDGER["put_s"], 2),
        "per_hit_s": LEDGER["per_hit"],
        "note": ("first_call_s - cache_hit_load_s = non-load work; "
                 "hits x mean(per_hit) is the program-load floor "
                 "for this workload"),
    }), flush=True)


if __name__ == "__main__":
    main()
