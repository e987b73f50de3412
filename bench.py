"""Benchmark: masked-SpGEMM triangle counting (the reference's headline
workload) on one GPU.

Prints the device (platform, device_kind, count, and the card's name
and power limit from nvidia-smi) and then ONE JSON line
{"metric", "value", "unit", "vs_baseline", ...}.  Exits non-zero
without a GPU: a CPU run is never reported as a device number.

Workloads, each through the public entry point with its engine
auto-selected:

* Wathen banded graphs (the reference's tri_demo family) at nx=ny=128
  and at 263, the largest the window plan's panel cap accepts, through
  ``tricount_auto``;
* power-law R-MAT scale 16 and 18 (Graph500 parameters) through
  ``tricount_device`` (bitdot panels + sort-merge residual);
* masked ``plus_times[FP32]`` at R-MAT 18 through ``gb.mxm`` on CSR
  operands (the valdot engine).

Every time is the median of repeated warm calls, each ended by
``block_until_ready`` or by the host integer the call returns.
Baseline (BASELINE.md): the reference counts Wathen triangles at
5.62 M edges/s kernel-only (dot method, 1 thread,
``Demo/Output/tri_demo.out:82``).
"""

import json
import sys
import time

import numpy as np

from chip_smoke import (card_name_and_power, host_coo, median_time, rmat,
                        wathen_lu)

REPS = 10


def wathen_cell(nx: int) -> dict:
    from graphblas_tpu.ops.flopcount import last_axb_method
    from graphblas_tpu.sparse import tri
    L, U, n, nedges = wathen_lu(nx)
    t0 = time.perf_counter()
    ntri = tri.tricount_auto(L, U)
    first = time.perf_counter() - t0
    engine = last_axb_method()
    warm = median_time(lambda: tri.tricount_auto(L, U), reps=REPS)
    assert ntri == tri.tricount_esc(L, U), "tricount engines disagree"
    return {"nx": nx, "n": n, "nedges": nedges, "ntri": ntri,
            "engine": engine, "first_s": first, "warm_s": warm,
            "edges_per_s": nedges / warm}


def rmat_cell(scale: int, valued: bool) -> dict:
    import graphblas_tpu as gb
    from graphblas_tpu.ops.flopcount import last_axb_method
    from graphblas_tpu.sparse import CsrMatrix, tri
    A, I, J, n = rmat(scale, seed=7)
    L, U = tri.tricount_prep_csr(A)
    t0 = time.perf_counter()
    ntri = int(tri.tricount_device(L, U))
    first = time.perf_counter() - t0
    warm = median_time(lambda: tri.tricount_device(L, U), reps=REPS)
    out = {f"rmat{scale}_nnz": len(I), f"rmat{scale}_ntri": ntri,
           f"rmat{scale}_engine": last_axb_method(),
           f"rmat{scale}_first_s": first, f"rmat{scale}_warm_s": warm,
           f"rmat{scale}_nnz_per_s": len(I) / warm}
    if not valued:
        return out
    rng = np.random.default_rng(3)

    def withvals(X):
        rows, cols = host_coo(X)
        return CsrMatrix.from_coo(
            rows, cols, rng.random(len(rows)).astype(np.float32) + 0.5,
            n, n, type=gb.FP32, sum_duplicates=False)

    Lv, Uv, Mv = withvals(L), withvals(U), withvals(L)
    C0 = CsrMatrix.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.float32), n, n, type=gb.FP32)
    sr = gb.semiring.plus_times[gb.FP32]

    def call():
        return gb.mxm(C0, Mv, None, sr, Lv, Uv).values

    t0 = time.perf_counter()
    C = gb.mxm(C0, Mv, None, sr, Lv, Uv)
    first = time.perf_counter() - t0
    out.update({f"valued{scale}_engine": last_axb_method(),
                f"valued{scale}_nnzC": C.nvals,
                f"valued{scale}_first_s": first,
                f"valued{scale}_warm_s": median_time(call, reps=3)})
    return out


def main() -> int:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "card": card_name_and_power()}
    print(f"device: {device}", flush=True)

    small = wathen_cell(128)
    large = wathen_cell(263)
    rec = {
        "metric": "masked_spgemm_tricount_edges_per_s",
        "value": small["edges_per_s"],
        "unit": "edges/s",
        # edges/s, Demo/Output/tri_demo.out:82 (dot method, 1 thread)
        "vs_baseline": small["edges_per_s"] / 5.62e6,
        "device": device,
        **{f"wathen128_{k}": v for k, v in small.items()},
        **{f"wathen263_{k}": v for k, v in large.items()},
        **rmat_cell(16, valued=False),
        **rmat_cell(18, valued=True),
    }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
