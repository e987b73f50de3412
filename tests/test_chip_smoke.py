"""chip_smoke.py's phases at tiny sizes on the CPU, each against its
plain reference, without the device check in ``main`` (which must
refuse the CPU)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_phase_bfs_pagerank_tiny():
    out = chip_smoke.phase_bfs_pagerank(10, roots=3, iters=5)
    assert out["n"] == 1024 and out["nnz"] > 0


def test_phase_rmat_tri_mxm_tiny(monkeypatch):
    import graphblas_tpu.sparse.bitdot as bd
    # scale 13 keeps m*n above the dense-engine cutoff; the lane gate
    # is lowered so the valdot plan takes a graph this small
    monkeypatch.setattr(bd, "_MIN_LANES", 1)
    out = chip_smoke.phase_rmat_tri_mxm(13)
    assert out["ntri"] > 0 and out["mxm_nnz"] > 0


def test_phase_wathen_tiny():
    out = chip_smoke.phase_wathen([24, 16], reps=2, interpret=True)
    assert out["nx"] == 24 and out["ntri"] > 0
    assert {"xla_int8_s", "xla_f16_s", "triton_s"} <= set(out)


def test_phase_cards_on_virtual_devices():
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    assert chip_smoke.phase_cards(4, 10, tri_scale=9)["ntri"] > 0


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert "needs a GPU" in out.err and out.out == ""
