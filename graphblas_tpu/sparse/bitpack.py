"""Bit-packed boolean patterns: 32 columns per uint32 word.

Vector units chew through int32 lanes and row gathers stream at memory
bandwidth, while per-element sparse scatters do not.  Packing a boolean
row into n/32 uint32 words makes a whole adjacency row ~400 bytes for a
12K-node graph, so *row intersection* (the inner loop of masked SpGEMM /
triangle counting / k-truss) becomes gather + AND + popcount — a few
hundred vector ops per output edge instead of an n-wide dense dot.

This is the data-parallel answer to the reference's Sauna gather/scatter
workspace (``GB_AxB_Gustavson.c``) for boolean/counting semirings.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pack_rows", "pack_pattern", "popcount", "words_for"]


def words_for(n: int) -> int:
    """# of uint32 words per packed row (padded to a multiple of 8 for
    clean (8,128) VPU tiles)."""
    w = (n + 31) // 32
    return ((w + 7) // 8) * 8


def pack_pattern(pattern) -> jnp.ndarray:
    """[m, n] bool -> [m, W] uint32, bit k of word w = column 32*w+k."""
    pattern = np.asarray(pattern)
    m, n = pattern.shape
    W = words_for(n)
    padded = np.zeros((m, W * 32), dtype=bool)
    padded[:, :n] = pattern
    bits = padded.reshape(m, W, 32).astype(np.uint32)
    shifts = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return jnp.asarray((bits * shifts).sum(axis=2, dtype=np.uint32))


def pack_rows(pattern) -> jnp.ndarray:
    return pack_pattern(pattern)


def popcount(x: jnp.ndarray) -> jnp.ndarray:
    """Per-lane population count, int32 result (XLA PopulationCount)."""
    return jnp.bitwise_count(x).astype(jnp.int32)
