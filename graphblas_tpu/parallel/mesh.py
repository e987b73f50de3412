"""Device-mesh construction and sharding helpers.

The reference's only distribution story is MPI rank-slicing with zero
collectives (``Extras/ExactKronGen/kron_mpi.c``) plus a never-built
slice-parallel AxB design (``Source/GB_AxB_parallel.c:52-74``).  The
Replacement here: matrices live block-sharded on a
``jax.sharding.Mesh`` and every distributed op is a ``shard_map`` whose
collectives (psum / all_gather / ppermute) ride the ICI.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "row_sharding", "replicated", "P", "Mesh",
           "NamedSharding"]


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("i",)) -> Mesh:
    """A mesh over the first ``n_devices`` devices (default: all).

    1-D ``("i",)`` meshes row-shard matrices; 2-D ``("i","j")`` meshes
    block-shard them (SUMMA-style mxm).
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = np.asarray(devs[:n_devices])
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        # factor n_devices as evenly as possible for a 2-D mesh
        a = int(np.floor(np.sqrt(n_devices)))
        while n_devices % a:
            a -= 1
        shape = (a, n_devices // a)
    return Mesh(devs.reshape(shape), axis_names)


def row_sharding(mesh: Mesh, ndim: int = 2,
                 axis: str = "i") -> NamedSharding:
    """Shard dim 0 over ``axis``, replicate the rest."""
    spec = [axis] + [None] * (ndim - 1)
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, d: int) -> int:
    """Rows padded so every shard is equal (XLA wants uniform blocks)."""
    return ((n + d - 1) // d) * d
