"""GPU lane config: unlike tests/, which forces the CPU, these tests run
on the card JAX finds.  Run with ``make test-gpu`` on a GPU machine; on
any other backend every test skips."""

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="session", autouse=True)
def _require_gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's backend is {jax.default_backend()}")
