"""Test config: run on CPU with 8 virtual devices so sharding tests work
without GPUs (the GPU lane is tests_gpu/)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# a plugin registered at interpreter start would otherwise win over the
# env var; the config update holds at any point before first device use
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


# build the native library if the toolchain is available (cheap, ~1s);
# native tests skip gracefully when it isn't.
import pathlib
import subprocess

_native_dir = pathlib.Path(__file__).resolve().parent.parent / "native"
if (_native_dir / "Makefile").exists() and \
        not (_native_dir / "libgbtpu_native.so").exists():
    try:
        subprocess.run(["make", "-C", str(_native_dir)], check=False,
                       capture_output=True, timeout=120)
    except Exception:
        pass


# XLA:CPU never unmaps jitted code: a full-suite run accumulates ~65K
# process mappings (measured ~1.5 per compiled program) and LLVM then
# dies with "Cannot allocate memory" at the kernel's default
# vm.max_map_count=65530.  Raise the limit when we can (root
# containers); harmless no-op otherwise.
def _raise_map_count(target: int = 524288) -> None:
    path = "/proc/sys/vm/max_map_count"
    try:
        with open(path) as f:
            cur = int(f.read())
        if cur < target:
            with open(path, "w") as f:
                f.write(str(target))
    except (OSError, ValueError):
        pass


_raise_map_count()
