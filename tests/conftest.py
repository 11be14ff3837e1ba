"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding/halo logic is exercised on host CPU devices (SURVEY.md §4). The
config update below (before any backend is instantiated) pins the CPU even
where a GPU is present; tests that need the card are marked ``gpu`` and run
without this conftest (see tests/test_gpu_kernels.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
