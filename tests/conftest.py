"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The ambient environment pins JAX_PLATFORMS to the TPU platform and ignores
env overrides, so the platform is forced via jax.config before any backend
initialization. XLA_FLAGS must be set before jax import.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
