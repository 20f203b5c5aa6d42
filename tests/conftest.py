"""Test configuration: CPU backend with 8 virtual devices by default.

Multi-device sharding logic is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), mirroring how the driver dry-runs
the multi-device path. ``JAX_PLATFORMS``, when set, picks the backend
instead (``JAX_PLATFORMS=cuda,cpu`` runs the ``gpu``-marked tests on a
card; the CPU backend stays registered for the tests' host references).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The default GPU device; skips the test when the backend is not a
    GPU. Decided here, at run time, never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default backend is {dev.platform}")
    return dev
