"""Test configuration: run on a virtual 8-device CPU mesh.

The CPU platform is forced in-process before any backend initializes,
so the suite never claims an accelerator even where one is present.
Card-only tests carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them when JAX's first device is not a GPU (the
decision is made when the test runs, never at import).
"""

import os

# Must come before the first backend use (jax import is fine).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; run chip_smoke.py on the card")
    return dev
