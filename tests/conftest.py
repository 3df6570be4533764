"""Test configuration: run everything on a simulated 8-device CPU mesh so that
sharding / collective paths are exercised without accelerator hardware
(SURVEY.md §4).  Tests that need the GPU carry the ``gpu`` marker and take
the ``gpu`` fixture, which skips them when JAX found no GPU.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("VR_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))  # for `oracles` imports


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with VR_TEST_ON_GPU=1 on the card")
    return jax.devices()[0]
