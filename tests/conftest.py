"""Test configuration: force an 8-device virtual CPU mesh before jax imports.

Multi-device sharding paths are validated on virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8); GPU behaviour and
performance are measured on the card by chip_smoke.py and bench.py. Tests
that can run only on the card carry the ``gpu`` marker and skip here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("TPU_AUDIO_LOG", "warn")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# jax reads JAX_PLATFORMS when it is first imported; set the config too in
# case a plugin imported it before this file ran.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """`gpu`-marked tests need the card; elsewhere they skip with a reason
    (their paths are covered on the card by chip_smoke.py). Decided per
    test, never at collection, so every xdist worker collects the same
    tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (covered on the card by "
                    "chip_smoke.py)")
