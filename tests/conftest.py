"""Test configuration.

Tests run on the CPU with 8 virtual devices (the standard way to exercise
pjit/sharding without several cards) and with x64 enabled so float64
parity tests against the reference's defaults are exact.  The ``gpu``
lane (tests/test_gpu_lane.py) runs on the card through ``chip_smoke.py``,
which loads no conftest.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)
