"""Test configuration: a virtual 8-device CPU mesh by default.

The tests run on the CPU, where all sharding logic is exercised on
virtual devices.  ``JAX_PLATFORMS`` picks another platform: the tests
marked ``gpu`` run on the card with ``JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/`` and skip elsewhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
