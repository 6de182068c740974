"""Test configuration: run on CPU with 8 virtual devices so sharding
tests exercise a fake multi-chip mesh (the reference had no multi-node
test story at all; SURVEY.md section 4)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Force CPU: parity/unit tests run in float64 on the CPU, whatever
# accelerator the environment presets.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may already have been imported by the environment (freezing
# jax_platforms from the original env); override through the config
# API as well.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
