"""Test configuration: emulate an 8-device CPU mesh and enable float64.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), the JAX-native fake backend for
testing sharded FFT + all-to-all without GPUs.  Tests marked ``gpu`` run
their work in child processes with the caller's own JAX_PLATFORMS.
"""

import os

#: the caller's platform choice, for the children of ``gpu`` tests
CALLER_JAX_PLATFORMS = os.environ.get("JAX_PLATFORMS")
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
