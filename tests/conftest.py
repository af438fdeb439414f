"""Test harness configuration.

Tests run on CPU with 8 virtual devices (the standard JAX trick for
exercising Mesh/pjit/shard_map/ppermute code paths without hardware —
SURVEY.md section 4 'Distributed tests without a cluster'). Must be set
before JAX initializes, hence the env mutation at import time.
"""

import os
import re

os.environ["JAX_PLATFORMS"] = "cpu"
# Force (not merely default) 8 virtual devices: a preset XLA_FLAGS with a
# smaller count would otherwise win and abort the suite at the device
# assert below.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" in flags:
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+",
                   "--xla_force_host_platform_device_count=8", flags)
else:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["XLA_FLAGS"] = flags

import numpy as np
import pytest

import jax

# jax.config.update is authoritative even if something imported jax
# before this file set the environment.
jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", (
    "tests must run on the CPU backend (got %r)" % jax.default_backend())
assert jax.device_count() >= 8, (
    "tests need 8 virtual CPU devices for the sharding suite")

# Persistent compilation cache: first-compile latency dominates test time
# otherwise (minutes per graph).
from mini_opencl_raytracer.utils.cache import enable_persistent_cache

enable_persistent_cache()


@pytest.fixture(scope="session")
def cornell():
    from mini_opencl_raytracer.models.cornell import cornell_scene
    return cornell_scene()


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(0)
