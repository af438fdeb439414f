"""Multi-process initialization for sharded rendering.

The reference has no distribution at all (SURVEY.md section 5). Multi-
process here is the standard JAX recipe: ``jax.distributed.initialize``
with an explicit coordinator address, process count and process id,
after which ``jax.devices()`` spans every process's GPUs and the meshes
from parallel/mesh.py lay dp/tp axes over them. The GPUs of one host are
joined all to all by NVLink, so the mesh follows the algorithm alone.

Tests stub this with single-process multi-device meshes
(``xla_force_host_platform_device_count``), per SURVEY.md section 4,
plus one two-process CPU run (tests/test_multihost.py).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed if running multi-process.

    No-ops (returns False) when single-process: no coordinator address
    given and none in JAX_COORDINATOR_ADDRESS. Safe to call multiple
    times.
    """
    global _initialized
    if _initialized:
        return True
    env_coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and env_coord is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _initialized = True
    return True


def process_info():
    """(process_index, process_count, local_device_count)."""
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count())
