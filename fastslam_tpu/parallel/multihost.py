"""Multi-host setup and cross-host utilities.

The reference's only IPC is a JSON file over a Docker bind mount
(``serializer.py:15-17``; SURVEY.md §2.3).  Here multi-host runs use JAX's
native runtime: ``jax.distributed.initialize`` brings up the coordination
service, the global mesh spans every host's devices (collectives ride
NVLink within a host, the network across hosts), and host-side consumers (telemetry,
serialization, eval) pull replicated scalars or process-local shards only.

On a single host everything degrades to no-ops, so the same entry point runs
everywhere.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Bring up the JAX distributed runtime (no-op on a single process).

    Args are taken from the environment (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) when not passed explicitly —
    the standard pod-slice launch pattern.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))

    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def replicated_to_host(x) -> np.ndarray:
    """Fetch a replicated (or fully-addressable) array to host memory."""
    return np.asarray(jax.device_get(x))


def local_shard(x) -> np.ndarray:
    """This process's addressable shard of a globally sharded array —
    what a host-side telemetry/serialization consumer should read instead of
    gathering the world."""
    shards = [s.data for s in x.addressable_shards]
    return np.concatenate([np.asarray(s) for s in shards], axis=0)
