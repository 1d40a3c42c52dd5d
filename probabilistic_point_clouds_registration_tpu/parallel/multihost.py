"""Multi-host execution helpers (meshes that span hosts).

The reference is strictly single-process (SURVEY.md §2 checklist). For
multi-host runs the same SPMD programs in this package span hosts:
initialize the JAX distributed runtime, build a global mesh whose "points"
axis crosses hosts (normal-equation psums cross the host network), and
assemble host-local results globally.

All functions degrade gracefully in single-process mode so library code can
call them unconditionally. The multi-PROCESS path is exercised for real in
tests/test_multihost.py: two OS processes with 4 virtual CPU devices each
initialize the distributed runtime, span one global mesh, and reproduce the
single-process sharded registration step bit-for-bit (cross-process psum +
all-gather, Gloo-backed host trajectory gather). On several machines the
same wiring spans physical hosts.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from .mesh import POINTS_AXIS, TARGETS_AXIS


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize ``jax.distributed`` when running under a multi-process
    launcher; no-op (returns False) in single-process runs.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Nothing is autodetected: without an
    address or a process count this is a single-process run.

    Must run before anything initializes the XLA backend — in particular,
    do NOT probe ``jax.process_count()``/``jax.devices()`` first (that
    initializes the backend and makes ``jax.distributed.initialize`` raise;
    the distributed client handle is checked instead).
    """
    try:
        from jax._src import distributed as _dist

        if _dist.global_state.client is not None:
            return True  # already initialized
    except (ImportError, AttributeError):  # pragma: no cover - jax internals
        pass
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if addr is None and nproc is None:
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(nproc) if nproc else None,
        process_id=int(process_id) if process_id is not None else None,
    )
    return True


def make_global_mesh(n_target_shards: int = 1) -> jax.sharding.Mesh:
    """("points", "targets") mesh over every device of every process."""
    devices = np.asarray(jax.devices())
    if devices.shape[0] % n_target_shards:
        raise ValueError(
            f"{devices.shape[0]} global devices not divisible by {n_target_shards}"
        )
    grid = devices.reshape(devices.shape[0] // n_target_shards, n_target_shards)
    return jax.sharding.Mesh(grid, (POINTS_AXIS, TARGETS_AXIS))


def allgather_trajectory(local_poses) -> np.ndarray:
    """Host-synchronized trajectory assembly: gather each process's pose
    block into the full trajectory on every host (multi-host odometry where
    scan pairs are sharded across processes). Single-process: identity."""
    if jax.process_count() == 1:
        return np.asarray(local_poses)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(np.asarray(local_poses))
    ).reshape(-1, 4, 4)
