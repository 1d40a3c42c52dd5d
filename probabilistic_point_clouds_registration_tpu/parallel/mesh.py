"""Device-mesh construction for distributed registration.

The reference's only parallelism is Ceres's OpenMP thread pool
(reference: src/prob_point_cloud_registration.cc:98, CMakeLists.txt:9-14).
This design replaces threads with SPMD over a ``jax.sharding.Mesh``:

  * axis ``"points"`` — source points (and their K candidate neighbors)
    sharded across devices; the 7x7 Gauss-Newton normal equations and scalar
    costs are reduced with ``psum`` across devices (data-parallel axis).
  * axis ``"targets"`` — target-cloud tiles sharded across devices for the
    neighbor search; per-source top-k results from each tile are merged with
    an all-gather + re-top-k (tensor-parallel axis).

Either axis can be used alone (1D mesh) or combined (2D mesh). The mesh
shape follows the algorithm alone: the cards of one host reach each other
all to all, so no device order is better than another.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

POINTS_AXIS = "points"
TARGETS_AXIS = "targets"


def make_mesh(
    n_points_shards: Optional[int] = None,
    n_target_shards: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> jax.sharding.Mesh:
    """Build a ("points", "targets") mesh over the available devices.

    Args:
      n_points_shards: size of the points (data-parallel) axis; defaults to
        all devices divided by ``n_target_shards``.
      n_target_shards: size of the targets (tensor-parallel) axis.
      devices: explicit device list (defaults to ``jax.devices()``).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_points_shards is None:
        if len(devices) % n_target_shards:
            raise ValueError(
                f"{len(devices)} devices not divisible by {n_target_shards} target shards"
            )
        n_points_shards = len(devices) // n_target_shards
    n = n_points_shards * n_target_shards
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, only {len(devices)} available")
    grid = np.asarray(devices[:n]).reshape(n_points_shards, n_target_shards)
    return jax.sharding.Mesh(grid, (POINTS_AXIS, TARGETS_AXIS))


def points_spec() -> jax.sharding.PartitionSpec:
    """PartitionSpec sharding the leading (points) axis."""
    return jax.sharding.PartitionSpec(POINTS_AXIS)


def targets_spec() -> jax.sharding.PartitionSpec:
    """PartitionSpec sharding the leading axis over the targets mesh axis."""
    return jax.sharding.PartitionSpec(TARGETS_AXIS)


def replicated_spec() -> jax.sharding.PartitionSpec:
    return jax.sharding.PartitionSpec()


def all_gather_replicated(x, axis_name):
    """``lax.all_gather`` whose output the vma checker can PROVE replicated.

    jax's plain ``all_gather`` marks its output varying over the gathered
    axis even though every device holds identical values, which forces
    ``check_vma=False`` on any shard_map returning merged results. The
    invariant variant keeps the static replication proof; fall back to the
    plain op (callers then need check_vma=False) on jax versions without it.
    """
    try:
        from jax._src.lax.parallel import all_gather_invariant
    except ImportError:  # pragma: no cover - older jax
        import jax

        return jax.lax.all_gather(x, axis_name)
    return all_gather_invariant(x, axis_name)


def supports_structural_replication() -> bool:
    """True when this jax provides all_gather_invariant (=> check_vma=True)."""
    try:
        from jax._src.lax.parallel import all_gather_invariant  # noqa: F401

        return True
    except ImportError:  # pragma: no cover - older jax
        return False
