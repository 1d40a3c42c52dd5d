"""Target-sharded neighbor search: tensor-parallel data association.

When the target cloud is too large for one device (or to cut search latency),
shard its rows over the ``"targets"`` mesh axis: each device streams its tile
of the target against the (replicated or points-sharded) source, producing a
local per-source top-k; the global top-k is recovered by an ``all_gather`` of
the D local candidate sets followed by one (N, D*k) re-top-k. This is the
tensor-parallel analogue for registration — the collective moves only O(N * D * k) floats, never the O(N * M) distance matrix.

Replaces the reference's single-threaded FLANN kd-tree radius search
(reference: src/prob_point_cloud_registration.cc:66-81) at target sizes a
kd-tree cannot reach per-iteration.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..core.types import Correspondences
from ..ops.neighbors import topk_neighbors
from .mesh import TARGETS_AXIS, all_gather_replicated, supports_structural_replication

_BIG = jnp.inf


def local_topk_merge(
    source,
    target_shard,
    *,
    k: int,
    source_valid,
    target_valid_shard,
    axis_name: str = TARGETS_AXIS,
    source_tile: int = 4096,
    target_tile: int = 2048,
    gather_points: bool = False,
):
    """SPMD body: local top-k over this device's target tile, then global merge.

    Must run inside ``shard_map`` with ``target_shard`` sharded over
    ``axis_name``. Returns globally-indexed (indices, sq_dists, found[, pts]),
    each (N, k[, 3]), identical (replicated) on every device along
    ``axis_name``.

    With ``gather_points=True`` the selected neighbor *coordinates* are also
    returned: each device gathers its local candidates' xyz before the merge,
    so no device ever needs the full target cloud resident — the extra
    all-gather payload is O(N * D * k * 3), still independent of M.
    """
    m_local = target_shard.shape[0]
    idx, sq, found = topk_neighbors(
        source,
        target_shard,
        k=k,
        source_valid=source_valid,
        target_valid=target_valid_shard,
        source_tile=source_tile,
        target_tile=min(target_tile, m_local),
    )
    shard = lax.axis_index(axis_name)
    gidx = idx + shard * m_local  # globalize tile-local indices

    # All-gather the D candidate sets and re-select the global k best.
    all_d = all_gather_replicated(jnp.where(found, sq, _BIG), axis_name)  # (D, N, k)
    all_i = all_gather_replicated(gidx, axis_name)  # (D, N, k)
    d = all_d.shape[0]
    n = source.shape[0]
    cand_d = jnp.moveaxis(all_d, 0, 1).reshape(n, d * k)
    cand_i = jnp.moveaxis(all_i, 0, 1).reshape(n, d * k)
    neg_best, args = lax.top_k(-cand_d, k)
    best_d = -neg_best
    best_i = jnp.take_along_axis(cand_i, args, axis=1)
    merged_found = jnp.isfinite(best_d)
    best_i = jnp.where(merged_found, best_i, 0)
    if not gather_points:
        return best_i, best_d, merged_found
    local_pts = target_shard[idx]  # (N, k, 3) candidate coordinates
    all_p = all_gather_replicated(local_pts, axis_name)  # (D, N, k, 3)
    cand_p = jnp.moveaxis(all_p, 0, 1).reshape(n, d * k, 3)
    best_p = jnp.take_along_axis(cand_p, args[..., None], axis=1)
    return best_i, best_d, merged_found, best_p


def make_target_sharded_search(
    mesh: jax.sharding.Mesh,
    *,
    k: int,
    radius: float,
    source_tile: int = 4096,
    target_tile: int = 2048,
):
    """Build a jitted target-sharded radius search over ``mesh``.

    The returned callable has the same contract as
    :func:`..ops.neighbors.radius_search` but expects the target row count to
    be divisible by the ``"targets"`` axis size; results are replicated.
    """
    P = jax.sharding.PartitionSpec

    def body(source, target, source_valid, target_valid):
        idx, sq, found = local_topk_merge(
            source,
            target,
            k=k,
            source_valid=source_valid,
            target_valid_shard=target_valid,
            source_tile=source_tile,
            target_tile=target_tile,
        )
        in_radius = found & (sq <= jnp.asarray(radius, sq.dtype) ** 2)
        return Correspondences(
            indices=idx, sq_dists=jnp.where(in_radius, sq, 0.0), mask=in_radius
        )

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(TARGETS_AXIS), P(), P(TARGETS_AXIS)),
        out_specs=Correspondences(indices=P(), sq_dists=P(), mask=P()),
        # Structural replication: the invariant all_gather variant lets the
        # vma checker PROVE the merged outputs replicated (older jax without
        # it falls back to runtime parity tests, tests/test_parallel.py).
        check_vma=supports_structural_replication(),
    )
    return jax.jit(sharded)
