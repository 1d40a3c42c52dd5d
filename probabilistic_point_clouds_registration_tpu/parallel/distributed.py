"""Distributed registration step: the full outer iteration under shard_map.

One SPMD program per outer iteration over a 2D ("points", "targets") mesh:

  * source rows sharded over ``"points"`` (data-parallel; replaces the
    reference's OpenMP-threaded Ceres residual evaluation,
    src/prob_point_cloud_registration.cc:98);
  * target rows sharded over ``"targets"`` (tensor-parallel search; replaces
    the single-threaded FLANN kd-tree loop, cc:66-81) with an
    all-gather top-k merge that carries neighbor coordinates so no device
    holds the full target cloud;
  * the EM-LM inner solve (models/em_lm.py) reduces its 7x7 normal equations
    and scalar costs with ``psum`` over the points axis; its (q, t) iterate is
    replicated, so every device leaves the ``lax.while_loop`` in lockstep.

Either axis may have size 1 — a 1D points mesh is plain DP with a replicated
target; a 1D targets mesh is pure search-TP. Across hosts the same program
runs under ``jax.distributed`` with the mesh spanning them.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.se3 import quat_rotate_points
from ..core.types import round_up
from ..models.em_lm import LMConfig, LMResult, em_lm_solve
from .mesh import POINTS_AXIS, TARGETS_AXIS, supports_structural_replication
from .search import local_topk_merge


class ShardedStepResult(NamedTuple):
    result: LMResult
    num_correspondences: jnp.ndarray


def pad_for_mesh(points: np.ndarray, n_shards: int, multiple: int = 256):
    """Pad an (n, 3) cloud so its row count divides evenly over ``n_shards``.

    Padding rows are zeros (masked out downstream via the returned count).
    Returns (padded (n_pad, 3), n_valid).
    """
    points = np.asarray(points)
    n = points.shape[0]
    n_pad = round_up(max(n, 1), multiple * n_shards)
    if n_pad == n:
        return points, n
    padded = np.zeros((n_pad, points.shape[1]), dtype=points.dtype)
    padded[:n] = points
    return padded, n


def make_sharded_registration_step(
    mesh: jax.sharding.Mesh,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_tile: int = 4096,
    target_tile: int = 2048,
):
    """Build the jitted distributed outer-iteration step over ``mesh``.

    The returned callable mirrors models/registration.py's
    ``_registration_step``: (filtered_source, target, source_valid_count,
    target_valid_count, q_cum, t_cum, q0, t0) -> ShardedStepResult, with
    source rows divisible by the points-axis size and target rows divisible
    by the targets-axis size. Validity is passed as bool masks aligned with
    the padded arrays.
    """
    P = jax.sharding.PartitionSpec
    cfg = lm_config._replace(axis_name=POINTS_AXIS)
    r2 = radius * radius

    def body(fs, tgt, sv, tv, q_cum, t_cum, q0, t0):
        moved = quat_rotate_points(q_cum, fs) + t_cum
        merged = local_topk_merge(
            moved,
            tgt,
            k=k,
            source_valid=sv,
            target_valid_shard=tv,
            source_tile=source_tile,
            target_tile=target_tile,
            gather_points=True,
        )
        _, sq, found, neighbor_pts = merged
        in_radius = found & (sq <= jnp.asarray(r2, sq.dtype))
        result = em_lm_solve(moved, neighbor_pts, in_radius, q0, t0, cfg)
        n_corr = lax.psum(jnp.sum(in_radius.astype(jnp.int32)), POINTS_AXIS)
        return ShardedStepResult(result=result, num_correspondences=n_corr)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(POINTS_AXIS),  # filtered source rows
            P(TARGETS_AXIS),  # target rows
            P(POINTS_AXIS),  # source validity mask
            P(TARGETS_AXIS),  # target validity mask
            P(),  # cumulative rotation
            P(),  # cumulative translation
            P(),  # inner-solve seed rotation
            P(),  # inner-solve seed translation
        ),
        out_specs=ShardedStepResult(
            result=LMResult(q=P(), t=P(), initial_cost=P(), final_cost=P(),
                            num_iterations=P(), num_successful_steps=P(),
                            trace=P()),
            num_correspondences=P(),
        ),
        # Outputs are replicated (psum-reduced iterates / invariant-gather
        # merged search results); provable when jax has all_gather_invariant.
        check_vma=supports_structural_replication(),
    )
    return jax.jit(sharded)
