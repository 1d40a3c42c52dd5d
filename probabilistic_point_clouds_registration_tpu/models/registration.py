"""Probabilistic point-cloud registration: the outer EM-ICP loop.

Device-native equivalent of the reference's main class
(prob_point_cloud_registration.h:18-64, src/prob_point_cloud_registration.cc:15-158):

  while not converged:
    re-associate (radius-capped KNN against the target)      cc:66-83
    inner EM solve for an incremental SE(3)                  cc:85-100
    left-compose onto the cumulative transform               cc:101-107
    move the source clouds                                   cc:110-112
    track cost drop + CSV report row                         cc:119-129

Division of labor: per-iteration compute (move cloud -> search -> gather ->
EM-LM solve) is ONE jitted device program with static padded shapes, compiled
once per cloud-size bucket; the host only composes 4x4 float64 transforms,
evaluates convergence on two scalars, and appends report rows. No kd-tree is
ever (re)built — the search op is stateless, which deletes the reference's
per-iteration tree-build cost (cc:66-67) outright.

Fidelity notes:
  * The inner solve is seeded with params.initial_rotation/translation every
    outer iteration, exactly like the reference (iteration.hpp:31-34) — with
    the default identity this is the natural "solve from where the cloud is".
  * The target is voxel-filtered before use when target_filter_size > 0
    (cc:34-41). The reference mutates the caller's cloud in place; here the
    caller's array is left alone (deliberate fix of an API landmine — the
    filtered target is an internal copy).
  * Convergence reproduces cc:138-158 including the quirk that the check runs
    before the first iteration with cost_drop == 0, so the stall counter
    effectively starts at 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import backend
from ..core.params import RegistrationParams
from ..core.se3 import (
    matrix_euler_xyz,
    np_matrix_to_quat,
    np_se3_matrix,
    quat_multiply,
    quat_normalize,
    unit_quat_rotate,
)
from ..core.types import bucket_rows, pad_cloud, round_up, valid_mask
from ..ops.neighbors import radius_search
from ..ops.voxel import voxel_downsample
from ..utils.eval import calculate_mse
from ..utils.ostream import OutputStream
from .em_lm import LMConfig, em_lm_solve

REPORT_HEADER = (
    "iter, n_success_steps, initial_cost, final_cost, tx, ty, tz, "
    "roll, pitch, yaw, mse_prev_iter, mse_gtruth"
)


@partial(jax.jit, static_argnames=("k", "radius", "lm_config", "target_tile"))
def _registration_step(
    filtered_source,
    target,
    source_valid,
    target_valid,
    q_cum,
    t_cum,
    q0,
    t0,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    target_tile: int,
):
    """One fused outer iteration: move -> associate -> inner EM solve.

    Brute-force association engine (streaming tiled top-k over all targets).
    """
    from ..core.se3 import quat_rotate_points

    moved = quat_rotate_points(q_cum, filtered_source) + t_cum
    corr = radius_search(
        moved,
        target,
        k=k,
        radius=radius,
        source_valid=source_valid,
        target_valid=target_valid,
        target_tile=target_tile,
    )
    gathered = target[corr.indices]
    result = em_lm_solve(moved, gathered, corr.mask, q0, t0, lm_config)
    n_corr = jnp.sum(corr.mask)
    return result, n_corr


@partial(
    jax.jit,
    static_argnames=("k", "radius", "lm_config", "capacity", "select_impl"),
)
def _registration_step_grid(
    filtered_source,
    target,
    source_valid,
    bucket_pts,
    bucket_idx,
    cell_ids,
    origin,
    dims,
    lut,
    overflow_pts,
    overflow_idx,
    q_cum,
    t_cum,
    q0,
    t0,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    capacity: int,
    select_impl: str = "auto",
):
    """One fused outer iteration against the prebuilt target hash grid.

    The grid is built once per registration (the target never moves — unlike
    the reference, which rebuilds its kd-tree every outer iteration,
    cc:66-67); per-iteration search cost is O(N * local density) not O(N*M).
    ``overflow_pts``/``overflow_idx`` (possibly zero-size) carry hot-cell
    overflow, merged by a streaming brute pass (ops.grid.merge_overflow).
    """
    from ..core.se3 import quat_rotate_points
    from ..ops.grid import grid_radius_search, merge_overflow, pick_source_tile

    moved = quat_rotate_points(q_cum, filtered_source) + t_cum
    corr = grid_radius_search(
        moved,
        bucket_pts,
        bucket_idx,
        cell_ids,
        origin,
        dims,
        lut,
        k=k,
        radius=radius,
        capacity=capacity,
        source_valid=source_valid,
        source_tile=pick_source_tile(capacity),
        select_impl=select_impl,
    )
    if overflow_pts.shape[0]:
        corr = merge_overflow(
            corr, moved, overflow_pts, overflow_idx,
            k=k, radius=radius, source_valid=source_valid,
        )
    gathered = target[corr.indices]
    result = em_lm_solve(moved, gathered, corr.mask, q0, t0, lm_config)
    n_corr = jnp.sum(corr.mask)
    return result, n_corr


def _scan_convergence(compute, q_cum, t_cum, drop0, unuseful0, it0, *,
                      chunk, n_iter, cost_drop_thresh, n_cost_drop_it):
    """Up to ``chunk`` outer iterations with the reference stopping rule
    carried ON DEVICE (cc:138-158, including the counter-starts-at-1 quirk:
    the check runs before each iteration on the PREVIOUS drop).

    Once the rule fires, the remaining scan slots skip the search + solve
    entirely (``lax.cond``) instead of computing results the host would
    discard — at the default operating point (cost_drop 1%/5 iters) a pair
    converging early inside a long chunk previously burned the rest of the
    chunk in dead FLOPs.

    ``compute(qc, tc)`` returns a tuple whose first four entries are
    (q_raw, t_raw, initial_cost, final_cost); any further entries (counts,
    overflow flags, LM traces) ride along. Returns the per-slot output
    tuple with an ``executed`` bool array appended; non-executed slots hold
    identity-rotation zeros the host must skip.
    """
    dtype = q_cum.dtype
    # Strictly-conservative threshold: the host rule divides f32 costs in
    # python f64; the device divides in f32. A boundary drop must NEVER
    # make the device stop where the host would continue (the host is the
    # source of truth and non-executed slots have no results), so the
    # device compares against thresh shifted DOWN by more than the f32
    # representation/rounding slack — at worst it executes slots the host
    # then discards (the pre-round-3 behavior for those slots).
    thresh = jnp.float32(
        cost_drop_thresh - max(abs(cost_drop_thresh), 1.0) * 1e-5
    )

    def frozen(qc, tc):
        shapes = jax.eval_shape(compute, qc, tc)
        outs = [jnp.zeros(s.shape, s.dtype) for s in shapes]
        outs[0] = jnp.array([1.0, 0.0, 0.0, 0.0], shapes[0].dtype)
        return tuple(outs)

    def body(s, _):
        qc, tc, drop, unuseful, it, done = s
        low = drop < thresh
        stop = done | (it >= n_iter) | (low & (unuseful > n_cost_drop_it))
        unuseful_new = jnp.where(
            stop, unuseful, jnp.where(low, unuseful + 1, jnp.int32(0))
        )
        outs = jax.lax.cond(stop, frozen, compute, qc, tc)
        q_raw, t_raw, ic, fc = outs[0], outs[1], outs[2], outs[3]
        qn = quat_normalize(q_raw)
        q_new = jnp.where(stop, qc, quat_multiply(qn, qc))
        t_new = jnp.where(stop, tc, unit_quat_rotate(qn, tc) + t_raw)
        ic32 = ic.astype(jnp.float32)
        fc32 = fc.astype(jnp.float32)
        drop_new = jnp.where(
            stop,
            drop,
            jnp.where(ic32 != 0, (ic32 - fc32) / jnp.where(ic32 != 0, ic32, 1.0), 0.0),
        )
        it_new = jnp.where(stop, it, it + 1)
        return (
            (q_new, t_new, drop_new, unuseful_new, it_new, stop),
            (*outs, jnp.logical_not(stop)),
        )

    init = (
        q_cum,
        t_cum,
        jnp.asarray(drop0, jnp.float32),
        jnp.asarray(unuseful0, jnp.int32),
        jnp.asarray(it0, jnp.int32),
        jnp.asarray(False),
    )
    _, outs = jax.lax.scan(body, init, None, length=chunk)
    return outs


_CONV_STATICS = ("chunk", "n_iter", "cost_drop_thresh", "n_cost_drop_it")


@partial(
    jax.jit,
    static_argnames=("k", "radius", "lm_config", "capacity", "select_impl")
    + _CONV_STATICS,
)
def _registration_scan_grid(
    filtered_source,
    target,
    source_valid,
    bucket_pts,
    bucket_idx,
    cell_ids,
    origin,
    dims,
    lut,
    overflow_pts,
    overflow_idx,
    q_cum,
    t_cum,
    q0,
    t0,
    drop0,
    unuseful0,
    it0,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    capacity: int,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
    select_impl: str = "auto",
):
    """Up to ``chunk`` fused outer iterations in ONE device program.

    The cumulative transform AND the reference stopping rule are carried on
    device between iterations (``_scan_convergence``), so the host syncs
    once per chunk instead of once per outer iteration (the reference's
    convergence profile is tens of outer iterations,
    src/prob_point_cloud_registration.cc:63-136) — and converged pairs stop
    computing instead of burning the rest of the chunk. Per-iteration deltas (+ the executed flags + optional LM traces)
    stream out so the host rebuilds the exact per-iteration history/CSV.
    """
    from ..core.se3 import quat_rotate_points
    from ..ops.grid import grid_radius_search, merge_overflow, pick_source_tile

    def compute(qc, tc):
        moved = quat_rotate_points(qc, filtered_source) + tc
        corr = grid_radius_search(
            moved,
            bucket_pts,
            bucket_idx,
            cell_ids,
            origin,
            dims,
            lut,
            k=k,
            radius=radius,
            capacity=capacity,
            source_valid=source_valid,
            source_tile=pick_source_tile(capacity),
            select_impl=select_impl,
        )
        if overflow_pts.shape[0]:
            corr = merge_overflow(
                corr, moved, overflow_pts, overflow_idx,
                k=k, radius=radius, source_valid=source_valid,
            )
        gathered = target[corr.indices]
        res = em_lm_solve(moved, gathered, corr.mask, q0, t0, lm_config)
        return (
            res.q,
            res.t,
            res.initial_cost,
            res.final_cost,
            res.num_iterations,
            res.num_successful_steps,
            jnp.sum(corr.mask),
            res.trace,
        )

    return _scan_convergence(
        compute, q_cum, t_cum, drop0, unuseful0, it0, chunk=chunk,
        n_iter=n_iter, cost_drop_thresh=cost_drop_thresh,
        n_cost_drop_it=n_cost_drop_it,
    )


@partial(
    jax.jit,
    static_argnames=("k", "radius", "lm_config", "target_tile") + _CONV_STATICS,
)
def _registration_scan_brute(
    filtered_source,
    target,
    source_valid,
    target_valid,
    q_cum,
    t_cum,
    q0,
    t0,
    drop0,
    unuseful0,
    it0,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    target_tile: int,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
):
    """Up to ``chunk`` fused outer iterations with the brute-force streaming
    engine (one host sync per chunk — same contract as
    _registration_scan_grid, incl. the on-device stopping rule)."""
    from ..core.se3 import quat_rotate_points

    def compute(qc, tc):
        moved = quat_rotate_points(qc, filtered_source) + tc
        corr = radius_search(
            moved,
            target,
            k=k,
            radius=radius,
            source_valid=source_valid,
            target_valid=target_valid,
            target_tile=target_tile,
        )
        gathered = target[corr.indices]
        res = em_lm_solve(moved, gathered, corr.mask, q0, t0, lm_config)
        return (
            res.q,
            res.t,
            res.initial_cost,
            res.final_cost,
            res.num_iterations,
            res.num_successful_steps,
            jnp.sum(corr.mask),
            res.trace,
        )

    return _scan_convergence(
        compute, q_cum, t_cum, drop0, unuseful0, it0, chunk=chunk,
        n_iter=n_iter, cost_drop_thresh=cost_drop_thresh,
        n_cost_drop_it=n_cost_drop_it,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "lm_config",
    ) + _CONV_STATICS,
)
def _registration_scan_fused(
    filtered_source,
    target,
    source_valid,
    cand_xyz,
    cand_idx,
    width_lut,
    lut_d,
    origin_d,
    dims_d,
    overflow_pts,
    overflow_idx,
    q_cum,
    t_cum,
    q0,
    t0,
    drop0,
    unuseful0,
    it0,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
):
    """Up to ``chunk`` outer iterations with the fused grouped engine
    (ops/fused_grid.py), plus the hot-cell overflow merge. Emits a
    per-iteration group-overflow count; the host falls back to the XLA grid
    engine for the pair when any is nonzero. Stopping rule on device
    (_scan_convergence)."""
    from ..core.se3 import quat_rotate_points
    from ..ops.fused_grid import fused_grid_search
    from ..ops.grid import merge_overflow

    def compute(qc, tc):
        moved = quat_rotate_points(qc, filtered_source) + tc
        corr, overflow, gathered = fused_grid_search(
            moved,
            source_valid,
            cand_xyz,
            cand_idx,
            width_lut,
            lut_d,
            origin_d,
            dims_d,
            k=k,
            radius=radius,
            return_points=True,
        )
        if overflow_pts.shape[0]:
            # The merge can reorder/replace selections, so re-gather then
            # (the overflow set exists only under pathological occupancy
            # skew, where the dense engine is normally gated off anyway).
            corr = merge_overflow(
                corr, moved, overflow_pts, overflow_idx,
                k=k, radius=radius, source_valid=source_valid,
            )
            gathered = target[corr.indices]
        res = em_lm_solve(moved, gathered, corr.mask, q0, t0, lm_config)
        return (
            res.q,
            res.t,
            res.initial_cost,
            res.final_cost,
            res.num_iterations,
            res.num_successful_steps,
            jnp.sum(corr.mask),
            overflow,
            res.trace,
        )

    return _scan_convergence(
        compute, q_cum, t_cum, drop0, unuseful0, it0, chunk=chunk,
        n_iter=n_iter, cost_drop_thresh=cost_drop_thresh,
        n_cost_drop_it=n_cost_drop_it,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "lm_config", "class_widths", "class_ends",
        "class_budgets", "budget_rows", "select_max_w",
    ) + _CONV_STATICS,
)
def _registration_scan_pool(
    filtered_source,
    source_valid,
    pool_xyz,
    pool_idx,
    width_lut,
    lut_d,
    origin_d,
    dims_d,
    q_cum,
    t_cum,
    q0,
    t0,
    drop0,
    unuseful0,
    it0,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    class_widths: tuple,
    class_ends: tuple,
    class_budgets: tuple,
    budget_rows: int,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
    select_max_w: int = backend.SELECT_MAX_W,
):
    """Up to ``chunk`` outer iterations with the capacity-free pooled engine
    (ops/fused_pool.py). The select emits the chosen neighbors' coordinates
    itself, so there is no ``target[indices]`` gather (12 B-granularity
    random device-memory traffic at 131k x 20 slots), and no hot-cell
    overflow merge (pool windows carry every cell member). Emits a per-iteration overflow count; the host
    falls back to the XLA grid engine for the pair when any is nonzero.
    Stopping rule on device (_scan_convergence)."""
    from ..core.se3 import quat_rotate_points
    from ..ops.fused_pool import fused_pool_search

    def compute(qc, tc):
        moved = quat_rotate_points(qc, filtered_source) + tc
        corr, overflow, gathered = fused_pool_search(
            moved,
            source_valid,
            pool_xyz,
            pool_idx,
            width_lut,
            lut_d,
            origin_d,
            dims_d,
            k=k,
            radius=radius,
            class_widths=class_widths,
            class_ends=class_ends,
            class_budgets=class_budgets,
            budget_rows=budget_rows,
            return_points=True,
            select_max_w=select_max_w,
        )
        res = em_lm_solve(moved, gathered, corr.mask, q0, t0, lm_config)
        return (
            res.q,
            res.t,
            res.initial_cost,
            res.final_cost,
            res.num_iterations,
            res.num_successful_steps,
            jnp.sum(corr.mask),
            overflow,
            res.trace,
        )

    return _scan_convergence(
        compute, q_cum, t_cum, drop0, unuseful0, it0, chunk=chunk,
        n_iter=n_iter, cost_drop_thresh=cost_drop_thresh,
        n_cost_drop_it=n_cost_drop_it,
    )


@dataclass
class IterationRecord:
    """One outer-iteration report row (the CSV columns at cc:44-46)."""

    iteration: int
    num_successful_steps: int
    initial_cost: float
    final_cost: float
    translation: np.ndarray  # cumulative (3,)
    rpy_deg: np.ndarray  # cumulative roll/pitch/yaw, degrees, Eigen (0,1,2)
    mse_prev_iter: float
    mse_ground_truth: float
    num_correspondences: int

    def csv(self) -> str:
        t = self.translation
        r = self.rpy_deg
        return (
            f"{self.iteration}, {self.num_successful_steps}, {self.initial_cost}, "
            f"{self.final_cost}, {t[0]}, {t[1]}, {t[2]}, {r[0]}, {r[1]}, {r[2]}, "
            f"{self.mse_prev_iter}, {self.mse_ground_truth}"
        )


class ProbabilisticRegistration:
    """Outer registration loop (ProbPointCloudRegistration equivalent).

    Args:
      source_cloud: (n, 3) numpy array.
      target_cloud: (m, 3) numpy array (not mutated).
      params: RegistrationParams.
      ground_truth_cloud: optional (n, 3) aligned ground truth for the source;
        enables the MSE-vs-ground-truth column (cc:50-61).
    """

    @staticmethod
    def prepare_target(
        target_cloud: np.ndarray,
        params: RegistrationParams,
        device: bool = False,
    ) -> dict:
        """Host-side target preprocessing: voxel filter + pad + grid build.

        Everything here is pure numpy, so sequence pipelines can run it on a
        background thread for the NEXT pair's target while the current pair
        computes on device (models/odometry.py) — at KITTI scale the grid
        build alone is ~0.5 s of otherwise-serial host time per pair. Pass
        the result to the constructor as ``prepared_target``.

        ``device=True`` additionally stages the pooled engine's DEVICE state
        (upload + the _build_pools dispatch — JAX dispatch is thread-safe
        and asynchronous, so a prep thread overlaps the upload with the
        current pair's compute). The ctor then consumes the prebuilt
        PoolPrepack directly.
        """
        target = np.asarray(target_cloud, dtype=np.float64)
        if params.target_filter_size > 0:
            target = voxel_downsample(target, params.target_filter_size)
        if device:
            # The device-staging path may jit _build_pools before any
            # ProbabilisticRegistration exists; the persistent cache must be
            # configured BEFORE that first compile or it is bypassed.
            from ..utils.compile_cache import (
                enable_persistent_compilation_cache,
            )

            enable_persistent_compilation_cache()
        from ..ops.grid import add_buckets_host, build_grid_host

        tg, n_tgt = pad_cloud(target, params.pad_multiple, pad_value=0.0)
        grid = None
        pool_plan = None
        try_pool = False
        if params.search_impl in ("auto", "grid", "fused", "pool"):
            # The pooled engine reads only the grid's cell-sorted view, so
            # the allocation-heavy bucket half of the grid build (roughly
            # half the KITTI-scale host build) waits until an engine that
            # reads it is chosen.
            grid = build_grid_host(
                tg, params.radius, num_valid=n_tgt,
                max_overflow=params.grid_max_overflow,
                buckets=False,
            )
        if grid is not None:
            try_pool = params.search_impl == "pool" or (
                params.search_impl == "auto" and backend.auto_engine() == "pool"
            )
        # The ctor drops the grid entirely (brute-force engine) on "auto"
        # when the candidate set is too close to M — replicate that density
        # check here so dense scans don't pay a ~0.5 s pool plan (and, with
        # device=True, a device pool build) the ctor would never consume.
        grid_kept = grid is not None and not (
            params.search_impl == "auto"
            and 27 * grid["capacity"] * 8 > n_tgt
        )
        if grid_kept and try_pool:
            from ..ops.fused_pool import plan_pool_host

            # Precompute the pooled host plan here (dilation + class
            # planning + packed sort) so sequence pipelines overlap it with
            # device compute. False = "attempted and DECLINED" (vs None =
            # never attempted): the ctor must not re-run the host plan just
            # to decline again.
            pool_plan = plan_pool_host(grid, tg)
            if pool_plan is None:
                pool_plan = False
        if grid_kept and not (try_pool and pool_plan):
            # No pooled engine for this target: the grid/fused engines read
            # the bucket tensors — build them on this (prep) thread, not
            # the ctor's.
            add_buckets_host(grid, tg)
        prepared = {
            "target_cloud": target,
            "tg": tg,
            "n_tgt": n_tgt,
            "grid": grid,
            "try_pool": try_pool,
            "pool_plan": pool_plan,
        }
        if device and try_pool and pool_plan:
            from ..ops import fused_pool as _fp

            prepared["pool_prepack"] = _fp.build_pool_prepack(
                grid, tg, dtype=np.dtype(params.dtype), plan=pool_plan,
            )
        return prepared

    def _init_host_prelude(
        self, source_cloud: np.ndarray, params: RegistrationParams
    ) -> None:
        """Shared ctor prelude (also used by DistributedRegistration):
        validation, output stream, persistent compile cache, source load +
        voxel filter."""
        params.validate()
        self.params = params
        self.out = OutputStream(params.verbose)
        self.dtype = jnp.dtype(params.dtype)
        # Size/capacity-specialized programs: a durable compile cache makes
        # re-specialization one-time per checkout (utils/compile_cache.py).
        from ..utils.compile_cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

        self.source_cloud = np.array(source_cloud, dtype=np.float64)
        if params.source_filter_size > 0:
            self.out << f"Filtering source point cloud with leaf of size {params.source_filter_size}\n"
            self.filtered_source = voxel_downsample(self.source_cloud, params.source_filter_size)
        else:
            self.filtered_source = self.source_cloud.copy()

    def _init_ground_truth(
        self, ground_truth_cloud: Optional[np.ndarray]
    ) -> None:
        """Shared ground-truth MSE bookkeeping (reference ..._ex.cc:128-139)."""
        self.ground_truth = ground_truth_cloud is not None
        self.mse_ground_truth = 0.0
        if self.ground_truth:
            self.ground_truth_cloud = np.array(ground_truth_cloud, dtype=np.float64)
            self.mse_ground_truth = calculate_mse(self.source_cloud, self.ground_truth_cloud)
            self.out << f"Initial MSE w.r.t. ground truth: {self.mse_ground_truth}\n"

    def _make_lm_config(self, params: RegistrationParams) -> LMConfig:
        return LMConfig(
            dof=params.dof,
            dimension=3,
            function_tolerance=params.function_tolerance,
            max_iterations=params.max_inner_iterations,
            initial_radius=params.initial_trust_region_radius,
            min_lm_diagonal=params.min_lm_diagonal,
            max_lm_diagonal=params.max_lm_diagonal,
            min_relative_decrease=params.min_relative_decrease,
            use_nonmonotonic_steps=params.use_nonmonotonic_steps,
        )

    def _init_bookkeeping(self, params: RegistrationParams) -> None:
        """Outer-loop product state shared by single- and multi-device
        align(): history, CSV records, convergence counters, the pooled
        budget-escalation rung."""
        self.transformation_history: List[np.ndarray] = []
        self.records: List[IterationRecord] = []
        self.iteration_times: List[float] = []  # wall seconds per outer iter
        # Inner solves that ran into max_inner_iterations (the reference runs
        # Ceres unbounded, cc:96 — a hit means results may diverge from it).
        self.inner_cap_hits = 0
        self.current_iteration = 0
        self.cost_drop = 0.0
        self.num_unuseful_iter = 0
        # Pooled-engine row-budget escalation state (x2 per overflow before
        # the grid fallback engages — see _align_loop's overflow handler).
        self._pool_budget_boost = 0
        self.mse_prev_it = 0.0
        self._prev_source = self.source_cloud.copy() if params.summary else None

    def __init__(
        self,
        source_cloud: np.ndarray,
        target_cloud: np.ndarray,
        params: RegistrationParams,
        ground_truth_cloud: Optional[np.ndarray] = None,
        prepared_target: Optional[dict] = None,
    ):
        self._init_host_prelude(source_cloud, params)
        if prepared_target is None:
            if params.target_filter_size > 0:
                self.out << f"Filtering target point cloud with leaf of size {params.target_filter_size}\n"
            prepared_target = self.prepare_target(target_cloud, params)
        self.target_cloud = prepared_target["target_cloud"]
        self._init_ground_truth(ground_truth_cloud)

        # Device-resident padded arrays (static shapes; compiled once),
        # staged in host numpy and shipped in one jax.device_put of the
        # whole bundle (one host-to-device transfer per constructor instead
        # of one per array). The raw padded TARGET is not in the bundle: the
        # pooled path never reads it (pool payloads carry the selected
        # neighbors' coordinates), so it uploads lazily with the engines
        # that do (_target_dev property; the pooled seeds below already
        # ship the cell-sorted target).
        pad = params.pad_multiple
        fs, self._n_src = pad_cloud(self.filtered_source, pad, pad_value=0.0)
        tg, self._n_tgt = prepared_target["tg"], prepared_target["n_tgt"]
        np_dtype = np.dtype(params.dtype)
        bundle = {
            "src": fs.astype(np_dtype),
            "src_valid": np.arange(fs.shape[0]) < self._n_src,
        }
        self._tg_padded = tg
        self._target_dev_arr = None
        self._tgt_valid_arr = None

        # Target hash grid, built once per pair (search_impl
        # "auto"/"grid"/"fused"; possibly prebuilt on a prefetch thread);
        # None keeps the brute-force streaming engine.
        grid = prepared_target["grid"]
        if (
            grid is not None
            and params.search_impl == "auto"
            and 27 * grid["capacity"] * 8 > self._n_tgt
        ):
            # Candidate set too close to M: the streaming brute-force
            # engine's dense distance tiles beat the grid's random gathers
            # at this density.
            grid = None
        self._grid = None
        self._grid_host = grid

        # Engine selection BEFORE the grid upload: when the pooled engine
        # takes the pair, the XLA grid's bucket tensors (164 MB at KITTI
        # scale) are dead weight it never reads; they upload LAZILY only if
        # the runtime budget flag ever forces the mid-pair fallback
        # (_ensure_grid_device).
        self._prepack = None
        self._pool = None
        self._pool_budget_base = 0
        self._pool_class_cum = None
        pool = None
        plan = None
        want_pool = False
        if grid is not None and prepared_target["try_pool"]:
            # The host plan may have been precomputed on the sequence
            # pipeline's target-prep thread.
            from ..ops import fused_pool as _fp

            pool = prepared_target.get("pool_prepack")
            plan = prepared_target.get("pool_plan")
            # plan is False when prepare_target already attempted the host
            # plan and it DECLINED (sparse-engine misfit) — don't re-run the
            # plan on the ctor critical path just to decline again.
            if pool is None and plan is not False:
                if plan is None:
                    plan = _fp.plan_pool_host(grid, prepared_target["tg"])
                want_pool = plan is not None

        # One upload for everything the chosen engine needs: source rows
        # (+ pool seeds when the pooled engine takes the pair).
        if want_pool:
            from ..ops import fused_pool as _fp

            bundle["pool_seeds"] = _fp.pool_seed_host(plan, np_dtype)
        dev = jax.device_put(bundle)
        self._filtered_src_dev = dev["src"]
        self._src_valid = dev["src_valid"]
        if want_pool:
            pool = _fp.build_pool_prepack(
                grid,
                prepared_target["tg"],
                dtype=np_dtype,
                plan=plan,
                dev_seeds=dev["pool_seeds"],
            )

        if grid is not None and params.search_impl in ("auto", "fused", "pool"):
            if pool is not None:
                from ..ops import fused_pool as _fp

                self._pool = pool
                # Size the row budget from the REAL source's grouping
                # demand (~20 ms of numpy at 131k): the plan's
                # target-occupancy proxy undercounts real pairs ~1.5x
                # (moved sources land in dilated shell cells the proxy
                # scores 0), and the resulting runtime overflow cost a
                # discarded chunk + a second compile on every sequence's
                # first pair. The overflow flag stays as the guard for
                # intra-pair drift.
                if plan:
                    from ..core.se3 import np_quat_to_matrix

                    rot = np_quat_to_matrix(
                        np.asarray(params.initial_rotation, np.float64)
                    )
                    moved0 = (
                        self.filtered_source @ rot.T
                        + np.asarray(
                            params.initial_translation, np.float64
                        )
                    )
                    demand, cum_groups = _fp.estimate_pool_demand_rows(
                        plan, moved0, class_row_ends=pool.class_ends
                    )
                    # ~25% buckets: per-pair demand jitters and the
                    # budget is a static of the scan program.
                    self._pool_budget_base = max(
                        pool.budget_rows,
                        bucket_rows(int(1.25 * demand), step_bits=3),
                    )
                    # Measured per-class cumulative groups: each class
                    # pass pays its whole PREFIX budget, and the plan's 2x
                    # target-proxy estimates leave mid-class passes ~40%
                    # dead. The dispatch sizes the budgets from these
                    # counts; the per-class coverage flag still guards
                    # drift.
                    self._pool_class_cum = cum_groups
                else:
                    self._pool_budget_base = pool.budget_rows
                    self._pool_class_cum = None
                self.out << (
                    f"Pooled engine: {pool.n_dilated} dilated cells, "
                    f"classes {pool.class_widths} x {pool.class_ends}\n"
                )
            if self._pool is None and params.search_impl == "fused":
                # The grouped engine's single full-width prepack (only when
                # forced: no regime picks it under "auto"; the runtime
                # overflow flag protects correctness).
                from ..ops import fused_grid as _fg

                pre = _fg.build_prepack(grid, self._ensure_grid_device())
                if pre is not None:
                    self._prepack = pre
                    self.out << (
                        f"Fused engine: {pre.n_dilated} dilated cells, "
                        f"{pre.n_lanes} candidate lanes\n"
                    )
        if self._pool is None and grid is not None:
            self._ensure_grid_device()

        self._lm_config = self._make_lm_config(params)
        self._init_bookkeeping(params)

    @property
    def _target_dev(self):
        """Lazy padded-target upload: the pooled path never reads the raw
        target rows (the pool prepack ships the cell-sorted target and the
        select emits neighbor coordinates), so the ~16 B/pt upload is paid
        only by the engines that consume it (fused/grid/brute)."""
        if self._target_dev_arr is None:
            dev = jax.device_put(
                {
                    "tgt": self._tg_padded.astype(np.dtype(self.params.dtype)),
                    "tgt_valid": np.arange(self._tg_padded.shape[0])
                    < self._n_tgt,
                }
            )
            self._target_dev_arr = dev["tgt"]
            self._tgt_valid_arr = dev["tgt_valid"]
        return self._target_dev_arr

    @property
    def _tgt_valid(self):
        if self._tgt_valid_arr is None:
            self._target_dev  # noqa: B018 — triggers the batched upload
        return self._tgt_valid_arr

    def _ensure_grid_device(self):
        """Materialize the XLA hash grid on device (one batched device_put).

        Pooled-engine pairs defer this: the bucket tensors are ~164 MB at
        KITTI scale and the pooled path never reads them — only the
        mid-pair budget-overflow fallback does, and that is the rare path.
        Idempotent; returns the HashGrid (or None when no grid exists).
        """
        if self._grid is not None or self._grid_host is None:
            return self._grid
        from ..ops.grid import HashGrid, add_buckets_host

        grid = self._grid_host
        # Pooled pairs build the grid WITHOUT its bucket tensors (the pool
        # plan only reads the cell-sorted view); the fallback engines need
        # them — materialize on first use.
        add_buckets_host(grid, self._tg_padded)
        np_dtype = np.dtype(self.params.dtype)
        host = {k: v for k, v in grid.items() if isinstance(v, np.ndarray)}
        host["bucket_pts"] = grid["bucket_pts"].astype(np_dtype)
        host["origin"] = grid["origin"].astype(np_dtype)
        if "overflow_pts" in grid:
            host["overflow_pts"] = grid["overflow_pts"].astype(np_dtype)
        g = jax.device_put(host)
        self._grid = HashGrid(
            bucket_pts=g["bucket_pts"],
            bucket_idx=g["bucket_idx"],
            cell_ids=g["cell_ids"],
            capacity=grid["capacity"],
            origin=g["origin"],
            dims=g["dims"],
            cell_size=grid["cell_size"],
            num_valid=grid["num_valid"],
            lut=g.get("lut"),
            overflow_pts=g.get("overflow_pts"),
            overflow_idx=g.get("overflow_idx"),
        )
        if self._grid.overflow_pts is not None:
            self._ov_pts = self._grid.overflow_pts
            self._ov_idx = self._grid.overflow_idx
        else:
            self._ov_pts = jnp.zeros((0, 3), self.dtype)
            self._ov_idx = jnp.zeros((0,), jnp.int32)
        self.out << (
            f"Target grid: {self._grid.cell_ids.shape[0]} occupied cells, "
            f"capacity {self._grid.capacity}, overflow "
            f"{self._ov_pts.shape[0]}\n"
        )
        return self._grid

    # -- reference API ------------------------------------------------------

    def align(self) -> np.ndarray:
        """Run the outer loop to convergence; returns the final 4x4 transform.

        Observability: per-outer-iteration wall times land in
        ``self.iteration_times`` (device step + host bookkeeping); with
        ``params.profile_dir`` set, the whole loop runs under
        ``jax.profiler.trace`` for TensorBoard timelines.
        """
        if self.params.profile_dir:
            with jax.profiler.trace(self.params.profile_dir):
                return self._align_loop()
        return self._align_loop()

    def _process_iteration(
        self, q_raw, t_raw, initial_cost, final_cost, num_iterations,
        num_successful, n_corr, iter_time,
    ) -> None:
        """Host bookkeeping for one completed outer iteration: compose the
        incremental transform (f64), cost drop, MSE metrics, CSV record."""
        p = self.params
        t_cum = self.transformation()
        # Incremental transform of this iteration (iteration.hpp:59-67:
        # quaternion normalized on extraction). Host numpy math — a jnp call
        # here would cost a device roundtrip per outer iteration.
        q = np.asarray(q_raw, dtype=np.float64)
        q = q / np.linalg.norm(q)
        t = np.asarray(t_raw, dtype=np.float64)
        delta = np_se3_matrix(q, t)
        current = delta @ t_cum  # left-compose (cc:101-107)
        self.transformation_history.append(current)

        initial_cost = float(initial_cost)
        final_cost = float(final_cost)
        self.cost_drop = (initial_cost - final_cost) / initial_cost if initial_cost else 0.0

        # CONSERVATIVE counting: num_iterations == cap cannot distinguish
        # "converged exactly on the last allowed iteration" from "was
        # truncated", so a boundary convergence counts as a hit. Zero hits
        # (the measured state at every production operating point,
        # BASELINE.md) therefore really does mean behavioral equivalence
        # with the reference's unbounded Ceres; a nonzero count is an
        # upper bound on truncations, not an exact tally.
        if int(num_iterations) >= p.max_inner_iterations:
            self.inner_cap_hits += 1
            if self.inner_cap_hits == 1:
                import warnings

                warnings.warn(
                    f"inner LM solve hit max_inner_iterations="
                    f"{p.max_inner_iterations}; the reference runs Ceres "
                    f"unbounded (prob_point_cloud_registration.cc:96) — "
                    f"results may diverge from it. Consider raising the cap.",
                    RuntimeWarning,
                    stacklevel=3,
                )

        if self.ground_truth or p.summary:
            moved_source = self.source_cloud @ current[:3, :3].T + current[:3, 3]
        if self.ground_truth:
            self.mse_ground_truth = calculate_mse(moved_source, self.ground_truth_cloud)
            self.out << f"MSE w.r.t. ground truth: {self.mse_ground_truth}\n"
        if p.summary:
            self.mse_prev_it = calculate_mse(moved_source, self._prev_source)
            self._prev_source = moved_source
        rpy = np.degrees(matrix_euler_xyz(current[:3, :3]))
        self.records.append(
            IterationRecord(
                iteration=self.current_iteration,
                num_successful_steps=int(num_successful),
                initial_cost=initial_cost,
                final_cost=final_cost,
                translation=current[:3, 3].copy(),
                rpy_deg=rpy,
                mse_prev_iter=self.mse_prev_it,
                mse_ground_truth=self.mse_ground_truth,
                num_correspondences=int(n_corr),
            )
        )
        self.iteration_times.append(iter_time)
        self.out << (
            f"[iter {self.current_iteration}] correspondences={int(n_corr)} "
            f"cost {initial_cost:.6g} -> {final_cost:.6g} "
            f"(drop {self.cost_drop:.4f}), lm_iters={int(num_iterations)}, "
            f"{iter_time * 1e3:.1f} ms\n"
        )
        self.current_iteration += 1

    def _print_lm_trace(self, trace_row, n_lm: int) -> None:
        """Per-LM-iteration diagnostics — the analogue of the reference's
        per-outer-iteration ``summary.FullReport()`` print (cc:108)."""
        tr = np.asarray(trace_row)
        for i in range(int(n_lm)):
            verdict = "accepted" if tr[i, 3] else "rejected"
            self.out << (
                f"   lm_iter {i}: cost={tr[i, 0]:.6g} "
                f"step_quality={tr[i, 1]:.4g} "
                f"trust_radius={tr[i, 2]:.4g} {verdict}\n"
            )

    def _consume_chunk(self, outs, chunk: int, iter_start: float) -> bool:
        """Host bookkeeping for a chunk of fused outer iterations.

        The device carries the same stopping rule (``_scan_convergence``),
        so non-executed slots hold no results; the host re-applies the rule
        row by row exactly like the single-step loop (cc:65,138-158) — the
        two must agree, and the ``executed`` flags are the device's half of
        that contract. Returns True when convergence fired mid-chunk.
        """
        import time

        qs, ts, ics, fcs, nits, nsucc, ncorr, traces, executed = outs
        n_exec = max(1, int(np.sum(executed)))
        per_iter = (time.perf_counter() - iter_start) / n_exec
        for j in range(chunk):
            unuseful_before = self.num_unuseful_iter
            if j > 0 and self.has_converged():
                return True
            if not bool(executed[j]):
                if j == 0:
                    # Device stopped at slot 0 where the host's loop-top
                    # check said continue. Unreachable by construction (the
                    # device threshold is strictly conservative) — fail
                    # loudly rather than loop forever re-dispatching.
                    raise RuntimeError(
                        "device/host convergence rules diverged at a chunk "
                        "boundary — report this as a bug"
                    )
                # The device's conservative rule stopped here; the host
                # rule has not fired yet (boundary-value slack). Undo the
                # stall-counter mutation of the check we just ran (the
                # outer loop re-checks the SAME iteration before the next
                # dispatch) and return not-converged — the slack costs one
                # extra dispatch, never a wrong early termination.
                self.num_unuseful_iter = unuseful_before
                return False
            if self.params.trace_inner and traces.shape[1]:
                self._print_lm_trace(traces[j], nits[j])
            self._process_iteration(
                qs[j], ts[j], ics[j], fcs[j], nits[j], nsucc[j], ncorr[j], per_iter
            )
        return False

    def _align_loop(self) -> np.ndarray:
        import time

        p = self.params
        q0 = jnp.asarray(p.initial_rotation, dtype=self.dtype)
        t0 = jnp.asarray(p.initial_translation, dtype=self.dtype)
        chunk = max(1, int(p.outer_chunk))
        lm_config = self._lm_config
        if p.trace_inner:
            # Per-LM-iteration diagnostics: every engine (incl. the
            # scan/pooled paths) streams its (chunk, max_iters, 4) trace
            # buffer out of the device program — diagnostics no longer
            # force the slow single-step path.
            lm_config = lm_config._replace(trace=True)

        converged = False
        while not converged:
            # Snapshot the convergence state BEFORE the host check: the
            # device scan replays the identical check sequence starting
            # from this snapshot (has_converged mutates the stall counter,
            # so snapshotting after it would double-count iteration 0's
            # check inside the chunk).
            conv0 = (
                np.float32(self.cost_drop),
                np.int32(self.num_unuseful_iter),
                np.int32(self.current_iteration),
            )
            if self.has_converged():
                break
            iter_start = time.perf_counter()
            t_cum = self.transformation()
            q_cum = jnp.asarray(np_matrix_to_quat(t_cum[:3, :3]), dtype=self.dtype)
            t_cum_dev = jnp.asarray(t_cum[:3, 3], dtype=self.dtype)
            conv_statics = dict(
                n_iter=int(p.n_iter),
                cost_drop_thresh=float(p.cost_drop_thresh),
                n_cost_drop_it=int(p.n_cost_drop_it),
            )
            if self._prepack is not None:
                pre = self._prepack
                fchunk = max(1, int(p.outer_chunk))
                outs = _registration_scan_fused(
                    self._filtered_src_dev,
                    self._target_dev,
                    self._src_valid,
                    pre.cand_xyz,
                    pre.cand_idx,
                    pre.width_lut,
                    pre.lut_d,
                    pre.origin_d,
                    pre.dims_d,
                    self._ov_pts,
                    self._ov_idx,
                    q_cum,
                    t_cum_dev,
                    q0,
                    t0,
                    *conv0,
                    k=p.max_neighbours,
                    radius=p.radius,
                    lm_config=lm_config,
                    chunk=fchunk,
                    **conv_statics,
                )
                got = jax.device_get(outs)
                ovf = got[7]
                if int(np.sum(ovf)) > 0:
                    # Pathologically scattered sources blew the 2N group
                    # budget: no results were consumed — redo this chunk (and
                    # the rest of the pair) on the XLA grid engine. The
                    # loop-top has_converged() already ran (mutating the
                    # stall counter) for an iteration that now never
                    # happened; restore the snapshot so the redo's check is
                    # a replay, not a double increment.
                    self._prepack = None
                    self.num_unuseful_iter = int(conv0[1])
                    self.out << (
                        "Fused-engine group overflow; falling back to the "
                        "XLA grid engine for this pair\n"
                    )
                    continue
                converged = self._consume_chunk(
                    got[:7] + got[8:], fchunk, iter_start
                )
                continue
            if self._pool is not None:
                pool = self._pool
                fchunk = max(1, int(p.outer_chunk))
                # Boost the EFFECTIVE budget: boosting only the base is a
                # no-op whenever the source-rows floor dominates (the retry
                # would re-dispatch the identical program).
                budget = round_up(
                    max(
                        self._pool_budget_base,
                        self._filtered_src_dev.shape[0] + 4096,
                    )
                    << self._pool_budget_boost,
                    2048,
                )
                class_budgets = pool.class_budgets
                if self._pool_class_cum is not None:
                    # Demand-sized class-prefix budgets from the ctor's
                    # grouping replay (fused_pool.demand_class_budgets —
                    # boost-scaled so the escalation ladder raises CLASS
                    # budgets too; a mid-class coverage overflow is
                    # otherwise unfixable by row doubling alone). The
                    # last class always spans the full row budget inside
                    # fused_pool_search.
                    from ..ops import fused_pool as _fp
                    from ..ops.fused_grid import BLOCK_GROUPS, GROUP

                    ng_b = round_up(
                        budget, 2 * BLOCK_GROUPS * GROUP
                    ) // GROUP
                    class_budgets = _fp.demand_class_budgets(
                        self._pool_class_cum,
                        ng_b,
                        boost=self._pool_budget_boost,
                        cap=ng_b,
                    )
                outs = _registration_scan_pool(
                    self._filtered_src_dev,
                    self._src_valid,
                    pool.pool_xyz,
                    pool.pool_idx,
                    pool.width_lut,
                    pool.lut_d,
                    pool.origin_d,
                    pool.dims_d,
                    q_cum,
                    t_cum_dev,
                    q0,
                    t0,
                    *conv0,
                    k=p.max_neighbours,
                    radius=p.radius,
                    lm_config=lm_config,
                    class_widths=pool.class_widths,
                    class_ends=pool.class_ends,
                    class_budgets=class_budgets,
                    budget_rows=budget,
                    chunk=fchunk,
                    select_max_w=pool.select_max_w,
                    **conv_statics,
                )
                got = jax.device_get(outs)
                ovf = got[7]
                if int(np.sum(ovf)) > 0:
                    # A row or class-prefix budget overflowed: no results
                    # were consumed — redo this chunk. First ESCALATE the
                    # pooled row budget (x2, twice): the pool plan
                    # estimates rows from target occupancy, and a
                    # badly misaligned initial pose can need more until the
                    # clouds converge — one redo at a bucketed bigger
                    # budget is far cheaper than a whole pair on the XLA
                    # grid engine. Only past the escalation cap fall back
                    # to the grid engine (uploaded lazily: pooled pairs
                    # skip the ~164 MB bucket tensors at ctor time).
                    # Either way restore the stall counter the loop-top
                    # has_converged() mutated for the discarded iteration
                    # (see the fused handler above).
                    self.num_unuseful_iter = int(conv0[1])
                    if self._pool_budget_boost < 2:
                        self._pool_budget_boost += 1
                        self.out << (
                            "Pooled-engine budget overflow; retrying with "
                            f"a {1 << self._pool_budget_boost}x row budget\n"
                        )
                        continue
                    self._pool = None
                    self._ensure_grid_device()
                    self.out << (
                        "Pooled-engine budget overflow; falling back to the "
                        "XLA grid engine for this pair\n"
                    )
                    continue
                converged = self._consume_chunk(
                    got[:7] + got[8:], fchunk, iter_start
                )
                continue
            if self._grid is not None and chunk > 1:
                g = self._grid
                outs = _registration_scan_grid(
                    self._filtered_src_dev,
                    self._target_dev,
                    self._src_valid,
                    g.bucket_pts,
                    g.bucket_idx,
                    g.cell_ids,
                    g.origin,
                    g.dims,
                    g.lut,
                    self._ov_pts,
                    self._ov_idx,
                    q_cum,
                    t_cum_dev,
                    q0,
                    t0,
                    *conv0,
                    k=p.max_neighbours,
                    radius=p.radius,
                    lm_config=lm_config,
                    capacity=g.capacity,
                    chunk=chunk,
                    select_impl=p.search_select,
                    **conv_statics,
                )
                converged = self._consume_chunk(
                    jax.device_get(outs), chunk, iter_start
                )
                continue
            if self._grid is None and chunk > 1:
                outs = _registration_scan_brute(
                    self._filtered_src_dev,
                    self._target_dev,
                    self._src_valid,
                    self._tgt_valid,
                    q_cum,
                    t_cum_dev,
                    q0,
                    t0,
                    *conv0,
                    k=p.max_neighbours,
                    radius=p.radius,
                    lm_config=lm_config,
                    target_tile=p.search_target_tile,
                    chunk=chunk,
                    **conv_statics,
                )
                converged = self._consume_chunk(
                    jax.device_get(outs), chunk, iter_start
                )
                continue
            if self._grid is not None:
                g = self._grid
                result, n_corr = _registration_step_grid(
                    self._filtered_src_dev,
                    self._target_dev,
                    self._src_valid,
                    g.bucket_pts,
                    g.bucket_idx,
                    g.cell_ids,
                    g.origin,
                    g.dims,
                    g.lut,
                    self._ov_pts,
                    self._ov_idx,
                    q_cum,
                    t_cum_dev,
                    q0,
                    t0,
                    k=p.max_neighbours,
                    radius=p.radius,
                    lm_config=lm_config,
                    capacity=g.capacity,
                    select_impl=p.search_select,
                )
            else:
                result, n_corr = _registration_step(
                    self._filtered_src_dev,
                    self._target_dev,
                    self._src_valid,
                    self._tgt_valid,
                    q_cum,
                    t_cum_dev,
                    q0,
                    t0,
                    k=p.max_neighbours,
                    radius=p.radius,
                    lm_config=lm_config,
                    target_tile=p.search_target_tile,
                )
            if p.trace_inner:
                self._print_lm_trace(result.trace, result.num_iterations)
            self._process_iteration(
                result.q,
                result.t,
                result.initial_cost,
                result.final_cost,
                result.num_iterations,
                result.num_successful_steps,
                n_corr,
                time.perf_counter() - iter_start,
            )

        if self.ground_truth:
            final = self.transformation()
            aligned = self.source_cloud @ final[:3, :3].T + final[:3, 3]
            self.mse_ground_truth = calculate_mse(aligned, self.ground_truth_cloud)
            print(f"MSE w.r.t. ground truth: {self.mse_ground_truth}")
        return self.transformation()

    def has_converged(self) -> bool:
        """Stopping rule, reproducing cc:138-158 (incl. counter semantics)."""
        p = self.params
        if self.current_iteration == p.n_iter:
            self.out << (
                f"Terminating because maximum number of iterations has been reached "
                f"( {self.current_iteration} iter)\n"
            )
            return True
        if self.cost_drop < p.cost_drop_thresh:
            if self.num_unuseful_iter > p.n_cost_drop_it:
                self.out << (
                    f"Terminating because cost drop has been under "
                    f"{p.cost_drop_thresh * 100} % for more than {p.n_cost_drop_it} iterations\n"
                )
                return True
            self.num_unuseful_iter += 1
        else:
            self.num_unuseful_iter = 0
        return False

    def transformation(self) -> np.ndarray:
        """Cumulative 4x4 transform (identity before the first iteration)."""
        if self.transformation_history:
            return self.transformation_history[-1].copy()
        return np.eye(4)

    def report(self) -> str:
        """Per-iteration CSV report (header cc:44-46, rows cc:120-129)."""
        lines = [REPORT_HEADER]
        lines += [r.csv() for r in self.records]
        return "\n".join(lines) + "\n"


def register_pair(
    source_cloud: np.ndarray,
    target_cloud: np.ndarray,
    params: Optional[RegistrationParams] = None,
    ground_truth_cloud: Optional[np.ndarray] = None,
):
    """Functional one-shot: align source onto target, return (4x4, registration)."""
    params = params or RegistrationParams()
    reg = ProbabilisticRegistration(source_cloud, target_cloud, params, ground_truth_cloud)
    final = reg.align()
    return final, reg
