"""Target-sharded CAPACITY-FREE POOLED search + the full sharded outer step.

Round-2's sharded step (parallel/grid_sharded.py) runs the XLA hash-grid
engine; the single-device performance record is held by the pooled Pallas
engine (ops/fused_pool.py). This module shards *that* engine so multi-device
execution composes with the flagship single-chip numbers:

  * Target rows are dealt round-robin over the ``"targets"`` mesh axis
    (statistically identical shards — same spatial cells at ~1/T density),
    and each shard gets its OWN width-class pool prepack built from its
    rows. Per-shard window unions shrink ~T-fold, so the select kernel's
    extraction rounds (bounded by the real in-radius count) genuinely
    shrink with the mesh — real work scaling, not replicated work.
  * Every static dimension of the per-shard plans is HARMONIZED through
    ``plan_pool_host(force=...)`` (ops/fused_pool.py): one shared class
    ladder, per-class padded sizes / scatter-table sizes / upload shapes
    taken as maxima over the shards. All shards then share one compiled
    program — the SPMD contract of ``shard_map``.
  * Pool payloads carry GLOBAL target row ids (the packed cell-sorted
    upload stores them bitcast in lane 3), so per-shard results merge with
    the same all-gather top-k as the grid engine (``merge_topk``), with
    the selected neighbors' coordinates travelling with the merge — no
    device ever materializes the full target cloud.
  * Source rows shard over ``"points"``; the EM-LM 7x7 normal equations
    reduce with psum over that axis exactly as in parallel/distributed.py.

Replaces the reference's per-iteration FLANN kd-tree rebuild + query loop
(src/prob_point_cloud_registration.cc:66-81) at multi-device scale with the
engine that holds the single-chip perf record.

Tie semantics: merged results resolve exact-distance ties at the k-th slot
by shard order then slot order — the same caveat as the grid-sharded and
overflow-merge paths (ops/neighbors.py:16); neighbor SETS are identical.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import backend
from ..core.se3 import quat_rotate_points
from ..core.types import round_up
from ..models.em_lm import LMConfig, LMResult, em_lm_solve
from ..ops.fused_grid import BLOCK_GROUPS, GROUP
from ..ops import fused_pool as _fp
from .grid_sharded import (
    merge_topk,
    merge_topk_scatter,
    sharded_merge_topk,
)
from .mesh import (
    POINTS_AXIS,
    TARGETS_AXIS,
    all_gather_replicated,
)


class ShardedPoolPlan(NamedTuple):
    """Host-side harmonized per-shard pool plans (numpy, pre-upload).

    ``seeds`` holds the stacked upload arrays (leading axis = n_shards) for
    the device pool build; every per-shard slice has identical shapes by
    the force-mode contract, so the stack is rectangular.
    """

    seeds: dict  # str -> (T, ...) numpy arrays
    plan_key: tuple  # harmonized static key for _build_pools
    class_widths: tuple
    class_ends: tuple  # padded exclusive ends (harmonized)
    class_budgets: tuple  # max over shards (last entry fixed by the step)
    budget_rows: int  # max over shards (floored by the step's source count)
    cell_size: float
    n_shards: int
    select_max_w: int
    # True when budget_rows already covers the measured per-(slice, shard)
    # grouping demand of the real source — the step then drops its blunt
    # provably-sufficient 8x source-rows floor (docs/PERF.md round-4).
    demand_sized: bool = False


def choose_pool_shard_layout(
    n_src: int,
    n_tgt: int,
    occupied_cells: int,
    n_devices: int,
    tp: int,
) -> dict:
    """Occupancy-aware shard-axis decision for the pooled engine.

    Target-axis sharding shrinks per-shard window unions ~tp-fold (fewer
    select-kernel extraction rounds) but keeps EVERY device's full source
    slice grouping against ~the same window set — per-window source
    occupancy thins toward 1 and each live window still costs a full
    8-row group, so sparse scans inflate padded rows toward
    8 x sources/devrow (the 8x budget make_sharded_pool_registration_step
    must provision). Points-only sharding (all devices on the ``"points"``
    axis) divides sources S ways at UNCHANGED window widths — occupancy-
    neutral, no top-k merge traffic at all.

    This chooser estimates per-device select lane work both ways from
    three cheap host statistics (no dilation, no plan build):

      U  = occupied grid cells ~= candidate windows
      w  = 27 * n_tgt / U      mean window union lanes (27-cell stencil
                               at mean cell occupancy), rounded up to a
                               pow2 pool class and clamped to the
                               narrowest class (fused_pool.MIN_CLASS_LANES)
                               AFTER the tp split
      rows(m) = 8 * min(U, m) * ceil(max(m/U, 1) / 8)
                               live windows x 8-row groups for m sources

      W_targets = rows(n_src / (S/tp)) * clamp(w / tp)
      W_points  = rows(n_src / S)      * clamp(w)

    Returns {"layout": "targets"|"points", "w_targets", "w_points",
    "occ_per_devrow"}. ``layout`` is "points" when W_points wins (only
    possible when padding inflation beats the width shrink — the
    occupancy threshold the round-3 analysis called for, docs/PERF.md
    "realistic multi-chip efficiency bound is set by occupancy").
    """
    floor = _fp.MIN_CLASS_LANES
    u = max(int(occupied_cells), 1)
    w_bar = 27.0 * n_tgt / u

    def clamp(w: float) -> int:
        return max(1 << int(np.ceil(np.log2(max(w, 1.0)))), floor)

    def rows(m: float) -> float:
        live = min(float(u), m)
        occ = max(m / u, 1.0)
        return 8.0 * live * np.ceil(occ / 8.0)

    tp = max(1, min(tp, n_devices))
    dp = max(1, n_devices // tp)
    w_targets = rows(n_src / dp) * clamp(w_bar / tp)
    w_points = rows(n_src / n_devices) * clamp(w_bar)
    return {
        "layout": "points" if w_points < w_targets else "targets",
        "w_targets": float(w_targets),
        "w_points": float(w_points),
        "occ_per_devrow": float(n_src / dp / u),
    }


def build_sharded_pool_host(
    target: np.ndarray,
    cell_size: float,
    n_shards: int,
    *,
    num_valid: int | None = None,
    source_slices: list | None = None,
) -> ShardedPoolPlan | None:
    """Deal target rows round-robin into ``n_shards`` pooled prepacks.

    Pure numpy. Returns None when any shard declines the pooled engine
    (same conditions as plan_pool_host) — callers fall back to the sharded
    grid engine (parallel/grid_sharded.py).

    ``source_slices`` (the per-points-shard source row slices the step
    will run) switches the row budget from the blunt provably-sufficient
    8x source-rows floor to the MEASURED grouping demand, max over every
    (slice, target-shard) pair x1.25 (estimate_pool_demand_rows — the
    same exact replay the single-device ctor uses). Dense scans shrink
    their per-shard glue work up to ~5x; the runtime overflow flag plus
    the align scan's budget-escalation ladder still guard intra-pair
    drift.
    """
    from ..ops.grid import build_grid_host

    target = np.asarray(target, dtype=np.float64)
    n = num_valid if num_valid is not None else target.shape[0]
    if n < n_shards or cell_size <= 0 or not np.isfinite(cell_size):
        return None
    rows_of = [np.arange(s, n, n_shards) for s in range(n_shards)]

    grids = []
    for rows in rows_of:
        # buckets=False: the pooled plan reads only the cell-sorted view
        # (the sharded grid FALLBACK builds its own bucketed grids).
        g = build_grid_host(target[rows], cell_size, buckets=False)
        if g is None:
            return None
        grids.append(g)
    # Harmonized static geometry across shards: one class ladder, padded
    # sizes / scatter tables / upload shapes as maxima over the group —
    # classes a shard lacks become zero-size bands padded to the shared
    # floor.
    plans2 = _fp.plan_pool_host_group(
        grids, [target[rows] for rows in rows_of]
    )
    if plans2 is None:
        return None
    for rows, g, p2 in zip(rows_of, grids, plans2):
        # Globalize the packed payload ids: lane 3 of the cell-sorted packed
        # rows carries the ORIGINAL target row (bitcast int32); rewrite the
        # shard-local ids with this shard's global rows so per-shard search
        # results need no re-indexing before the merge.
        n_s = g["num_valid"]
        order = g["sort_order"][:n_s]
        p2["packed"][:n_s, 3] = (
            rows[order].astype(np.int32).view(np.float32)
        )

    seed_keys = (
        "packed", "cell_start", "cell_count", "base_e", "d_cells_e",
        "off_e", "d_cells", "row_vals",
    )
    seeds = {
        key: np.stack([p[key] for p in plans2]) for key in seed_keys
    }
    seeds["dims_d"] = np.stack([p["dil"]["dims_d"] for p in plans2])
    seeds["origin_d"] = np.stack([p["dil"]["origin_d"] for p in plans2])

    ends_pad = plans2[0]["ends"]
    ladder = list(plans2[0]["widths"])
    plan_key = (
        tuple(ladder),
        tuple(ends_pad),
        plans2[0]["prod_d_pad"],
        plans2[0]["prod_e_pad"],
        "float32",
        plans2[0]["assemble"],  # force-mode: the class widths (shared)
    )
    budgets = tuple(
        int(max(p["budgets"][c] for p in plans2))
        for c in range(len(ladder))
    )
    budget_rows = max(int(p["budget_rows"]) for p in plans2)
    demand_sized = False
    if source_slices:
        from ..core.types import bucket_rows

        demand = 0
        cum_max = [0] * len(ladder)
        for p2 in plans2:
            ends_p = tuple(p2["ends"])
            for sl in source_slices:
                d, cu = _fp.estimate_pool_demand_rows(
                    p2, sl, class_row_ends=ends_p
                )
                demand = max(demand, d)
                cum_max = [max(a, b) for a, b in zip(cum_max, cu)]
        budget_rows = max(
            budget_rows, bucket_rows(int(1.25 * demand), step_bits=3)
        )
        # Demand-sized class-PREFIX budgets (max over every (shard, slice)
        # replay) — same rationale and margins as the single-device
        # dispatch (fused_pool.demand_class_budgets; NOT clamped to the
        # plan's 2x proxies — the replay may legitimately exceed them).
        # The scan factories' budget-escalation scaling and their ng
        # clamps still apply on top.
        budgets = _fp.demand_class_budgets(cum_max, budgets[-1])
        demand_sized = True
    return ShardedPoolPlan(
        seeds=seeds,
        plan_key=plan_key,
        class_widths=tuple(ladder),
        class_ends=tuple(int(e) for e in plans2[0]["ends"]),
        class_budgets=budgets,
        budget_rows=budget_rows,
        cell_size=float(cell_size),
        n_shards=n_shards,
        select_max_w=backend.SELECT_MAX_W,
        demand_sized=demand_sized,
    )


def estimate_sharded_demand_rows(
    sp: ShardedPoolPlan, sources: list, with_classes: bool = False
):
    """Measured grouping demand of real source slices against a PREPARED
    sharded plan (max over every (slice, shard) pair).

    Sequence pipelines build the ShardedPoolPlan on the target-prep thread
    BEFORE the pair's source exists (parallel.align.DistributedRegistration
    .prepare_target), so the plan ships without demand sizing; the ctor
    then replays the grouping arithmetic from the plan's own seed arrays —
    the same numpy replay as fused_pool.estimate_pool_demand_rows, ~20 ms
    per (slice, shard) at KITTI scale.

    ``with_classes=True`` returns ``(rows, cum_groups)`` with the
    per-class cumulative group counts (max over every (slice, shard)
    pair) — the ctor then demand-sizes the class-prefix budgets too.
    """
    prod_d_pad = sp.plan_key[2]
    best = 0
    cum_max = [0] * len(sp.class_ends)
    for s in range(sp.n_shards):
        plan_like = {
            "dil": {
                "dims_d": sp.seeds["dims_d"][s],
                "origin_d": sp.seeds["origin_d"][s],
            },
            "cell_size": sp.cell_size,
            "prod_d_pad": prod_d_pad,
            "d_cells": sp.seeds["d_cells"][s],
            "row_vals": sp.seeds["row_vals"][s],
        }
        for src in sources:
            if with_classes:
                d, cu = _fp.estimate_pool_demand_rows(
                    plan_like, src, class_row_ends=sp.class_ends
                )
                cum_max = [max(a, b) for a, b in zip(cum_max, cu)]
            else:
                d = _fp.estimate_pool_demand_rows(plan_like, src)
            best = max(best, d)
    if with_classes:
        return best, cum_max
    return best


class ShardedPools(NamedTuple):
    """Device pool state, every array's leading axis = n_shards (shard it
    over ``"targets"``)."""

    pool_xyz: tuple  # per class: (T, R_c + 1, 3, W_c)
    pool_idx: tuple  # per class: (T, R_c + 1, W_c)
    width_lut: jnp.ndarray  # (T, R_pad + 1) per-row select widths
    lut_d: jnp.ndarray  # (T, prod_d_pad) packed grouping keys
    origin_d: jnp.ndarray  # (T, 3)
    dims_d: jnp.ndarray  # (T, 3)


def build_sharded_pools_device(
    mesh: jax.sharding.Mesh, sp: ShardedPoolPlan, dtype=jnp.float32,
) -> ShardedPools:
    """Run the pool packing ON each target shard's devices (shard_map over
    ``_build_pools`` — the same one-program device build as the single-chip
    path, so no pool bytes ever cross hosts; only the ~MB seed arrays do).

    On a 2D mesh each target shard's pool is packed ONCE (on the points-row-0
    device of its mesh column) and broadcast along ``"points"`` with a psum
    (zeros elsewhere — exact). Every (points, targets) device still HOLDS a
    copy — the search consumes the pool on every device row, so the HBM
    footprint is inherent — but the packing FLOPs no longer multiply by dp
    (a 2x4 mesh would otherwise build every pool twice; the broadcast
    moves pool bytes between devices instead).
    """
    P = jax.sharding.PartitionSpec
    t_spec = jax.sharding.NamedSharding(mesh, P(TARGETS_AXIS))
    # Only the true build seeds are uploaded: the search-grid cell ids are
    # DERIVED on device inside _build_pools (the host copy stays in
    # sp.seeds for the demand replay); origin_d is search-only and uploads
    # once below.
    dev = {
        key: jax.device_put(np.asarray(v), t_spec)
        for key, v in sp.seeds.items()
        if key not in ("d_cells", "origin_d")
    }
    plan_key = sp.plan_key[:4] + (np.dtype(dtype).name,) + sp.plan_key[5:]
    dp = mesh.shape[POINTS_AXIS]
    _BUILD_KEYS = (
        "packed", "cell_start", "cell_count", "base_e", "d_cells_e",
        "off_e", "row_vals", "dims_d",
    )

    def build(packed, cell_start, cell_count, base_e, d_cells_e, off_e,
              row_vals, dims_d):
        sq = lambda a: a.reshape(a.shape[1:])
        return _fp._build_pools.__wrapped__(
            sq(packed), sq(cell_start), sq(cell_count), sq(base_e),
            sq(d_cells_e), sq(off_e), sq(row_vals), sq(dims_d),
            plan_key=plan_key,
        )

    # Output shapes (per shard) for the non-building points rows' zeros.
    out_sds = jax.eval_shape(
        build,
        *(
            jax.ShapeDtypeStruct(
                (1,) + sp.seeds[key].shape[1:], sp.seeds[key].dtype
            )
            for key in _BUILD_KEYS
        ),
    )

    def body(packed, cell_start, cell_count, base_e, d_cells_e, off_e,
             row_vals, dims_d):
        args = (packed, cell_start, cell_count, base_e, d_cells_e, off_e,
                row_vals, dims_d)
        if dp == 1:
            pool_xyz, pool_idx, lut_d, width_lut = build(*args)
        else:
            # Both branches must agree on vma types: empty classes' pool
            # arrays are pure constants (unvarying) in the build branch
            # while jnp.zeros is unvarying in the other — pvary everything
            # onto both mesh axes so lax.cond type-checks and the psum
            # below is a true contribution-sum.
            both = (POINTS_AXIS, TARGETS_AXIS)

            def _pvary_all(tree):
                def one(x):
                    have = getattr(jax.typeof(x), "vma", frozenset())
                    need = tuple(a for a in both if a not in have)
                    if not need:
                        return x
                    return lax.pcast(x, need, to="varying")

                return jax.tree.map(one, tree)

            built = lax.cond(
                lax.axis_index(POINTS_AXIS) == 0,
                lambda a: _pvary_all(build(*a)),
                lambda a: _pvary_all(
                    jax.tree.map(
                        lambda s: jnp.zeros(s.shape, s.dtype), out_sds
                    )
                ),
                args,
            )
            # Broadcast along "points": exactly one row contributed.
            pool_xyz, pool_idx, lut_d, width_lut = jax.tree.map(
                lambda x: lax.psum(x, POINTS_AXIS), built
            )
        add = lambda a: a[None]
        return (
            tuple(add(x) for x in pool_xyz),
            tuple(add(x) for x in pool_idx),
            add(lut_d),
            add(width_lut),
        )

    nc = len(sp.class_widths)
    built = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(TARGETS_AXIS),) * 8,
            out_specs=(
                (P(TARGETS_AXIS),) * nc,
                (P(TARGETS_AXIS),) * nc,
                P(TARGETS_AXIS),
                P(TARGETS_AXIS),
            ),
        )
    )(*(dev[key] for key in _BUILD_KEYS))
    pool_xyz, pool_idx, lut_d, width_lut = built
    return ShardedPools(
        pool_xyz=pool_xyz,
        pool_idx=pool_idx,
        width_lut=width_lut,
        lut_d=lut_d,
        origin_d=jax.device_put(sp.seeds["origin_d"].astype(dtype), t_spec),
        dims_d=dev["dims_d"],
    )


class ShardedPoolStepResult(NamedTuple):
    result: LMResult
    num_correspondences: jnp.ndarray
    overflow: jnp.ndarray  # total budget overflows (must be 0 to consume)


def make_sharded_pool_registration_step(
    mesh: jax.sharding.Mesh,
    sp: ShardedPoolPlan,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_rows_per_shard: int,
    debug_replication: bool = False,
):
    """Jitted full outer iteration with the POOLED engine over a 2D mesh.

    Call with the source rows sharded over ``"points"`` and a
    :class:`ShardedPools` built by :func:`build_sharded_pools_device`:

      step(fs, sv, pools, q_cum, t_cum, q0, t0) -> ShardedPoolStepResult

    ``source_rows_per_shard`` = padded source rows / points-axis size. The
    per-shard search budget is the PROVABLY sufficient bound 8x that count:
    target sharding thins per-window source occupancy toward 1 (each shard
    keeps ~all cells occupied at 1/T density, and every device's full
    source slice groups against them), and a window holding s sources costs
    ceil(s/8)*8 <= s+7 rows, so 8 * n_src rows always fit — the planned
    per-shard estimate (scaled to the shard's own target count) can
    undercount ~8x here. The row-overflow flag therefore never fires;
    ``overflow`` stays as a class-prefix-budget guard (nonzero means redo
    the step on the sharded grid engine).
    """
    P = jax.sharding.PartitionSpec
    cfg = lm_config._replace(axis_name=POINTS_AXIS)
    tp_size = mesh.shape[TARGETS_AXIS]
    scatter = (
        tp_size & (tp_size - 1) == 0
        and source_rows_per_shard % tp_size == 0
    )
    # Row budget: the measured-demand budget when the host plan carried
    # source slices (sp.demand_sized — glue work scales with budget, so
    # dense scans win up to ~5x), else the provably-sufficient 8x floor:
    # target sharding thins per-window source occupancy toward 1 and a
    # window holding s sources costs ceil(s/8)*8 <= s+7 rows, so
    # 8 * n_src rows always fit.
    floor_rows = (
        source_rows_per_shard + 4096
        if sp.demand_sized
        else 8 * source_rows_per_shard
    )
    budget = round_up(
        max(sp.budget_rows, floor_rows), 2 * BLOCK_GROUPS * GROUP
    )
    ng = budget // GROUP
    # Mid-class prefix budgets were estimated for the shard's own target
    # count; scale them with the row-budget inflation (the coverage flag
    # still guards the estimate).
    scale = max(1, -(-budget // max(sp.budget_rows, 1)))
    budgets = tuple(
        min(ng, round_up(b * scale, BLOCK_GROUPS))
        for b in sp.class_budgets[:-1]
    ) + (ng,)

    def body(fs, sv, pool_xyz, pool_idx, width_lut, lut_d,
             origin_d, dims_d, q_cum, t_cum, q0, t0):
        sq = lambda a: a.reshape(a.shape[1:])
        moved = quat_rotate_points(q_cum, fs) + t_cum
        corr, overflow, pts = _fp.fused_pool_search(
            moved,
            sv,
            tuple(sq(x) for x in pool_xyz),
            tuple(sq(x) for x in pool_idx),
            sq(width_lut),
            sq(lut_d),
            sq(origin_d),
            sq(dims_d),
            k=k,
            radius=radius,
            class_widths=sp.class_widths,
            class_ends=sp.class_ends,
            class_budgets=budgets,
            budget_rows=budget,
            return_points=True,
            select_max_w=sp.select_max_w,
        )
        local_d = jnp.where(corr.mask, corr.sq_dists, jnp.inf)
        if scatter:
            # Reduce-scatter merge: device r of the targets axis ends
            # owning block r of the points-row's sources, fully merged —
            # the EM-LM solve then shards over BOTH axes (psum over
            # ("points", "targets")), dividing solve FLOPs by tp and
            # cutting merge traffic to ~one contribution's bytes.
            best_i, best_d, found, best_p, off = merge_topk_scatter(
                local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS
            )
            blk = moved.shape[0] // mesh.shape[TARGETS_AXIS]
            moved_s = lax.dynamic_slice_in_dim(moved, off, blk)
            cfg2 = cfg._replace(axis_name=(POINTS_AXIS, TARGETS_AXIS))
            result = em_lm_solve(moved_s, best_p, found, q0, t0, cfg2)
            n_corr = lax.psum(
                lax.psum(jnp.sum(found.astype(jnp.int32)), TARGETS_AXIS),
                POINTS_AXIS,
            )
        else:
            best_i, best_d, found, best_p = sharded_merge_topk(
                local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS
            )
            result = em_lm_solve(moved, best_p, found, q0, t0, cfg)
            n_corr = lax.psum(jnp.sum(found.astype(jnp.int32)), POINTS_AXIS)
        if debug_replication:
            # Runtime replication assert (the property check_vma=False
            # stops asserting statically — see the shard_map below): the
            # merged distances (non-scatter) / the
            # two-axis-psum'd solve outputs (scatter) must be identical
            # across the targets axis; any divergence poisons q with NaN.
            probe = (
                result.t
                if scatter
                else jnp.where(found, best_d, 0.0)
            )
            dev = jnp.max(jnp.abs(probe - lax.pmean(probe, TARGETS_AXIS)))
            result = result._replace(
                q=result.q
                + jnp.where(dev == 0, 0.0, jnp.nan).astype(result.q.dtype)
            )
        ov = lax.psum(
            lax.psum(overflow, TARGETS_AXIS), POINTS_AXIS
        )
        return ShardedPoolStepResult(
            result=result, num_correspondences=n_corr, overflow=ov
        )

    nc = len(sp.class_widths)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(POINTS_AXIS),  # source rows
            P(POINTS_AXIS),  # source validity
            (P(TARGETS_AXIS),) * nc,  # pool_xyz per class
            (P(TARGETS_AXIS),) * nc,  # pool_idx per class
            P(TARGETS_AXIS),  # width_lut
            P(TARGETS_AXIS),  # lut_d
            P(TARGETS_AXIS),  # origin_d
            P(TARGETS_AXIS),  # dims_d
            P(),
            P(),
            P(),
            P(),
        ),
        out_specs=ShardedPoolStepResult(
            result=LMResult(q=P(), t=P(), initial_cost=P(), final_cost=P(),
                            num_iterations=P(), num_successful_steps=P(),
                            trace=P()),
            num_correspondences=P(),
            overflow=P(),
        ),
        # Merge outputs are replicated along "targets" (invariant gather)
        # and psum-reduced along "points". check_vma stays OFF on the two
        # POOLED shard_maps (here and the align scan below) because of the
        # Pallas select kernel inside: in interpret mode (the CPU tests)
        # pallas_call carries no vma types, and the kernel body fails the
        # checker on any op mixing kernel constants with vma-carrying
        # operands. Replication is asserted at RUNTIME instead
        # (debug_replication, exercised by tests/test_distributed_align.py)
        # plus the single-device parity suites.
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def step(fs, sv, pools: ShardedPools, q_cum, t_cum, q0, t0):
        return jitted(
            fs, sv, pools.pool_xyz, pools.pool_idx, pools.width_lut,
            pools.lut_d, pools.origin_d, pools.dims_d,
            q_cum, t_cum, q0, t0,
        )

    return step


def make_sharded_pool_align_scan(
    mesh: jax.sharding.Mesh,
    sp: ShardedPoolPlan,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    source_rows_per_shard: int,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
    budget_boost: int = 0,
    debug_replication: bool = False,
):
    """The FULL outer-loop chunk of :class:`DistributedRegistration`:
    up to ``chunk`` sharded pooled outer iterations in ONE device program,
    with the reference stopping rule carried on device.

    This is the multi-device analogue of
    models.registration._registration_scan_pool: the per-iteration compute
    is the sharded pooled search + all-gather top-k merge + psum'd EM-LM
    solve of :func:`make_sharded_pool_registration_step`, wrapped in
    models.registration._scan_convergence so converged pairs stop computing
    mid-chunk and the host syncs once per chunk — the same product contract
    (history, CSV records, per-LM traces, overflow fallback) as the
    single-device ``align()``
    (reference unit: src/prob_point_cloud_registration.cc:63-136).

    The stopping-rule inputs (q_cum, cost drop, stall counter) are
    replicated scalars, so every device takes the same ``lax.cond`` branch
    and the collectives inside the compute branch stay uniform across the
    mesh.

    ``budget_boost`` doubles the per-shard row budget per unit (the
    host-side overflow-escalation ladder). ``debug_replication`` adds a
    runtime check that the merged results really are replicated along the
    ``"targets"`` axis (the property check_vma=False stops asserting
    statically): any divergence poisons the emitted costs with NaN.

    Returns scan(fs, sv, pools, q_cum, t_cum, q0, t0, drop0, unuseful0,
    it0) -> per-slot tuple (q, t, initial_cost, final_cost, num_iterations,
    num_successful_steps, n_corr, overflow, trace, executed), every output
    replicated.
    """
    from ..models.registration import _scan_convergence

    P = jax.sharding.PartitionSpec
    cfg = lm_config._replace(axis_name=POINTS_AXIS)
    tp_size = mesh.shape[TARGETS_AXIS]
    scatter = (
        tp_size & (tp_size - 1) == 0
        and source_rows_per_shard % tp_size == 0
    )
    floor_rows = (
        source_rows_per_shard + 4096
        if sp.demand_sized
        else 8 * source_rows_per_shard
    )
    # Boost the EFFECTIVE budget (max of plan and floor): boosting only
    # sp.budget_rows is a no-op whenever the floor dominates — the retry
    # would re-dispatch an identical program and overflow again.
    budget = round_up(
        max(sp.budget_rows, floor_rows) << budget_boost,
        2 * BLOCK_GROUPS * GROUP,
    )
    ng = budget // GROUP
    scale = max(1, -(-budget // max(sp.budget_rows, 1)))
    budgets = tuple(
        min(ng, round_up(b * scale, BLOCK_GROUPS))
        for b in sp.class_budgets[:-1]
    ) + (ng,)

    def body(fs, sv, pool_xyz, pool_idx, width_lut, lut_d,
             origin_d, dims_d, q_cum, t_cum, q0, t0, drop0, unuseful0, it0):
        sq = lambda a: a.reshape(a.shape[1:])

        def compute(qc, tc):
            moved = quat_rotate_points(qc, fs) + tc
            corr, overflow, pts = _fp.fused_pool_search(
                moved,
                sv,
                tuple(sq(x) for x in pool_xyz),
                tuple(sq(x) for x in pool_idx),
                sq(width_lut),
                sq(lut_d),
                sq(origin_d),
                sq(dims_d),
                k=k,
                radius=radius,
                class_widths=sp.class_widths,
                class_ends=sp.class_ends,
                class_budgets=budgets,
                budget_rows=budget,
                return_points=True,
                select_max_w=sp.select_max_w,
            )
            local_d = jnp.where(corr.mask, corr.sq_dists, jnp.inf)
            if scatter:
                # Reduce-scatter merge + two-axis solve (see the step
                # factory above): outputs stay replicated because every
                # solve quantity is psum'd over BOTH axes.
                best_i, best_d, found, best_p, off = merge_topk_scatter(
                    local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS
                )
                blk = moved.shape[0] // tp_size
                moved_s = lax.dynamic_slice_in_dim(moved, off, blk)
                cfg2 = cfg._replace(
                    axis_name=(POINTS_AXIS, TARGETS_AXIS)
                )
                res = em_lm_solve(moved_s, best_p, found, q0, t0, cfg2)
            else:
                best_i, best_d, found, best_p = sharded_merge_topk(
                    local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS
                )
                res = em_lm_solve(moved, best_p, found, q0, t0, cfg)
            q_out = res.q
            if debug_replication:
                # Runtime replication assert for the merged outputs (the
                # property the vma checker cannot prove through the Pallas
                # kernel): if any device's merged distances (non-scatter)
                # or two-axis-psum'd solve outputs (scatter — the merged
                # blocks are intentionally NOT replicated there) diverge
                # from the targets-axis mean, poison the solve outputs
                # with NaN so tests (and any parity harness) fail loudly.
                fin = (
                    res.t if scatter else jnp.where(found, best_d, 0.0)
                )
                dev = jnp.max(
                    jnp.abs(fin - lax.pmean(fin, TARGETS_AXIS))
                )
                q_out = q_out + jnp.where(dev == 0, 0.0, jnp.nan).astype(
                    q_out.dtype
                )
            n_corr = jnp.sum(found.astype(jnp.int32))
            if scatter:
                n_corr = lax.psum(n_corr, TARGETS_AXIS)
            n_corr = lax.psum(n_corr, POINTS_AXIS)
            ov = lax.psum(lax.psum(overflow, TARGETS_AXIS), POINTS_AXIS)
            return (
                q_out,
                res.t,
                res.initial_cost,
                res.final_cost,
                res.num_iterations,
                res.num_successful_steps,
                n_corr,
                ov,
                res.trace,
            )

        return _scan_convergence(
            compute, q_cum, t_cum, drop0, unuseful0, it0, chunk=chunk,
            n_iter=n_iter, cost_drop_thresh=cost_drop_thresh,
            n_cost_drop_it=n_cost_drop_it,
        )

    nc = len(sp.class_widths)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(POINTS_AXIS),  # source rows
            P(POINTS_AXIS),  # source validity
            (P(TARGETS_AXIS),) * nc,
            (P(TARGETS_AXIS),) * nc,
            P(TARGETS_AXIS),  # width_lut
            P(TARGETS_AXIS),  # lut_d
            P(TARGETS_AXIS),  # origin_d
            P(TARGETS_AXIS),  # dims_d
            P(), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=(P(),) * 10,
        # Same check_vma story as the step factory above.
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def scan(fs, sv, pools: ShardedPools, q_cum, t_cum, q0, t0, drop0,
             unuseful0, it0):
        return jitted(
            fs, sv, pools.pool_xyz, pools.pool_idx, pools.width_lut,
            pools.lut_d, pools.origin_d, pools.dims_d,
            q_cum, t_cum, q0, t0, drop0, unuseful0, it0,
        )

    return scan
