"""Scan-pair batch parallelism: many registrations in one device program.

Sequential odometry registers consecutive pairs (scan_k -> scan_{k+1});
every pair is INDEPENDENT, so a sequence of S scans is S-1 embarrassingly
parallel registrations. The reference processes one pair per process
(src/prob_point_cloud_registration_ex.cc); here the pairs are stacked on a
batch axis, the full outer loop runs under ``vmap`` + ``lax.while_loop``
entirely on device, and the batch axis is sharded across the mesh (the
analogue of data-parallel training batches).

Convergence semantics: each pair carries the reference's stopping rule
(src/prob_point_cloud_registration.cc:138-158 — max iterations, plus
cost-drop-below-threshold for more than ``n_cost_drop_it`` consecutive
checks, counter reset on any good iteration, checked BEFORE each iteration
with the previous drop) as per-pair state inside the batched while_loop.
JAX's while_loop batching freezes finished pairs' state, so a converged
pair's transform stops moving exactly where the sequential host loop would
stop it, and the loop exits when every pair is done — no fixed-n_outer
post-convergence drift or wasted full-batch iterations. Trajectory
equality with the sequential pipeline is asserted in tests/test_batch.py.

Engines: ``search_impl="brute"`` streams the full target per pair;
``"grid"`` batches per-pair hash grids (common padded capacity/cell count)
so the batched path runs the same production engine as the single-pair path.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import backend
from ..core.se3 import quat_multiply, quat_normalize, quat_rotate_points, unit_quat_rotate
from ..models.em_lm import LMConfig, em_lm_solve
from ..ops.neighbors import radius_search


class BatchedPairResult(NamedTuple):
    q: jnp.ndarray  # (B, 4) cumulative rotation per pair
    t: jnp.ndarray  # (B, 3) cumulative translation per pair
    initial_costs: jnp.ndarray  # (B, n_outer); 0 where not executed
    final_costs: jnp.ndarray  # (B, n_outer)
    num_correspondences: jnp.ndarray  # (B, n_outer)
    num_iterations: jnp.ndarray  # (B,) outer iterations actually executed
    # (B,) pooled-engine budget overflow count. From
    # batched_pair_register_pool directly: nonzero pairs' results are
    # INVALID and must be redone on the grid engine. From
    # run_odometry_batched: the redo already happened — nonzero just marks
    # which pairs the grid engine recomputed (results valid). Always 0 for
    # the brute/grid engines.
    overflow: jnp.ndarray | None = None


def _outer_loop(search_fn, src, sv, q0, t0, lm_config, n_outer,
                cost_drop_thresh, n_cost_drop_it, dtype):
    """Per-pair outer loop with the reference's convergence rule as carried
    state. ``search_fn(moved) -> (neighbor_pts, mask, n_corr, overflow)``."""
    thresh = jnp.asarray(cost_drop_thresh, dtype)

    def cond(s):
        return jnp.logical_not(s["done"])

    def body(s):
        # Pre-iteration convergence check on the PREVIOUS drop (cc:138-158).
        stop_iter = s["it"] >= n_outer
        low = s["drop"] < thresh
        stop_drop = low & (s["unuseful"] > n_cost_drop_it)
        done_now = stop_iter | stop_drop
        unuseful = jnp.where(low, s["unuseful"] + 1, 0)

        moved = quat_rotate_points(s["q"], src) + s["t"]
        pts, mask, n_corr, ovf = search_fn(moved)
        res = em_lm_solve(moved, pts, mask, q0, t0, lm_config)
        qn = quat_normalize(res.q)
        q_new = quat_multiply(qn, s["q"])
        t_new = unit_quat_rotate(qn, s["t"]) + res.t
        drop_new = jnp.where(
            res.initial_cost != 0,
            (res.initial_cost - res.final_cost) / res.initial_cost,
            0.0,
        ).astype(dtype)

        it_c = jnp.clip(s["it"], 0, n_outer - 1)
        keep = jnp.logical_not(done_now)

        def upd(buf, val):
            return jnp.where(
                keep, lax.dynamic_update_index_in_dim(buf, val.astype(buf.dtype), it_c, 0), buf
            )

        return {
            "it": jnp.where(keep, s["it"] + 1, s["it"]),
            "q": jnp.where(keep, q_new, s["q"]),
            "t": jnp.where(keep, t_new, s["t"]),
            "drop": jnp.where(keep, drop_new, s["drop"]),
            "unuseful": jnp.where(keep, unuseful, s["unuseful"]),
            "done": done_now,
            "ic": upd(s["ic"], res.initial_cost),
            "fc": upd(s["fc"], res.final_cost),
            "nc": upd(s["nc"], n_corr),
            "ovf": s["ovf"] + jnp.where(keep, ovf.astype(jnp.int32), 0),
        }

    init = {
        "it": jnp.int32(0),
        "q": q0,
        "t": t0,
        "drop": jnp.asarray(0.0, dtype),
        "unuseful": jnp.int32(0),
        "done": jnp.asarray(False),
        "ic": jnp.zeros((n_outer,), dtype),
        "fc": jnp.zeros((n_outer,), dtype),
        "nc": jnp.zeros((n_outer,), jnp.int32),
        "ovf": jnp.int32(0),
    }
    s = lax.while_loop(cond, body, init)
    return s["q"], s["t"], s["ic"], s["fc"], s["nc"], s["it"], s["ovf"]


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "lm_config", "n_outer", "source_tile", "target_tile",
        "cost_drop_thresh", "n_cost_drop_it",
    ),
)
def batched_pair_register(
    sources: jnp.ndarray,  # (B, N, 3)
    targets: jnp.ndarray,  # (B, M, 3)
    source_valid: jnp.ndarray,  # (B, N)
    target_valid: jnp.ndarray,  # (B, M)
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    n_outer: int,
    source_tile: int = 4096,
    target_tile: int = 2048,
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
) -> BatchedPairResult:
    """Register every (source, target) pair, streaming brute-force engine.

    ``cost_drop_thresh < 0`` disables the convergence rule (fixed ``n_outer``
    iterations — benchmarking); otherwise each pair stops exactly where the
    sequential host loop would."""
    dtype = sources.dtype
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0], dtype)
    t0 = jnp.zeros((3,), dtype)

    def one_pair(src, tgt, sv, tv):
        def search(moved):
            corr = radius_search(
                moved, tgt, k=k, radius=radius, source_valid=sv,
                target_valid=tv, source_tile=source_tile,
                target_tile=target_tile,
            )
            return tgt[corr.indices], corr.mask, jnp.sum(corr.mask), jnp.int32(0)

        return _outer_loop(search, src, sv, q0, t0, lm_config, n_outer,
                           cost_drop_thresh, n_cost_drop_it, dtype)

    q, t, ic, fc, nc, it, ovf = jax.vmap(one_pair)(
        sources, targets, source_valid, target_valid
    )
    return BatchedPairResult(
        q=q, t=t, initial_costs=ic, final_costs=fc, num_correspondences=nc,
        num_iterations=it, overflow=ovf,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "lm_config", "n_outer", "capacity", "source_tile",
        "cost_drop_thresh", "n_cost_drop_it",
    ),
)
def batched_pair_register_grid(
    sources: jnp.ndarray,  # (B, N, 3)
    targets: jnp.ndarray,  # (B, M, 3)
    source_valid: jnp.ndarray,  # (B, N)
    bucket_pts: jnp.ndarray,  # (B, U_max, capacity, 3)
    bucket_idx: jnp.ndarray,  # (B, U_max, capacity)
    luts: jnp.ndarray,  # (B, lut_len)
    origins: jnp.ndarray,  # (B, 3)
    dims: jnp.ndarray,  # (B, 3) int32
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    n_outer: int,
    capacity: int,
    source_tile: int = 4096,
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
) -> BatchedPairResult:
    """Batched registration with per-pair hash grids — the production
    single-device engine (ops/grid.py), batch-padded to a common capacity and
    occupied-cell count so every pair shares one program."""
    from ..ops.grid import grid_radius_search

    dtype = sources.dtype
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0], dtype)
    t0 = jnp.zeros((3,), dtype)

    def one_pair(src, tgt, sv, bp, bi, lut, origin, dim):
        def search(moved):
            corr = grid_radius_search(
                moved, bp, bi, jnp.zeros((bp.shape[0],), jnp.int32),
                origin, dim, lut,
                k=k, radius=radius, capacity=capacity, source_valid=sv,
                source_tile=source_tile,
            )
            return tgt[corr.indices], corr.mask, jnp.sum(corr.mask), jnp.int32(0)

        return _outer_loop(search, src, sv, q0, t0, lm_config, n_outer,
                           cost_drop_thresh, n_cost_drop_it, dtype)

    q, t, ic, fc, nc, it, ovf = jax.vmap(one_pair)(
        sources, targets, source_valid, bucket_pts, bucket_idx, luts, origins,
        dims,
    )
    return BatchedPairResult(
        q=q, t=t, initial_costs=ic, final_costs=fc, num_correspondences=nc,
        num_iterations=it, overflow=ovf,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "lm_config", "n_outer", "class_widths", "class_ends",
        "class_budgets", "budget_rows", "select_max_w", "cost_drop_thresh",
        "n_cost_drop_it",
    ),
)
def batched_pair_register_pool(
    sources: jnp.ndarray,  # (B, N, 3)
    source_valid: jnp.ndarray,  # (B, N)
    pool_xyz: tuple,  # per class: (B, n_c + 1, 3, W_c)
    pool_idx: tuple,  # per class: (B, n_c + 1, W_c)
    width_lut: jnp.ndarray,  # (B, R_pad + 1) per-row select widths
    lut_d: jnp.ndarray,  # (B, prod_d_pad) packed grouping keys
    origin_d: jnp.ndarray,  # (B, 3)
    dims_d: jnp.ndarray,  # (B, 3)
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    n_outer: int,
    class_widths: tuple,
    class_ends: tuple,
    class_budgets: tuple,
    budget_rows: int,
    select_max_w: int = backend.SELECT_MAX_W,
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
) -> BatchedPairResult:
    """Batched registration with per-pair capacity-free POOLED prepacks
    (ops/fused_pool.py), batch-harmonized to one static geometry
    (plan_pool_host_group) so every pair shares one program; the select is
    vmapped over the batch. It emits the selected neighbors' coordinates,
    so no per-pair target cloud is consulted inside the loop at all. Pairs whose runtime budget flag fires
    report ``overflow > 0`` and must be redone on the grid engine."""
    from ..ops.fused_pool import fused_pool_search

    dtype = sources.dtype
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0], dtype)
    t0 = jnp.zeros((3,), dtype)

    def one_pair(src, sv, pxyz, pidx, wl, ld, od, dd):
        def search(moved):
            corr, overflow, pts = fused_pool_search(
                moved, sv, pxyz, pidx, wl, ld, od, dd,
                k=k, radius=radius, class_widths=class_widths,
                class_ends=class_ends, class_budgets=class_budgets,
                budget_rows=budget_rows, return_points=True,
                select_max_w=select_max_w,
            )
            return pts, corr.mask, jnp.sum(corr.mask), overflow

        return _outer_loop(search, src, sv, q0, t0, lm_config, n_outer,
                           cost_drop_thresh, n_cost_drop_it, dtype)

    q, t, ic, fc, nc, it, ovf = jax.vmap(one_pair)(
        sources, source_valid, pool_xyz, pool_idx, width_lut, lut_d,
        origin_d, dims_d,
    )
    return BatchedPairResult(
        q=q, t=t, initial_costs=ic, final_costs=fc, num_correspondences=nc,
        num_iterations=it, overflow=ovf,
    )


def shard_batch(arrays, mesh: jax.sharding.Mesh, axis_name: str = "points"):
    """Place each array with its leading (batch) axis sharded over ``axis_name``."""
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(axis_name)
    )
    return tuple(jax.device_put(a, sharding) for a in arrays)


def _batched_grids_host(stack, counts, idx_tgt, radius):
    """Per-pair hash grids padded to a common (U_max, capacity, lut_len).

    Returns None if any pair can't build a grid (degenerate / LUT too big /
    occupancy too high) — caller falls back to the brute engine.
    """
    from ..ops.grid import build_grid_host

    uniq = {}
    for i in np.unique(idx_tgt):
        g = build_grid_host(stack[i], radius, num_valid=int(counts[i]))
        if g is None or "lut" not in g:
            return None
        uniq[int(i)] = g
    cap = max(g["capacity"] for g in uniq.values())
    cap = 1 << (cap - 1).bit_length()
    u_max = max(g["cell_ids"].shape[0] for g in uniq.values())
    lut_len = max(g["lut"].shape[0] for g in uniq.values())

    b = len(idx_tgt)
    bp = np.zeros((b, u_max, cap, 3), dtype=stack.dtype)
    bi = np.full((b, u_max, cap), -1, dtype=np.int32)
    luts = np.full((b, lut_len), -1, dtype=np.int32)
    origins = np.zeros((b, 3))
    dims = np.zeros((b, 3), dtype=np.int32)
    for row, i in enumerate(idx_tgt):
        g = uniq[int(i)]
        u, c = g["bucket_idx"].shape
        bp[row, :u, :c] = g["bucket_pts"]
        bi[row, :u, :c] = g["bucket_idx"]
        luts[row, : g["lut"].shape[0]] = g["lut"]
        origins[row] = g["origin"]
        dims[row] = g["dims"]
    return bp, bi, luts, origins, dims, cap


def _auto_pool(target, num_valid, radius) -> bool:
    """Whether ``search_impl="auto"`` takes the pooled engine for scans
    like ``target``: the backend's choice, where the scan has a grid."""
    from ..ops.grid import build_grid_host

    if backend.auto_engine() != "pool":
        return False
    g = build_grid_host(target, radius, num_valid=num_valid, buckets=False)
    return g is not None


def _batched_pools_host(stack, counts, idx_tgt, radius, dtype,
                        idx_src=None):
    """Per-pair POOLED prepacks harmonized to one static geometry
    (ops.fused_pool.plan_pool_host_group), stacked on the batch axis.

    ``idx_src`` (per-pair source scan ids) enables the demand-sized row
    budget: the plan's target-occupancy proxy undercounts REAL pairs
    ~1.5x at KITTI scale (models/registration.py ctor has the same fix),
    and in the batched engine an undercount silently sends those pairs to
    the grid-redo splice — correct but a whole second engine pass. The
    returned ``budget_rows`` then covers max-over-pairs real demand.

    Returns None when any pair declines the pooled engine — callers fall
    back to the batched grid engine.
    """
    from ..ops import fused_pool as _fp
    from ..ops.grid import build_grid_host

    uniq_ids = sorted({int(i) for i in idx_tgt})
    grids = {}
    for i in uniq_ids:
        # buckets=False: the pooled plan reads only the cell-sorted view.
        g = build_grid_host(
            stack[i], radius, num_valid=int(counts[i]), buckets=False
        )
        if g is None:
            return None
        grids[i] = g
    plans = _fp.plan_pool_host_group(
        [grids[i] for i in uniq_ids], [stack[i] for i in uniq_ids]
    )
    if plans is None:
        return None
    np_dtype = np.dtype(dtype)
    pres = {}
    for i, plan in zip(uniq_ids, plans):
        pre = _fp.build_pool_prepack(
            grids[i], stack[i], dtype=np_dtype, plan=plan
        )
        if pre is None:
            return None
        pres[i] = pre

    first = pres[uniq_ids[0]]
    n_classes = len(first.class_widths)
    rows = [pres[int(i)] for i in idx_tgt]
    pool_xyz = tuple(
        jnp.stack([r.pool_xyz[c] for r in rows]) for c in range(n_classes)
    )
    pool_idx = tuple(
        jnp.stack([r.pool_idx[c] for r in rows]) for c in range(n_classes)
    )
    budget_rows = max(int(pres[i].budget_rows) for i in uniq_ids)
    if idx_src is not None:
        from ..core.types import bucket_rows

        plan_of = dict(zip(uniq_ids, plans))
        demand = max(
            _fp.estimate_pool_demand_rows(
                plan_of[int(t)], stack[int(s)], num_valid=int(counts[int(s)])
            )
            for s, t in zip(idx_src, idx_tgt)
        )
        budget_rows = max(
            budget_rows, bucket_rows(int(1.25 * demand), step_bits=3)
        )
    return {
        "pool_xyz": pool_xyz,
        "pool_idx": pool_idx,
        "width_lut": jnp.stack([r.width_lut for r in rows]),
        "lut_d": jnp.stack([r.lut_d for r in rows]),
        "origin_d": jnp.stack([r.origin_d for r in rows]),
        "dims_d": jnp.stack([r.dims_d for r in rows]),
        "class_widths": first.class_widths,
        "class_ends": first.class_ends,
        "class_budgets": tuple(
            int(max(pres[i].class_budgets[c] for i in uniq_ids))
            for c in range(n_classes)
        ),
        "budget_rows": budget_rows,
        "select_max_w": first.select_max_w,
    }


def run_odometry_batched(
    scans,
    *,
    k: int = 20,
    radius: float = 1.0,
    lm_config: LMConfig = LMConfig(),
    n_outer: int = 10,
    pad_multiple: int = 1024,
    mesh: jax.sharding.Mesh | None = None,
    dtype=jnp.float32,
    search_impl: str = "auto",
    cost_drop_thresh: float = -1.0,
    n_cost_drop_it: int = 5,
):
    """Whole-sequence odometry in one (optionally sharded) device program.

    Args:
      scans: list of (n_i, 3) numpy arrays.
      mesh: when given, the pair axis is sharded over its "points" axis
        (pairs padded up to a multiple of the axis size with dummy entries).
      search_impl: "auto" (the backend's engine for the platform: the
        POOLED engine when every pair supports it, else grid)
        | "pool" | "grid" | "brute". Pooled
        pairs whose runtime budget flag fires are automatically redone on
        the batched grid engine and spliced back.
      cost_drop_thresh / n_cost_drop_it: per-pair convergence rule
        (threshold < 0 = fixed n_outer iterations).

    Returns (poses [len(scans) x 4x4 numpy], BatchedPairResult).
    """
    from ..core.se3 import np_quat_to_matrix
    from ..core.types import pad_cloud

    n_scans = len(scans)
    if n_scans < 2:
        return [np.eye(4) for _ in range(n_scans)], None
    n_max = max(s.shape[0] for s in scans)
    padded, valids = [], []
    for s in scans:
        p, n = pad_cloud(np.asarray(s, np.float64), pad_multiple, pad_value=0.0)
        if p.shape[0] < ((n_max + pad_multiple - 1) // pad_multiple) * pad_multiple:
            full = np.zeros(
                (((n_max + pad_multiple - 1) // pad_multiple) * pad_multiple, 3)
            )
            full[: p.shape[0]] = p
            p = full
        padded.append(p)
        valids.append(n)
    stack = np.stack(padded)
    counts = np.asarray(valids)

    b = n_scans - 1
    b_pad = b
    if mesh is not None:
        d = mesh.shape["points"]
        b_pad = ((b + d - 1) // d) * d
    idx_src = np.minimum(np.arange(b_pad) + 1, n_scans - 1)
    idx_tgt = np.minimum(np.arange(b_pad), n_scans - 1)

    row = np.arange(stack.shape[1])
    sources = jnp.asarray(stack[idx_src], dtype)
    sv = jnp.asarray(row[None, :] < counts[idx_src, None])
    # The (B, N, 3) target stack uploads only for the grid/brute engines —
    # the pooled path's kernel emits the selected neighbors' coordinates
    # and never reads the target clouds (GB-class dead upload at LiDAR
    # batch scale otherwise; cf. the single-pair lazy grid upload).
    mk_targets = lambda: jnp.asarray(stack[idx_tgt], dtype)
    mk_tv = lambda: jnp.asarray(row[None, :] < counts[idx_tgt, None])

    pools = None
    if search_impl == "pool" or (
        search_impl == "auto" and _auto_pool(stack[0], int(counts[0]), radius)
    ):
        pools = _batched_pools_host(
            stack, counts, idx_tgt, radius, dtype, idx_src=idx_src
        )
        if pools is None and search_impl == "pool":
            raise ValueError(
                "pool engine requested but some pair declines it"
            )
    if pools is not None:
        from ..core.types import round_up
        from ..ops.fused_grid import BLOCK_GROUPS, GROUP

        n_rows = sources.shape[1]
        budget = round_up(
            max(pools["budget_rows"], n_rows + 4096), 2 * BLOCK_GROUPS * GROUP
        )
        budgets = pools["class_budgets"][:-1] + (budget // GROUP,)
        arrays = (
            sources, sv, pools["pool_xyz"], pools["pool_idx"],
            pools["width_lut"], pools["lut_d"],
            pools["origin_d"], pools["dims_d"],
        )
        if mesh is not None:
            arrays = shard_batch(arrays, mesh)
        result = batched_pair_register_pool(
            *arrays,
            k=k, radius=radius, lm_config=lm_config, n_outer=n_outer,
            class_widths=pools["class_widths"],
            class_ends=pools["class_ends"], class_budgets=budgets,
            budget_rows=budget,
            select_max_w=pools["select_max_w"],
            cost_drop_thresh=cost_drop_thresh,
            n_cost_drop_it=n_cost_drop_it,
        )
        bad = np.flatnonzero(np.asarray(result.overflow) > 0)
        if bad.size:
            # The runtime budget flag fired for these pairs — their results
            # are invalid; redo them on the batched grid engine and splice
            # (the batched analogue of the single-pair mid-pair fallback).
            sub_tgt = idx_tgt[bad]
            sub = _batched_grids_host(stack, counts, sub_tgt, radius)
            if sub is None:
                raise RuntimeError(
                    "pooled budget overflow and no grid fallback available"
                )
            bp, bi, luts, origins, dims_, cap = sub
            redo = batched_pair_register_grid(
                jnp.asarray(stack[idx_src[bad]], dtype),
                jnp.asarray(stack[sub_tgt], dtype),
                jnp.asarray(row[None, :] < counts[idx_src[bad], None]),
                jnp.asarray(bp, dtype), jnp.asarray(bi), jnp.asarray(luts),
                jnp.asarray(origins, dtype), jnp.asarray(dims_),
                k=k, radius=radius, lm_config=lm_config, n_outer=n_outer,
                capacity=cap, cost_drop_thresh=cost_drop_thresh,
                n_cost_drop_it=n_cost_drop_it,
            )
            merged = {}
            for name in BatchedPairResult._fields:
                if name == "overflow":
                    # Keep the pooled flags: nonzero now reads as "this
                    # pair was redone on the grid engine" (results valid).
                    merged[name] = np.asarray(result.overflow)
                    continue
                full = np.array(getattr(result, name))  # writable copy
                part = np.asarray(getattr(redo, name))
                full[bad] = part
                merged[name] = full
            result = BatchedPairResult(**merged)
    else:
        grids = None
        if search_impl in ("auto", "grid"):
            grids = _batched_grids_host(stack, counts, idx_tgt, radius)
            if grids is None and search_impl == "grid":
                raise ValueError(
                    "grid engine requested but some pair has no grid"
                )

    if pools is None and grids is not None:
        bp, bi, luts, origins, dims, cap = grids
        arrays = (
            sources, mk_targets(), sv,
            jnp.asarray(bp, dtype), jnp.asarray(bi), jnp.asarray(luts),
            jnp.asarray(origins, dtype), jnp.asarray(dims),
        )
        if mesh is not None:
            arrays = shard_batch(arrays, mesh)
        result = batched_pair_register_grid(
            *arrays,
            k=k, radius=radius, lm_config=lm_config, n_outer=n_outer,
            capacity=cap, cost_drop_thresh=cost_drop_thresh,
            n_cost_drop_it=n_cost_drop_it,
        )
    elif pools is None:
        arrays = (sources, mk_targets(), sv, mk_tv())
        if mesh is not None:
            arrays = shard_batch(arrays, mesh)
        result = batched_pair_register(
            *arrays,
            k=k, radius=radius, lm_config=lm_config, n_outer=n_outer,
            cost_drop_thresh=cost_drop_thresh, n_cost_drop_it=n_cost_drop_it,
        )

    qs = np.asarray(result.q, np.float64)
    ts = np.asarray(result.t, np.float64)
    poses = [np.eye(4)]
    for pair in range(b):
        rel = np.eye(4)
        q = qs[pair] / np.linalg.norm(qs[pair])
        rel[:3, :3] = np_quat_to_matrix(q)
        rel[:3, 3] = ts[pair]
        poses.append(poses[-1] @ rel)
    return poses, result
