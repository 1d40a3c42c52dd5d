"""Target-sharded HASH-GRID search + the full sharded outer step.

Round-1's sharded step (parallel/distributed.py) used the brute-force
streaming engine; the production single-device engine is the hash grid
(ops/grid.py). This module shards *that* engine so multi-device execution
composes with single-device performance claims:

  * Target rows are dealt round-robin over the ``"targets"`` mesh axis, so
    every shard sees ~1/T of the density in the SAME spatial cells. Each
    device builds a local sub-grid with the GLOBAL origin/dims/cell-size and
    a capacity quantized from the max local occupancy — per-device candidate
    width (27 * capacity_local) genuinely shrinks ~T-fold vs the global grid
    (real work scaling, unlike spatial slabs which keep local density
    unchanged).
  * ``bucket_idx`` stores GLOBAL target row ids, so per-shard results need no
    re-indexing before the all-gather top-k merge (the same merge as
    parallel/search.py); merged candidate coordinates travel with the merge,
    so no device ever materializes the full target cloud.
  * Source rows shard over ``"points"``; the EM-LM normal equations reduce
    with psum over that axis exactly as in parallel/distributed.py.

Replaces the reference's per-iteration FLANN kd-tree rebuild + query loop
(src/prob_point_cloud_registration.cc:66-81) at multi-device scale.
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
from ..ops.grid import _quantize_capacity
from .mesh import POINTS_AXIS, TARGETS_AXIS, all_gather_replicated, supports_structural_replication

_INT32_MAX = 2**31 - 1


class ShardedGrid(NamedTuple):
    """Host-side sharded grid arrays (leading axis = T * per-shard rows).

    Ship to device with a sharding that splits axis 0 over ``"targets"``.
    """

    bucket_pts: np.ndarray  # (T * U_max, capacity, 3)
    bucket_idx: np.ndarray  # (T * U_max, capacity) global target rows; -1 pad
    lut: np.ndarray  # (T * dims_prod,) linear cell -> local bucket row
    origin: np.ndarray  # (3,) global
    dims: np.ndarray  # (3,) int32 global
    capacity: int  # max over shards (static)
    u_max: int  # padded per-shard occupied-cell count (static)
    cell_size: float
    n_shards: int


def build_sharded_grid_host(
    target: np.ndarray, cell_size: float, n_shards: int, *, num_valid: int | None = None
) -> ShardedGrid | None:
    """Deal target rows round-robin into ``n_shards`` sub-grids (numpy only).

    Returns None under the same conditions as ops.grid.build_grid_host, or
    when the dense LUT would not fit (the sharded engine requires the LUT:
    searchsorted is too slow a fallback on the hot path).
    """
    target = np.asarray(target, dtype=np.float64)
    n = num_valid if num_valid is not None else target.shape[0]
    if n == 0 or cell_size <= 0 or not np.isfinite(cell_size):
        return None
    pts = target[:n]
    origin = pts.min(axis=0)
    ijk = np.floor((pts - origin) / cell_size).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    dims_prod = int(dims[0]) * int(dims[1]) * int(dims[2])
    if dims_prod >= _INT32_MAX or dims_prod > (1 << 25) // max(n_shards, 1):
        return None
    lin = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])

    shard_of = np.arange(n) % n_shards
    per_shard = []
    u_max, cap_max = 1, 1
    for s in range(n_shards):
        rows = np.nonzero(shard_of == s)[0]
        lin_s = lin[rows]
        order = np.argsort(lin_s, kind="stable")
        cells, start, counts = np.unique(
            lin_s[order], return_index=True, return_counts=True
        )
        per_shard.append((rows, order, cells, start, counts))
        u_max = max(u_max, len(cells))
        cap_max = max(cap_max, int(counts.max()) if counts.size else 1)
    capacity = _quantize_capacity(cap_max)

    bucket_pts = np.zeros((n_shards, u_max, capacity, 3), dtype=np.float64)
    bucket_idx = np.full((n_shards, u_max, capacity), -1, dtype=np.int32)
    lut = np.full((n_shards, dims_prod), -1, dtype=np.int32)
    for s, (rows, order, cells, start, counts) in enumerate(per_shard):
        if not len(cells):
            continue
        lin_sorted = lin[rows][order]
        cell_row = np.searchsorted(cells, lin_sorted)
        slot = np.arange(len(rows)) - start[cell_row]
        bucket_idx[s, cell_row, slot] = rows[order].astype(np.int32)
        bucket_pts[s, cell_row, slot] = pts[rows[order]]
        lut[s, cells] = np.arange(len(cells), dtype=np.int32)

    return ShardedGrid(
        bucket_pts=bucket_pts.reshape(n_shards * u_max, capacity, 3),
        bucket_idx=bucket_idx.reshape(n_shards * u_max, capacity),
        lut=lut.reshape(n_shards * dims_prod),
        origin=origin,
        dims=dims.astype(np.int32),
        capacity=capacity,
        u_max=u_max,
        cell_size=float(cell_size),
        n_shards=n_shards,
    )


def merge_topk_tree(local_d, local_i, local_p=None, *, k: int,
                    axis_name: str):
    """Butterfly top-k combine over ``axis_name``: O(k log T) payload.

    The all-gather merge ships every shard's (N, k) candidates to every
    device — payload grows LINEARLY in shard count (4.9 -> 39.3 MB per
    iteration at 1 -> 8 shards on the 35k pair) and every
    device then re-reduces the full (N, T*k) matrix. This recursive-halving
    butterfly exchanges (N, k) lists with the rank XOR 2^s partner at each
    of log2(T) stages and k-merges locally, so the per-device payload is
    O(N * k * log T) and the reduction work O(N * k * log T) — every device
    ends with the identical global top-k (a standard all-reduce butterfly,
    so the outputs are replicated along the axis).

    Tie semantics: each merge orders the lower-rank half first, so exact
    distance ties resolve by a tournament shard order — the same
    within-tie-class caveat as the all-gather merge (ops/neighbors.py:16);
    neighbor SETS are identical whenever the k-th distance is unique.

    Requires a power-of-two axis size (callers fall back to
    :func:`merge_topk` otherwise). ``local_d`` must already carry +inf in
    unfound slots.
    """
    t = lax.axis_size(axis_name)
    assert t & (t - 1) == 0, "butterfly merge needs a pow2 axis"
    idx = lax.axis_index(axis_name)
    d, i, p = local_d, local_i, local_p
    stage = 1
    while stage < t:
        perm = [(j, j ^ stage) for j in range(t)]
        od = lax.ppermute(d, axis_name, perm)
        oi = lax.ppermute(i, axis_name, perm)
        low_first = (idx & stage) == 0
        cat_d = jnp.where(
            low_first,
            jnp.concatenate([d, od], axis=1),
            jnp.concatenate([od, d], axis=1),
        )
        cat_i = jnp.where(
            low_first,
            jnp.concatenate([i, oi], axis=1),
            jnp.concatenate([oi, i], axis=1),
        )
        neg, args = lax.top_k(-cat_d, k)
        d = -neg
        i = jnp.take_along_axis(cat_i, args, axis=1)
        if p is not None:
            op = lax.ppermute(p, axis_name, perm)
            cat_p = jnp.where(
                low_first[..., None],
                jnp.concatenate([p, op], axis=1),
                jnp.concatenate([op, p], axis=1),
            )
            p = jnp.take_along_axis(cat_p, args[..., None], axis=1)
        stage <<= 1
    found = jnp.isfinite(d)
    i = jnp.where(found, i, 0)
    if p is None:
        return i, d, found
    return i, d, found, p


def merge_topk_scatter(local_d, local_i, local_p, *, k: int,
                       axis_name: str):
    """Recursive-halving REDUCE-SCATTER top-k over ``axis_name``.

    The gather/tree merges leave every device holding the full (N, k)
    merged list — but the downstream EM-LM solve is points-sharded, so a
    targets-row's tp devices then all solve the SAME rows redundantly.
    This combine instead halves the owned source range at each of
    log2(T) stages (exchange the half your partner owns, k-merge what you
    received into the half you keep), so device r of the targets axis ends
    owning block r of N/T rows, FULLY merged — and the solve can shard
    over BOTH mesh axes (psum over ("points", "targets")): merge traffic
    drops to ~contrib bytes total (vs contrib x log2 T for the tree,
    contrib x (T-1) for the ring all-gather) and solve FLOPs divide by T.

    Tie semantics: each pairwise merge orders the lower-rank shard's
    candidates first — the same tournament tie class as merge_topk_tree.

    Requires a pow2 axis size and N divisible by T. Returns
    (best_i, best_d, found, best_p, row_offset) where the first four are
    (N/T, k) for rows [row_offset, row_offset + N/T) of the caller's local
    source slice.
    """
    t = lax.axis_size(axis_name)
    assert t & (t - 1) == 0, "reduce-scatter merge needs a pow2 axis"
    n = local_d.shape[0]
    assert n % t == 0, "rows must divide the targets axis"
    idx = lax.axis_index(axis_name)
    d, i, p = local_d, local_i, local_p
    stages = t.bit_length() - 1
    for s in range(stages):
        bit_pos = stages - 1 - s
        bit = 1 << bit_pos
        half = d.shape[0] // 2
        keep_low = (idx >> bit_pos) & 1 == 0
        perm = [(j, j ^ bit) for j in range(t)]

        def split(x):
            return x[:half], x[half:]

        dl, dh = split(d)
        il, ih = split(i)
        send_d = jnp.where(keep_low, dh, dl)
        send_i = jnp.where(keep_low, ih, il)
        od = lax.ppermute(send_d, axis_name, perm)
        oi = lax.ppermute(send_i, axis_name, perm)
        keep_d = jnp.where(keep_low, dl, dh)
        keep_i = jnp.where(keep_low, il, ih)
        # Lower rank's candidates first (tournament tie order): my kept
        # half is mine (rank idx); the received half is the partner's
        # (idx ^ bit). keep_low <=> partner rank is higher.
        cat_d = jnp.where(
            keep_low,
            jnp.concatenate([keep_d, od], axis=1),
            jnp.concatenate([od, keep_d], axis=1),
        )
        cat_i = jnp.where(
            keep_low,
            jnp.concatenate([keep_i, oi], axis=1),
            jnp.concatenate([oi, keep_i], axis=1),
        )
        neg, args = lax.top_k(-cat_d, k)
        d = -neg
        i = jnp.take_along_axis(cat_i, args, axis=1)
        if p is not None:
            pl_, ph_ = split(p)
            send_p = jnp.where(keep_low[..., None], ph_, pl_)
            op = lax.ppermute(send_p, axis_name, perm)
            keep_p = jnp.where(keep_low[..., None], pl_, ph_)
            cat_p = jnp.where(
                keep_low[..., None],
                jnp.concatenate([keep_p, op], axis=1),
                jnp.concatenate([op, keep_p], axis=1),
            )
            p = jnp.take_along_axis(cat_p, args[..., None], axis=1)
    found = jnp.isfinite(d)
    i = jnp.where(found, i, 0)
    row_offset = idx * (n // t)
    if p is None:
        return i, d, found, None, row_offset
    return i, d, found, p, row_offset


def sharded_merge_topk(local_d, local_i, local_p=None, *, k: int,
                       axis_name: str, tree: bool | None = None):
    """Merge per-shard top-k candidate lists into the global (N, k) best.

    Dispatches to the butterfly combine (O(k log T) payload) on pow2 axis
    sizes, the all-gather merge otherwise; ``tree`` forces one of them.
    Outputs are replicated along ``axis_name`` either way.
    """
    t = lax.axis_size(axis_name)
    if tree is None:
        tree = t & (t - 1) == 0 and t > 1
    if tree:
        return merge_topk_tree(
            local_d, local_i, local_p, k=k, axis_name=axis_name
        )
    from .mesh import all_gather_replicated

    all_d = all_gather_replicated(local_d, axis_name)
    all_i = all_gather_replicated(local_i, axis_name)
    all_p = (
        None if local_p is None
        else all_gather_replicated(local_p, axis_name)
    )
    return merge_topk(all_d, all_i, all_p, k=k)


def merge_topk(all_d, all_i, all_p=None, *, k: int):
    """Merge (D, N, k) per-shard candidate sets into the global (N, k) best.

    Ties across shards resolve by shard order then slot order — the same
    deterministic ordering a single device's candidate enumeration yields.
    """
    d, n, _ = all_d.shape
    cand_d = jnp.moveaxis(all_d, 0, 1).reshape(n, d * k)
    cand_i = jnp.moveaxis(all_i, 0, 1).reshape(n, d * k)
    neg_best, args = lax.top_k(-cand_d, k)
    best_d = -neg_best
    best_i = jnp.take_along_axis(cand_i, args, axis=1)
    found = jnp.isfinite(best_d)
    best_i = jnp.where(found, best_i, 0)
    if all_p is None:
        return best_i, best_d, found
    cand_p = jnp.moveaxis(all_p, 0, 1).reshape(n, d * k, 3)
    best_p = jnp.take_along_axis(cand_p, args[..., None], axis=1)
    return best_i, best_d, found, best_p


class ShardedGridStepResult(NamedTuple):
    result: LMResult
    num_correspondences: jnp.ndarray


def make_sharded_grid_registration_step(
    mesh: jax.sharding.Mesh,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    capacity: int,
    source_tile: int = 4096,
    tree_merge: bool = False,
):
    """Jitted full outer iteration with the grid engine over a 2D mesh.

    Call with device arrays laid out per :class:`ShardedGrid` (axis 0 sharded
    over ``"targets"``), source rows sharded over ``"points"``:

      step(fs, sv, bucket_pts, bucket_idx, lut, origin, dims,
           q_cum, t_cum, q0, t0) -> ShardedGridStepResult
    """
    P = jax.sharding.PartitionSpec
    cfg = lm_config._replace(axis_name=POINTS_AXIS)

    def body(fs, sv, bucket_pts, bucket_idx, lut, origin, dims, q_cum, t_cum, q0, t0):
        from ..ops.grid import grid_radius_search

        moved = quat_rotate_points(q_cum, fs) + t_cum
        corr, pts = grid_radius_search(
            moved,
            bucket_pts,
            bucket_idx,
            jnp.zeros((bucket_pts.shape[0],), jnp.int32),  # cell_ids unused (LUT path)
            origin,
            dims,
            lut,
            k=k,
            radius=radius,
            capacity=capacity,
            source_valid=sv,
            source_tile=source_tile,
            return_points=True,
        )
        local_d = jnp.where(corr.mask, corr.sq_dists, jnp.inf)
        best_i, best_d, found, best_p = sharded_merge_topk(
            local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS,
            tree=True if tree_merge else False,
        )
        result = em_lm_solve(moved, best_p, found, q0, t0, cfg)
        n_corr = lax.psum(jnp.sum(found.astype(jnp.int32)), POINTS_AXIS)
        return ShardedGridStepResult(result=result, num_correspondences=n_corr)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(POINTS_AXIS),  # source rows
            P(POINTS_AXIS),  # source validity
            P(TARGETS_AXIS),  # bucket_pts rows
            P(TARGETS_AXIS),  # bucket_idx rows
            P(TARGETS_AXIS),  # per-shard LUT rows
            P(),  # origin
            P(),  # dims
            P(),
            P(),
            P(),
            P(),
        ),
        out_specs=ShardedGridStepResult(
            result=LMResult(q=P(), t=P(), initial_cost=P(), final_cost=P(),
                            num_iterations=P(), num_successful_steps=P(),
                            trace=P()),
            num_correspondences=P(),
        ),
        # Merge outputs are replicated along "targets" and psum-reduced
        # along "points". With the all-gather merge (default) this is
        # statically provable (all_gather_invariant -> check_vma on); the
        # butterfly tree merge's replication is a value property the vma
        # type system cannot express through ppermute, so tree_merge=True
        # drops to runtime assertion (tests/test_grid_sharded.py parity +
        # the align scan's debug_replication check).
        check_vma=(not tree_merge) and supports_structural_replication(),
    )
    return jax.jit(sharded)


def make_sharded_grid_align_scan(
    mesh: jax.sharding.Mesh,
    *,
    k: int,
    radius: float,
    lm_config: LMConfig,
    capacity: int,
    chunk: int,
    n_iter: int,
    cost_drop_thresh: float,
    n_cost_drop_it: int,
    source_tile: int = 4096,
    debug_replication: bool = False,
):
    """Up to ``chunk`` sharded GRID outer iterations in one device program
    with the on-device stopping rule — the multi-device fallback scan of
    :class:`parallel.align.DistributedRegistration` (engaged when the
    pooled engine's row budget overflows past its escalation ladder), and
    the grid-engine analogue of make_sharded_pool_align_scan.

    Returns scan(fs, sv, bucket_pts, bucket_idx, lut, origin, dims, q_cum,
    t_cum, q0, t0, drop0, unuseful0, it0) -> the per-slot tuple of
    models.registration._scan_convergence outputs (without an overflow
    column — the grid engine has no budget), every output replicated.
    """
    from ..models.registration import _scan_convergence

    P = jax.sharding.PartitionSpec
    cfg = lm_config._replace(axis_name=POINTS_AXIS)

    def body(fs, sv, bucket_pts, bucket_idx, lut, origin, dims, q_cum,
             t_cum, q0, t0, drop0, unuseful0, it0):
        from ..ops.grid import grid_radius_search

        def compute(qc, tc):
            moved = quat_rotate_points(qc, fs) + tc
            corr, pts = grid_radius_search(
                moved,
                bucket_pts,
                bucket_idx,
                jnp.zeros((bucket_pts.shape[0],), jnp.int32),
                origin,
                dims,
                lut,
                k=k,
                radius=radius,
                capacity=capacity,
                source_valid=sv,
                source_tile=source_tile,
                return_points=True,
            )
            local_d = jnp.where(corr.mask, corr.sq_dists, jnp.inf)
            best_i, best_d, found, best_p = sharded_merge_topk(
                local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS
            )
            res = em_lm_solve(moved, best_p, found, q0, t0, cfg)
            q_out = res.q
            if debug_replication:
                # Runtime replication assert on the merged distances, the
                # same belt-and-braces check the pooled scan carries (here
                # the all-gather merge's replication is ALSO statically
                # proven via check_vma below when the jax provides
                # all_gather_invariant).
                fin = jnp.where(found, best_d, 0.0)
                dev = jnp.max(jnp.abs(fin - lax.pmean(fin, TARGETS_AXIS)))
                q_out = q_out + jnp.where(dev == 0, 0.0, jnp.nan).astype(
                    q_out.dtype
                )
            n_corr = lax.psum(jnp.sum(found.astype(jnp.int32)), POINTS_AXIS)
            return (
                q_out,
                res.t,
                res.initial_cost,
                res.final_cost,
                res.num_iterations,
                res.num_successful_steps,
                n_corr,
                res.trace,
            )

        return _scan_convergence(
            compute, q_cum, t_cum, drop0, unuseful0, it0, chunk=chunk,
            n_iter=n_iter, cost_drop_thresh=cost_drop_thresh,
            n_cost_drop_it=n_cost_drop_it,
        )

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(POINTS_AXIS),
            P(POINTS_AXIS),
            P(TARGETS_AXIS),
            P(TARGETS_AXIS),
            P(TARGETS_AXIS),
            P(), P(), P(), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=(P(),) * 9,
        # Statically provable like the step factory above: the all-gather
        # merge uses all_gather_invariant where available, and nothing in
        # the grid path hides vma from the checker (no Pallas inside).
        check_vma=supports_structural_replication(),
    )
    return jax.jit(sharded)
