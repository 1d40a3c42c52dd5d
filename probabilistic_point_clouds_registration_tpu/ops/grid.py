"""Spatial-hash-grid radius search: the scalable data-association engine.

The reference rebuilds a FLANN kd-tree on the target every outer iteration
(src/prob_point_cloud_registration.cc:66-67) because its *source* moves while
the search structure indexes the *target*. That rebuild is wasted work — the
target never moves. Here the target is bucketed into a voxel grid of cell
size = search radius ONCE per registration (host numpy, ~O(M)); every outer
iteration then queries the static grid entirely on device:

  1. each (moved) source point maps to its cell; its neighbors-in-radius all
     lie in the 3x3x3 cell neighborhood (cell edge = radius),
  2. the 27 neighbor cells resolve to bucket rows via ONE gather into a
     dense linear-cell-id -> bucket lookup table (jnp.searchsorted is the
     fallback for grids too big to materialize densely),
  3. candidate coordinates come from a pre-materialized (U, capacity, 3)
     padded bucket tensor, so the gather moves whole contiguous buckets
     (hundreds of bytes per row) instead of tens of millions of scattered
     12-byte points,
  4. one top_k over (S, 27*capacity) candidates per source block.

Work drops from O(N*M) to O(N * local_density); the brute-force engine in
ops/neighbors.py remains the fallback for tiny clouds, extreme cell
occupancy, or degenerate grids.

Exactness: identical neighbor *sets* to brute force (up to distance ties at
the k-th slot), asserted in tests/test_grid.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import backend
from ..core.types import Correspondences, bucket_rows, pow2, round_up

_INT32_MAX = 2**31 - 1
# Dense cell->bucket LUT cap: 32M cells = 128 MB of int32 on device.
_MAX_DENSE_LUT_CELLS = 1 << 25


class HashGrid(NamedTuple):
    """Static-shape target voxel grid (device arrays; built host-side).

    Attributes:
      bucket_pts: (U, capacity, 3) padded per-cell member coordinates.
      bucket_idx: (U, capacity) original target index per slot; -1 = padding.
      cell_ids: (U,) sorted linear ids of occupied cells (searchsorted
        fallback when ``lut`` is None).
      capacity: static int — quantile-capped cell occupancy, pow2-quantized
        (see _quantize_capacity / the overflow design in build_grid_host).
      origin: (3,) grid origin (min corner of the target bbox).
      dims: (3,) int32 grid dimensions.
      cell_size: float cell edge length (== search radius).
      num_valid: number of real (non-padding) target points.
      lut: (dims prod,) int32 dense linear-cell-id -> occupied-cell row
        (-1 = empty), or None for grids too large to materialize densely.
      overflow_pts / overflow_idx: points of cells hotter than ``capacity``
        ((Op, 3) coords + (Op,) original rows, -1 = padding), searched by a
        streaming brute pass and merged into the top-k; None when empty.
    """

    bucket_pts: jnp.ndarray
    bucket_idx: jnp.ndarray
    cell_ids: jnp.ndarray
    capacity: int
    origin: jnp.ndarray
    dims: jnp.ndarray
    cell_size: float
    num_valid: int
    lut: jnp.ndarray | None
    overflow_pts: jnp.ndarray | None = None
    overflow_idx: jnp.ndarray | None = None


def _quantize_capacity(cap: int) -> int:
    """Bucket capacity for a max cell occupancy of ``cap``: next power of two.

    Pow2 keeps the number of static compile classes small across a
    sequence's scans.
    """
    return max(8, 1 << (cap - 1).bit_length())


def build_grid_host(
    target: np.ndarray,
    cell_size: float,
    *,
    num_valid: int | None = None,
    max_overflow: int = 0,
    buckets: bool = True,
) -> dict | None:
    """Host-side grid build: all-numpy, no device transfers.

    Returns a dict with the :class:`HashGrid` fields (arrays as numpy) so the
    caller can batch the upload with other arrays in one ``jax.device_put``,
    or None when
    a grid would be invalid or useless: degenerate cell size, a grid whose
    linear id overflows int32, or occupancy so high that 27 * capacity >= M
    (brute force is cheaper).

    ``max_overflow`` > 0 enables quantile capacity: instead of padding every
    bucket to the HOTTEST cell's occupancy (a single near-sensor LiDAR cell
    with ~300 returns would force capacity 512 and a 13k-wide candidate
    window for every source), capacity is the smallest power of two whose
    clipped-out points number at most ``max_overflow``; those points land in
    ``overflow_pts``/``overflow_idx`` and the search engines merge them back
    through a streaming brute pass (ops.grid.merge_overflow) — identical
    neighbor sets, bounded window width.

    ``buckets=False`` skips the (U, capacity[, 3]) bucket tensors, the
    overflow split, and the dense LUT — the allocation-heavy half of the
    build that only the XLA grid/dense-fused engines read. The pooled
    engine consumes just the cell-sorted view (sort_order / cell_start /
    cell_count), so pooled-pair prep passes False (~half the KITTI-scale
    host build); :func:`add_buckets_host` fills the skipped fields in
    place if a fallback engine later needs them.
    """
    target = np.asarray(target, dtype=np.float64)
    m_total = target.shape[0]
    n = num_valid if num_valid is not None else m_total
    if n == 0 or cell_size <= 0 or not np.isfinite(cell_size):
        return None
    pts = target[:n]

    origin = pts.min(axis=0)
    ijk = np.floor((pts - origin) / cell_size).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    if int(dims[0]) * int(dims[1]) * int(dims[2]) >= _INT32_MAX:
        return None
    lin = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])

    order = np.argsort(lin, kind="stable")
    lin_sorted = lin[order]
    cell_ids, start, counts = np.unique(
        lin_sorted, return_index=True, return_counts=True
    )
    capacity = _quantize_capacity(int(counts.max()))
    if max_overflow > 0:
        # Engage the overflow cap only under pathological occupancy skew —
        # when the hottest cell is far beyond the p99 occupancy (near-sensor
        # LiDAR blobs) or the max-occupancy capacity would fail the
        # profitability check outright. A healthy grid keeps full capacity
        # and pays no per-iteration overflow merge.
        hot_cap = _quantize_capacity(int(np.ceil(8 * np.percentile(counts, 99))))
        if capacity > hot_cap or 27 * capacity >= max(n, 1):
            cap = 8
            while cap < capacity and np.maximum(counts - cap, 0).sum() > max_overflow:
                cap *= 2
            capacity = min(cap, capacity)
    if 27 * capacity >= max(n, 1):
        return None  # occupancy too high for the grid to pay off

    u = cell_ids.shape[0]
    # Bucketed occupied-cell count: the (U, capacity[, 3]) tensors key every
    # jitted search/chunk program by SHAPE, so a scan sequence with a
    # data-exact U recompiles per pair. Pad rows are empty cells (idx -1,
    # cell id = dims_prod — one past any real id, never matched by a lut
    # lookup); "num_cells" carries the real count for host-side consumers
    # (dilation must not decode the sentinel ids).
    dims_prod = int(dims[0]) * int(dims[1]) * int(dims[2])
    u_pad = bucket_rows(u)
    cell_ids_pad = np.full((u_pad,), dims_prod, dtype=np.int32)
    cell_ids_pad[:u] = cell_ids
    start_pad = np.full((u_pad,), n, dtype=np.int32)
    start_pad[:u] = start
    counts_pad_arr = np.zeros((u_pad,), dtype=np.int32)
    counts_pad_arr[:u] = counts
    out = {
        "cell_ids": cell_ids_pad,
        "num_cells": u,
        "capacity": capacity,
        "origin": origin,
        "dims": dims.astype(np.int32),
        "cell_size": float(cell_size),
        "num_valid": n,
        # Cell-sorted view of the target (order = stable sort by linear cell
        # id, so within-cell order == bucket slot order): the capacity-free
        # pool engine (ops/fused_pool.py) packs per-window candidate lists
        # straight out of contiguous [start, start+count) ranges of it.
        "sort_order": order.astype(np.int32),
        "cell_start": start_pad,
        "cell_count": counts_pad_arr,
        "_target_dtype": target.dtype,
    }
    if buckets:
        add_buckets_host(out, target)
    return out


def add_buckets_host(grid: dict, target: np.ndarray) -> dict:
    """Materialize the bucket tensors / overflow split / dense LUT a
    ``buckets=False`` build skipped (in place; idempotent).

    Called when a pooled pair falls back to the XLA grid or dense fused
    engine (models/registration._ensure_grid_device) — the rare path pays
    the allocation-heavy half of the build, not every pooled pair.
    """
    if "bucket_idx" in grid:
        return grid
    target = np.asarray(target, dtype=grid.get("_target_dtype", np.float64))
    n = grid["num_valid"]
    pts = target[:n]
    u = grid["num_cells"]
    u_pad = grid["cell_ids"].shape[0]
    capacity = grid["capacity"]
    order = grid["sort_order"]
    start = grid["cell_start"][:u].astype(np.int64)
    counts = grid["cell_count"][:u].astype(np.int64)
    dims = grid["dims"].astype(np.int64)
    dims_prod = int(dims[0]) * int(dims[1]) * int(dims[2])
    cell_ids = grid["cell_ids"][:u]

    # Points past ``capacity`` within their cell become overflow.
    cell_row = np.repeat(np.arange(u), counts)
    slot_of = np.arange(n) - np.repeat(start, counts)
    in_cap = slot_of < capacity
    bucket_idx = np.full((u_pad, capacity), -1, dtype=np.int32)
    bucket_idx[cell_row[in_cap], slot_of[in_cap]] = order[in_cap].astype(
        np.int32
    )
    bucket_pts = np.zeros((u_pad, capacity, 3), dtype=target.dtype)
    live = bucket_idx >= 0
    bucket_pts[live] = pts[bucket_idx[live]]
    grid["bucket_pts"] = bucket_pts
    grid["bucket_idx"] = bucket_idx
    n_over = int((~in_cap).sum())
    if n_over:
        op = round_up(n_over, 128)
        ov_rows = order[~in_cap]
        overflow_idx = np.full((op,), -1, dtype=np.int32)
        overflow_idx[:n_over] = ov_rows.astype(np.int32)
        overflow_pts = np.zeros((op, 3), dtype=target.dtype)
        overflow_pts[:n_over] = pts[ov_rows]
        grid["overflow_pts"] = overflow_pts
        grid["overflow_idx"] = overflow_idx
    if dims_prod <= _MAX_DENSE_LUT_CELLS:
        # Pow2-padded length: the LUT's shape keys the jitted search too.
        lut_np = np.full((pow2(dims_prod),), -1, dtype=np.int32)
        lut_np[cell_ids] = np.arange(u, dtype=np.int32)
        grid["lut"] = lut_np
    return grid


def build_grid(
    target: np.ndarray,
    cell_size: float,
    *,
    num_valid: int | None = None,
    max_overflow: int = 0,
):
    """Build a :class:`HashGrid` (device arrays) over the target cloud.

    See :func:`build_grid_host` for the build itself and the None conditions.
    """
    g = build_grid_host(
        target, cell_size, num_valid=num_valid, max_overflow=max_overflow
    )
    if g is None:
        return None
    return HashGrid(
        bucket_pts=jnp.asarray(g["bucket_pts"]),
        bucket_idx=jnp.asarray(g["bucket_idx"]),
        cell_ids=jnp.asarray(g["cell_ids"]),
        capacity=g["capacity"],
        origin=jnp.asarray(g["origin"]),
        dims=jnp.asarray(g["dims"]),
        cell_size=g["cell_size"],
        num_valid=g["num_valid"],
        lut=jnp.asarray(g["lut"]) if "lut" in g else None,
        overflow_pts=jnp.asarray(g["overflow_pts"]) if "overflow_pts" in g else None,
        overflow_idx=jnp.asarray(g["overflow_idx"]) if "overflow_idx" in g else None,
    )


def merge_overflow(
    corr: Correspondences,
    source,
    overflow_pts,
    overflow_idx,
    *,
    k: int,
    radius: float,
    source_valid,
):
    """Merge hot-cell overflow candidates into grid search results.

    Runs the streaming brute engine over the (small, padded) overflow set and
    re-selects the global k best per source. Exact: grid buckets + overflow
    partition the target, so the union of candidate sets equals the brute
    engine's (ties at the k-th slot resolve in merge order, within the
    tie-class invariant of tests/test_tie_sensitivity.py).
    """
    from .neighbors import topk_neighbors

    op = overflow_pts.shape[0]
    ko = min(k, op)
    # exact=True: direct-difference distances. The matmul expansion's f32
    # cancellation error (~eps * coordinate^2) mis-SELECTS candidates at
    # LiDAR coordinate scales — every other candidate source in this merge
    # (grid buckets) is computed from exact differences, so the overflow
    # side must be too or the merge silently drops true neighbors.
    ov_idx_local, ov_d2, ov_found = topk_neighbors(
        source,
        overflow_pts,
        k=ko,
        source_valid=source_valid,
        target_valid=overflow_idx >= 0,
        source_tile=4096,
        target_tile=min(2048, op),
        exact=True,
    )
    r2 = jnp.asarray(radius, ov_d2.dtype) ** 2
    ov_found &= ov_d2 <= r2
    ov_rows = jnp.where(ov_found, overflow_idx[ov_idx_local], 0)

    cand_d = jnp.concatenate(
        [
            jnp.where(corr.mask, corr.sq_dists, jnp.inf),
            jnp.where(ov_found, ov_d2, jnp.inf).astype(corr.sq_dists.dtype),
        ],
        axis=1,
    )
    cand_i = jnp.concatenate([corr.indices, ov_rows], axis=1)
    neg_best, args = lax.top_k(-cand_d, k)
    best_d = -neg_best
    best_i = jnp.take_along_axis(cand_i, args, axis=1)
    found = jnp.isfinite(best_d)
    return Correspondences(
        indices=jnp.where(found, best_i, 0),
        sq_dists=jnp.where(found, best_d, 0.0),
        mask=found,
    )


_NEIGHBOR_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
).reshape(27, 3)


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "capacity", "source_tile", "select_impl", "return_points"
    ),
)
def grid_radius_search(
    source: jnp.ndarray,
    bucket_pts: jnp.ndarray,
    bucket_idx: jnp.ndarray,
    cell_ids: jnp.ndarray,
    origin: jnp.ndarray,
    dims: jnp.ndarray,
    lut: jnp.ndarray | None,
    *,
    k: int,
    radius: float,
    capacity: int,
    source_valid: jnp.ndarray,
    source_tile: int = 4096,
    select_impl: str = "auto",
    return_points: bool = False,
):
    """Radius-capped KNN against a prebuilt target grid.

    Same contract as ops.neighbors.radius_search: (N, k) original-target
    indices + squared distances + mask, k nearest within ``radius`` per valid
    source row. Cell edge must equal ``radius``.

    ``select_impl``: "auto" takes the backend's choice for this capacity
    (``backend.grid_select``). Explicit options: "topk" (flat ``lax.top_k``
    over all 27*capacity candidates), "hier" (exact per-cell-then-merge
    two-stage top_k), "approx" (lax.approx_max_k, recall ~0.99 — opt-in
    because neighbor sets then differ from FLANN's by design).

    ``return_points=True`` additionally returns the selected neighbors'
    coordinates (N, k, 3) gathered from the bucket tensor — the sharded
    engine needs them because no single device holds the full target cloud
    to re-gather from (parallel/grid_sharded.py).
    """
    if select_impl == "auto":
        select_impl = backend.grid_select(capacity)
    n = source.shape[0]
    dtype = source.dtype
    u = cell_ids.shape[0]
    cell = jnp.asarray(radius, dtype)
    r2 = jnp.asarray(radius, dtype) ** 2
    offsets = jnp.asarray(_NEIGHBOR_OFFSETS, jnp.int32)

    n_pad = round_up(n, source_tile)
    src = jnp.pad(source, ((0, n_pad - n), (0, 0)))
    sval = jnp.pad(source_valid.astype(bool), (0, n_pad - n))

    def search_block(args):
        s_blk, v_blk = args  # (S, 3), (S,)
        s = s_blk.shape[0]
        ijk = jnp.floor((s_blk - origin.astype(dtype)) / cell).astype(jnp.int32)
        nijk = ijk[:, None, :] + offsets[None, :, :]  # (S, 27, 3)
        in_bounds = jnp.all((nijk >= 0) & (nijk < dims[None, None, :]), axis=-1)
        safe = jnp.clip(nijk, 0, dims[None, None, :] - 1)
        nlin = safe[..., 0] + dims[0] * (safe[..., 1] + dims[1] * safe[..., 2])

        if lut is not None:
            row = lut[nlin]  # (S, 27); -1 = unoccupied cell
            hit = in_bounds & (row >= 0)
            pos_safe = jnp.maximum(row, 0)
        else:
            pos = jnp.searchsorted(cell_ids, nlin)  # (S, 27)
            pos_safe = jnp.minimum(pos, u - 1)
            hit = in_bounds & (cell_ids[pos_safe] == nlin)

        # Whole-bucket gathers: (S, 27, C, 3) coordinates + (S, 27, C) ids.
        cand_pts = bucket_pts[pos_safe].reshape(s, 27 * capacity, 3)
        cand_idx = bucket_idx[pos_safe].reshape(s, 27 * capacity)
        live = hit[..., None].repeat(capacity, -1).reshape(s, 27 * capacity)
        live &= cand_idx >= 0

        diff = cand_pts - s_blk[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(live & v_blk[:, None] & (d2 <= r2), d2, jnp.inf)

        if select_impl == "approx":
            neg_best, args_ = lax.approx_max_k(-d2, k, recall_target=0.99)
            best_d = -neg_best
        elif select_impl == "hier":
            # Exact two-stage selection: per-cell top-k (narrow, cheap)
            # then a merge top-k over 27*k candidates — the global k best
            # cannot include more than k members of any one cell.
            kc = min(k, capacity)
            neg1, a1 = lax.top_k(-d2.reshape(s, 27, capacity), kc)
            cols1 = (
                jax.lax.broadcasted_iota(jnp.int32, (s, 27, kc), 1) * capacity
                + a1
            ).reshape(s, 27 * kc)
            neg_best, a2 = lax.top_k(neg1.reshape(s, 27 * kc), k)
            best_d = -neg_best
            args_ = jnp.take_along_axis(cols1, a2, axis=1)
        else:
            neg_best, args_ = lax.top_k(-d2, k)
            best_d = -neg_best
        found = jnp.isfinite(best_d)
        args_ = jnp.minimum(args_, d2.shape[1] - 1)  # empty-slot sentinels
        best_idx = jnp.take_along_axis(cand_idx, args_, axis=1)
        out = (jnp.where(found, best_idx, 0), best_d, found)
        if return_points:
            best_pts = jnp.take_along_axis(cand_pts, args_[..., None], axis=1)
            out = out + (jnp.where(found[..., None], best_pts, 0.0),)
        return out

    n_blocks = n_pad // source_tile
    if n_blocks == 1:
        # Single block: skip the (sequentializing) lax.map wrapper.
        outs = search_block((src, sval))
    else:
        blocks = (
            src.reshape(n_blocks, source_tile, 3),
            sval.reshape(n_blocks, source_tile),
        )
        outs = lax.map(search_block, blocks)
        outs = tuple(o.reshape((n_pad,) + o.shape[2:]) for o in outs)
    idx, d2, found = (o[:n] for o in outs[:3])
    corr = Correspondences(
        indices=idx, sq_dists=jnp.where(found, d2, 0.0), mask=found
    )
    if return_points:
        return corr, outs[3][:n]
    return corr


def pick_source_tile(capacity: int, budget_bytes: int = 192 * 1024 * 1024) -> int:
    """Source-block size keeping the (S, 27*capacity) candidate buffers
    (points gather + distances, ~16 B/candidate) within ``budget_bytes``.

    Large cap (16k): each lax.map block carries fixed dispatch overhead, so
    sparse grids (small capacity) want few big blocks."""
    per_row = 27 * capacity * 16
    tile = budget_bytes // max(per_row, 1)
    tile = max(64, min(16384, tile))
    return (tile // 64) * 64


def grid_search(grid: HashGrid, source, *, k: int, radius: float, source_valid,
                source_tile: int | None = None) -> Correspondences:
    """Convenience wrapper unpacking :class:`HashGrid` into the jitted query
    (plus the hot-cell overflow merge when the grid carries one)."""
    if abs(grid.cell_size - radius) > 1e-12:
        raise ValueError("grid cell_size must equal the search radius")
    if source_tile is None:
        source_tile = pick_source_tile(grid.capacity)
    corr = grid_radius_search(
        source,
        grid.bucket_pts,
        grid.bucket_idx,
        grid.cell_ids,
        grid.origin,
        grid.dims,
        grid.lut,
        k=k,
        radius=radius,
        capacity=grid.capacity,
        source_valid=source_valid,
        source_tile=source_tile,
    )
    if grid.overflow_pts is not None:
        corr = merge_overflow(
            corr, source, grid.overflow_pts,
            grid.overflow_idx, k=k, radius=radius, source_valid=source_valid,
        )
    return corr
