"""Capacity-free pooled fused search: the sparse-scan (LiDAR) engine.

The dense fused engine (ops/fused_grid.py) prepacks every dilated cell's
27-cell candidate window as one row of a SINGLE (UD, 3, L) tensor, where L is
the global maximum window width. That design collapses on sparse outdoor
scans (KITTI: 131k points, mean cell occupancy ~2.5, but near-sensor cells
with 100+ returns):

  * the global max union is ~10x the p99 union, so a dense prepack would be
    gigabytes of padding (259k dilated cells x 1152 lanes at 131k points),
  * the XLA grid engine it falls back to pays 27*capacity-wide windows that
    are ~98% padding at occupancy 2.5, plus a per-iteration streaming brute
    pass over the hot-cell overflow set.

This engine keeps the grouped-window + select structure but stores
windows in a few WIDTH-CLASS pools sized to each window's real candidate
union (reference search semantics: src/prob_point_cloud_registration.cc:72-81):

  1. windows are already sorted by DESCENDING real union width (the dense
     engine's width-predication order), so each pow2 width band is a
     contiguous row range and becomes its own class: the widest handful at
     their real width, down to the dominant w<=8 tail (~82% of KITTI
     windows);
  2. each class c gets its own (n_c + 1, 3, W_c) pool, packed on device from
     contiguous [start, start+count) ranges of the CELL-SORTED target — no
     bucket capacity, so hot-cell points stay inline and the per-iteration
     overflow merge disappears (exact by construction);
  3. per iteration, sources group into cell-pure 8-row blocks exactly as in
     the dense engine; pass c covers the first B_c groups only. Groups are
     sorted by window row == descending width, so every class-c group
     provably lives in that prefix; a static per-class budget with a runtime
     coverage flag replaces dynamic shapes. Each pass selects through
     fused_grid.select_windows: classes wider than
     ``backend.SELECT_MAX_W`` run the Pallas select kernel, narrower ones
     a stable lax.top_k over their w-wide rows (for w <= k that is no
     selection at all — every in-radius candidate is a neighbor).

Neighbor SETS are identical to the XLA engines'; ties at the k-th slot may
resolve differently from the grid+overflow-merge path only within an exact
distance tie class (same caveat as ops/neighbors.py:16).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import backend
from ..core.types import round_up
from ..core.types import bucket_rows as _bucket_rows, pow2 as _pow2
from .fused_grid import (
    BLOCK_GROUPS,
    GROUP,
    _BIG,
    _group_by_window,
    _unsort_results,
    dilate_cells_host,
    select_windows,
)

# Widest pool class allowed: bounds the per-pass window width. A window
# wider than this (a >4096-point candidate union inside one 3x3x3
# neighborhood) means the scan is locally dense enough that the XLA grid
# engine's whole-bucket windows are the better fit.
MAX_CLASS_LANES = 4096
# Narrowest pool class: windows split into pow2 width classes down to this.
# Measured end to end on the card against a 128-lane floor with several
# narrow windows packed per pool row (docs/PERF.md, "Class floor").
MIN_CLASS_LANES = 8
# Total pool budget: sparse scans keep pools small (real unions, not
# capacity padding); beyond this the prepack declines and the caller stays
# on the XLA engines.
MAX_POOL_BYTES = 2 << 30
class PoolPrepack(NamedTuple):
    """Per-pair pooled fused-search state (device arrays unless noted).

    Attributes:
      pool_xyz / pool_idx: per width class c, (R_c + 1, 3, W_c) candidate
        coordinates and (R_c + 1, W_c) original target indices (-1 = empty);
        row R_c is the dead row. Each pool row holds one window.
      class_widths: static per-class lane widths, descending.
      class_ends: static exclusive end row of each class in the global
        width-sorted (padded) window numbering (class c = rows
        [ends[c-1], ends[c])).
      class_budgets: static per-class GROUP budgets (groups [0, B_c) are
        covered by pass c; the last class always covers every group).
      width_lut: (R + 1,) per-row select width (lanes up to the window's
        last live candidate; dead rows = 0).
      lut_d / origin_d / dims_d: extended-grid cell -> window row
        (fused_grid._group_by_window).
      budget_rows: static padded source-row budget for the grouping.
      n_dilated: static UD.
      cell_size: static float.
    """

    pool_xyz: tuple
    pool_idx: tuple
    class_widths: tuple
    class_ends: tuple
    class_budgets: tuple
    width_lut: jnp.ndarray
    lut_d: jnp.ndarray
    origin_d: jnp.ndarray
    dims_d: jnp.ndarray
    budget_rows: int
    n_dilated: int
    cell_size: float
    # Select cutoff (backend.SELECT_MAX_W unless the builder was given
    # another), passed to the search as a static.
    select_max_w: int = backend.SELECT_MAX_W


def _plan_classes(union: np.ndarray) -> tuple[list[int], list[int]]:
    """Split width-sorted windows into <=3 width classes.

    ``union`` is the per-window real candidate count, DESCENDING. Returns
    (widths, ends): per-class lane widths and exclusive end rows. Class
    boundaries are chosen so the dominant narrow class stays at 128 lanes
    and the wide tail pays its own width instead of inflating everyone's.
    """
    ud = union.shape[0]
    w = (np.ceil(np.maximum(union, 1) / 128.0) * 128).astype(np.int64)
    # Pow2 top width: a data-exact max (e.g. 1408) would change the static
    # class-width tuple between consecutive scans of a sequence and
    # recompile every per-pair program; the few widest windows pay <=2x
    # gather lanes (extraction stays at real width via the per-block
    # predication).
    l_max = _pow2(w[0]) if ud else 128
    widths = [l_max]
    if l_max > 512:
        widths.append(512)
    if l_max > 128:
        widths.append(128)
    ends = []
    for c, wc in enumerate(widths):
        nxt = widths[c + 1] if c + 1 < len(widths) else 0
        # Last window whose width exceeds the NEXT class's capacity belongs
        # to this class; w is non-increasing so searchsorted on the reversed
        # view gives the boundary.
        ends.append(ud - int(np.searchsorted(w[::-1], nxt + 1, side="left")))
    ends[-1] = ud
    # Drop empty classes (e.g. nothing wider than 512).
    widths_out, ends_out, prev = [], [], 0
    for wc, e in zip(widths, ends):
        if e > prev:
            widths_out.append(int(wc))
            ends_out.append(int(e))
            prev = e
    return widths_out, ends_out


def _scatter_lut(d_cells, row_vals, *, prod_d: int):
    """Dense extended-grid cell -> PADDED window row; pad entries carry
    out-of-range cell ids and are dropped."""
    return (
        jnp.full((prod_d,), -1, jnp.int32)
        .at[d_cells]
        .set(row_vals, mode="drop")
    )


def _neighbor_rows(base_e, d_cells_e, off_e, *, prod_e: int):
    """Device rebuild of the (UD, 27) neighbor-row table.

    ``base_e`` are the occupied cells' double-extended linear ids,
    ``d_cells_e`` the width-sorted dilated cells' ids in the same space, and
    ``off_e`` the 27 linear neighbor offsets (x slowest, z fastest — the
    shared engine tie order). The double-extended border ring makes every
    ``d_cells_e + off_e`` in bounds by construction, so one scatter + one
    gather replace uploading the 28 MB host-materialized table (the seeds
    are ~1 MB).
    ``prod_e`` is pow2-padded by the caller so per-pair grid-extent changes
    don't recompile this.
    """
    u = base_e.shape[0]
    occ = (
        jnp.full((prod_e,), -1, jnp.int32)
        .at[base_e]
        .set(jnp.arange(u, dtype=jnp.int32), mode="drop")
    )
    return occ[d_cells_e[:, None] + off_e[None, :]]


@partial(jax.jit, static_argnames=("plan_key",))
def _build_pools(packed, cell_start, cell_count, base_e, d_cells_e, off_e,
                 row_vals, dims_d, *, plan_key):
    """The whole device half of the pool prepack as ONE program.

    ``plan_key`` is the static pool geometry from :func:`plan_pool_host`:
    (pow2 class widths, bucket-padded class ends, pow2-padded prod_d /
    prod_e, dtype name, per-class assembly widths) — every element
    bucketed so consecutive scans of similar geometry reuse this compile.
    Windows live in the PADDED numbering (``row_vals``); class tails are
    dead rows. A class assembles its windows at their real pow2 width and
    pads them to the class width.

    Everything the host plan can cheaply express is RE-DERIVED here instead
    of uploaded: the search-grid cell ids ``d_cells`` from the
    double-extended ids, and the per-row widths from the neighbor-row table
    + per-cell counts. The host keeps its own copies in the plan dict (the
    demand replay reads them). Returns (pool_xyz tuple, pool_idx tuple,
    lut_d, width_lut).
    """
    widths, ends, prod_d, prod_e, dtype_name, assemble = plan_key
    dtype = jnp.dtype(dtype_name)
    ud_pad = ends[-1] if ends else 0

    # d_cells (the (+2)-extended SEARCH grid's linear ids) from the
    # double-extended ids: xe-1 etc. Dilated ids are >= 1 by construction
    # (occupied cells sit at coords+2), so the 0-padded tail is detectable
    # and maps to the dropped sentinel exactly like the host pad1 did.
    e0 = dims_d[0] + 2
    e1 = dims_d[1] + 2
    xe = d_cells_e % e0
    re_ = d_cells_e // e0
    ye = re_ % e1
    ze = re_ // e1
    d_cells = jnp.where(
        d_cells_e > 0,
        (xe - 1) + dims_d[0] * ((ye - 1) + dims_d[1] * (ze - 1)),
        prod_d,
    )

    lut_d = _scatter_lut(d_cells, row_vals, prod_d=prod_d)
    nrows_real = _neighbor_rows(
        base_e, d_cells_e, off_e, prod_e=prod_e
    )
    nrows_dev = (
        jnp.full((ud_pad, 27), -1, jnp.int32)
        .at[row_vals]
        .set(nrows_real, mode="drop")
    )

    # Per-row select widths from the real candidate unions (sum of the 27
    # neighbor cells' counts): lanes up to the last live candidate, rounded
    # up to 128 lanes; class tails are dead rows with zero counts -> 0,
    # which the kernel skips for free.
    u_padded = jnp.sum(
        jnp.where(
            nrows_dev >= 0, cell_count[jnp.maximum(nrows_dev, 0)], 0
        ),
        axis=1,
        dtype=jnp.int32,
    )
    zero1 = jnp.zeros((1,), jnp.int32)
    w_parts = []
    prev = 0
    for w_cls, e in zip(widths, ends):
        u_c = u_padded[prev:e]
        w_parts.append(
            jnp.where(u_c > 0, jnp.minimum((u_c + 127) // 128 * 128, w_cls), 0)
        )
        prev = e
    width_lut = jnp.concatenate(w_parts + [zero1]) if w_parts else zero1

    pool_xyz, pool_idx = [], []
    prev = 0
    for w_c, w_a, e in zip(widths, assemble, ends):
        n_c = e - prev
        block = _pool_block(n_c, w_a)
        xyz, idx = _assemble_pool_class(
            packed,
            cell_start,
            cell_count,
            nrows_dev[prev:e],
            w_c=w_a,
            n_rows=round_up(n_c, block),
        )
        # Pad lanes up to the class width (the class assembles at its
        # windows' real pow2 width, so the per-element pool gather touches
        # only ~live lanes), then append the dead row, constructed directly.
        xyz = jnp.pad(
            xyz.astype(dtype),
            ((0, 0), (0, 0), (0, w_c - w_a)),
            constant_values=jnp.asarray(_BIG, dtype),
        )
        idx = jnp.pad(idx, ((0, 0), (0, w_c - w_a)), constant_values=-1)
        pool_xyz.append(
            jnp.concatenate([xyz, jnp.full((1, 3, w_c), _BIG, dtype)], axis=0)
        )
        pool_idx.append(
            jnp.concatenate([idx, jnp.full((1, w_c), -1, jnp.int32)], axis=0)
        )
        prev = e
    return tuple(pool_xyz), tuple(pool_idx), lut_d, width_lut


def _pool_block(n_rows: int, w_c: int) -> int:
    """Rows per lax.map chunk in pool assembly (bounds the (B, W, 27) owner
    transient to ~0.5 GB of int32)."""
    return max(1, min(n_rows, (1 << 22) // max(w_c, 1)))


def _assemble_pool_class(packed_sorted, cell_start, cell_count, nrows_c,
                         *, w_c: int, n_rows: int):
    """Pack one width class's candidate windows from the cell-sorted target.

    ``packed_sorted`` is (Np + 1, 4) f32: cell-sorted target xyz with the
    original index BITCAST into lane 3 (one 16 B-aligned gather builds both
    coordinate and index pools), row Np = dead sentinel. Window slots follow
    (neighbor-offset, within-cell) order — the same tie order as every other
    engine, because within-cell order in the sort equals bucket slot order.

    Returns exactly ``nrows_c.shape[0]`` window rows at lane width ``w_c``;
    the caller pads lanes up to the class width and appends the dead row.
    The element gather dominates, so callers should invoke this at the
    windows' real pow2-padded width — the
    sub-width splitting in build_pool_prepack — rather than one class-wide
    width (33M mostly-dead gathered rows -> ~4M live ones at KITTI scale).
    """
    npts = packed_sorted.shape[0] - 1
    n_c = nrows_c.shape[0]
    block = _pool_block(n_rows, w_c)
    p = jnp.arange(w_c, dtype=jnp.int32)[None, :]

    def block_fn(nrows_blk):
        b = nrows_blk.shape[0]
        cnt = jnp.where(
            nrows_blk >= 0, cell_count[jnp.maximum(nrows_blk, 0)], 0
        )  # (B, 27)
        starts = jnp.cumsum(cnt, axis=1) - cnt
        total = jnp.sum(cnt, axis=1)
        base = cell_start[jnp.maximum(nrows_blk, 0)]  # (B, 27)
        # Packed slot p belongs to the LAST neighbor j with start_j <= p
        # (starts are nondecreasing; empty cells never own a slot because
        # the next nonempty neighbor shares their start). An unrolled
        # 27-step select over (B, W) lane-major arrays replaces the naive
        # (B, W, 27) reduction and its 27-wide minor dimension.
        ssel = jnp.zeros((b, w_c), jnp.int32)
        bsel = jnp.zeros((b, w_c), jnp.int32)
        for j in range(27):
            upd = starts[:, j : j + 1] <= p
            ssel = jnp.where(upd, starts[:, j : j + 1], ssel)
            bsel = jnp.where(upd, base[:, j : j + 1], bsel)
        srcpos = bsel + (p - ssel)
        live = p < total[:, None]
        pos = jnp.where(live, srcpos, npts)
        raw = packed_sorted[pos]  # (B, W, 4)
        xyz = jnp.transpose(raw[..., :3], (0, 2, 1))  # (B, 3, W)
        idx = lax.bitcast_convert_type(raw[..., 3], jnp.int32)
        return xyz, idx

    # Chunk the work; n_rows is the static padded row count (a multiple of
    # the block by construction in the caller).
    pad = n_rows - n_c
    nrows_pad = jnp.concatenate(
        [nrows_c, jnp.full((pad, 27), -1, jnp.int32)], axis=0
    )
    xyz, idx = lax.map(
        block_fn, nrows_pad.reshape(n_rows // block, block, 27)
    )
    xyz = xyz.reshape(n_rows, 3, w_c)[:n_c]
    idx = idx.reshape(n_rows, w_c)[:n_c]
    return xyz, idx


def _ladder_ends(union: np.ndarray, widths: list[int]) -> list[int] | None:
    """Bin width-sorted windows into a GIVEN descending pow2 width ladder.

    Window width = pow2(union) clipped up to the ladder's narrowest class.
    Returns the exclusive end rows (one per ladder class, empty classes
    keep a zero-size band — SPMD consumers need every shard to share the
    ladder), or None when some window is wider than the ladder's top class.
    """
    ud = union.shape[0]
    w = np.maximum(
        widths[-1],
        1 << np.ceil(np.log2(np.maximum(union, 1))).astype(np.int64),
    )
    if ud and int(w[0]) > widths[0]:
        return None
    ends = []
    for c in range(len(widths)):
        nxt = widths[c + 1] if c + 1 < len(widths) else 0
        ends.append(ud - int(np.searchsorted(w[::-1], nxt + 1, side="left")))
    ends[-1] = ud
    return ends


def plan_pool_host(
    grid_host: dict,
    target: np.ndarray,
    *,
    force: dict | None = None,
) -> dict | None:
    """Host-only half of the pool prepack (pure numpy — sequence pipelines
    run it on the target-prep thread, models/odometry.py).

    ``target`` is the (padded) target cloud the grid was built over (only its
    first ``num_valid`` rows are read). Returns None when the scan doesn't
    fit the engine: extended LUT too large (dilate_cells_host), a window
    union beyond MAX_CLASS_LANES, or pools past MAX_POOL_BYTES — callers
    then stay on the XLA grid engine.

    ``force`` harmonizes every STATIC dimension of the plan to caller-given
    values so several plans share one compiled program and identical array
    shapes — the contract SPMD consumers need (parallel/pool_sharded.py
    builds one plan per target shard; every shard must agree on the static
    key). Keys: ``widths`` (the class ladder — windows are then binned
    purely by pow2(union) clipped into the ladder, see :func:`_ladder_ends`),
    ``pad_sizes`` (padded per-class row counts), ``prod_d_pad``,
    ``prod_e_pad``, ``u_pad``, ``n_pad``, ``ud_b``. All forced values must
    dominate this scan's real sizes (returns None otherwise — the caller
    derived them from a superset of scans).
    """
    counts_full = grid_host["cell_count"].astype(np.int64)
    dil = dilate_cells_host(grid_host, counts=counts_full, dense_lut=False)
    if dil is None:
        return None
    nrows = dil["nrows"]  # (UD, 27), width-sorted
    union = dil["union"]
    if force is None:
        widths, ends = _plan_classes(union)
        if widths and widths[0] > MAX_CLASS_LANES:
            return None
    else:
        widths = list(force["widths"])
        if union.size and int(union.max()) > MAX_CLASS_LANES:
            return None

    n = grid_host["num_valid"]
    order = grid_host["sort_order"]
    packed = np.empty((n + 1, 4), np.float32)
    packed[:n, :3] = np.asarray(target[:n])[order].astype(np.float32)
    packed[:n, 3] = order.astype(np.int32).view(np.float32)
    packed[n, :3] = _BIG
    packed[n, 3] = np.int32(-1).view(np.float32)

    # Pow2 sub-width classes: windows are width-sorted globally, so each
    # pow2 width band is a contiguous row range and becomes its OWN class
    # (down to MIN_CLASS_LANES), so every class pays only its real width
    # in pool memory and select work.
    if force is None:
        w_pow2 = np.maximum(
            MIN_CLASS_LANES,
            1 << np.ceil(np.log2(np.maximum(union, 1))).astype(np.int64),
        )
        widths2, ends2 = [], []
        prev = 0
        for w_c, e_c in zip(widths, ends):
            cls_w = np.minimum(w_pow2[prev:e_c], w_c)
            s0 = 0
            while s0 < e_c - prev:
                sw = int(cls_w[s0])
                s1 = int(np.searchsorted(-cls_w, -sw, side="right"))
                widths2.append(sw)
                ends2.append(prev + s1)
                s0 = s1
            prev = e_c
        widths, ends = widths2, ends2
    else:
        # Forced ladder: pure pow2 binning (equivalent to the self-derived
        # split whenever the ladder covers this scan; empty classes keep a
        # zero-size band so every shard shares the class structure).
        ends = _ladder_ends(union, widths)
        if ends is None:
            return None

    # ---- Sequence compile stability ----
    # Class sizes are bucketed geometrically (~25% granularity, pow2
    # floors), so data-exact shape noise between consecutive scans
    # disappears into dead-window padding and the static keys repeat
    # across a sequence (each new key is a recompile). Force-mode
    # (harmonized SPMD) plans take the forced pad sizes: their static key
    # must be identical across group members.
    ud = int(union.shape[0])
    sizes = np.diff([0] + ends).tolist()
    starts = [0] + ends[:-1]
    # Center-cell target count per window: the source-density proxy for the
    # group budgets (offset 13 of the (x slowest, z fastest)
    # 27-enumeration is (0,0,0); sources land like targets).
    counts_pad = np.concatenate([counts_full, [0]])
    center = np.where(
        nrows[:, 13] >= 0, counts_pad[np.maximum(nrows[:, 13], 0)], 0
    )
    if force is None:
        # A class assembles its windows at their real pow2 width (its
        # widest window's, <= the class width).
        assemble = [
            int(min(w, _pow2(max(int(union[s0]), 1))))
            for w, s0 in zip(widths, starts)
        ]
        pad_sizes = [
            _bucket_rows(n_c, max(64, (1 << 20) // (16 * wa)), 3)
            for wa, n_c in zip(assemble, sizes)
        ]
    else:
        assemble = list(widths)
        pad_sizes = list(force["pad_sizes"])
        if any(p < s_c for p, s_c in zip(pad_sizes, sizes)):
            return None
    ends_pad = np.cumsum(pad_sizes).tolist()
    ud_pad = int(ends_pad[-1]) if ends_pad else 0
    pool_bytes = sum((p + 1) * w * 16 for p, w in zip(pad_sizes, widths))
    if pool_bytes > MAX_POOL_BYTES:
        return None

    # Padded window numbering: class c's windows keep their width order at
    # the head of its padded row range [ends_pad[c-1], ends_pad[c]); the
    # tail rows are dead.
    pad_starts = [0] + ends_pad[:-1]
    row_vals = np.concatenate(
        [np.zeros((0,), np.int32)]
        + [p0 + np.arange(n_c, dtype=np.int32)
           for p0, n_c in zip(pad_starts, sizes)]
    )
    # Group estimates from the center-count proxy: budgets floor real
    # windows at 1 (stray sources), the row budget does not.
    groups = -(-center // GROUP)
    groups_fl = -(-np.maximum(center, 1) // GROUP)
    est_groups_total = int(groups.sum())
    cls_groups = [
        int(groups_fl[s0:e].sum()) for s0, e in zip(starts, ends)
    ]

    # Row budget: 1.3x margin over the occupancy-predicted row count + the
    # runtime overflow flag for drift (the estimate tracks live rows only:
    # dead-window sources are dropped by the grouping).
    est_rows = GROUP * est_groups_total
    budget_rows = round_up(
        _bucket_rows(max(int(1.3 * est_rows), n), step_bits=3),
        2 * BLOCK_GROUPS * GROUP,
    )
    ng = budget_rows // GROUP

    # Per-class group budgets, 2x margin + floor; the
    # last class always spans every group. Floor at 1024 groups: prefix
    # blocks beyond the real groups are width-0 and skipped by the kernel,
    # so the floor swallows scan-to-scan budget noise at ~zero cost.
    budgets = []
    cum_groups = 0
    for c in range(len(widths)):
        cum_groups += cls_groups[c]
        if c == len(widths) - 1:
            budgets.append(ng)
        else:
            b = round_up(
                _bucket_rows(2 * cum_groups + 4 * BLOCK_GROUPS, 1024, 3),
                BLOCK_GROUPS,
            )
            budgets.append(min(ng, b))

    off_e = dil["off_e"]

    # Bucket-padded upload arrays. Sentinels: indices one past the pow2
    # scatter-table sizes (dropped by mode="drop"), dead packed rows, and
    # row_vals = ud_pad (dropped when scattering the padded numbering).
    u = int(dil["base_e"].shape[0])
    if force is None:
        prod_e_pad = _pow2(dil["prod_e"])
        prod_d_pad = _pow2(dil["prod_d"])
        # ~25% buckets: these counts jitter scan-to-scan in a sequence and
        # any flip re-specializes the build/search programs (bucket_rows).
        u_pad = _bucket_rows(u, step_bits=3)
        n_pad = _bucket_rows(n + 1, step_bits=3)
        ud_b = _bucket_rows(ud, step_bits=3)
    else:
        prod_e_pad = force["prod_e_pad"]
        prod_d_pad = force["prod_d_pad"]
        u_pad = force["u_pad"]
        n_pad = force["n_pad"]
        ud_b = force["ud_b"]
        if (
            prod_e_pad < dil["prod_e"]
            or prod_d_pad < dil["prod_d"]
            or u_pad < u
            or n_pad < n + 1
            or ud_b < ud
        ):
            return None
    packed_pad = np.empty((n_pad + 1, 4), np.float32)
    packed_pad[: n + 1] = packed
    packed_pad[n + 1 :, :3] = _BIG
    packed_pad[n + 1 :, 3] = np.int32(-1).view(np.float32)

    def pad1(a, length, value):
        out = np.full((length,), value, a.dtype)
        out[: a.shape[0]] = a
        return out

    return {
        "dil": dil,
        "widths": widths,
        "ends": ends_pad,
        # Static per-class assembly widths: part of the _build_pools plan
        # key.
        "assemble": tuple(assemble),
        "packed": packed_pad,
        "row_vals": pad1(row_vals, ud_b, ud_pad),
        "d_cells": pad1(dil["d_cells"].astype(np.int32), ud_b, prod_d_pad),
        "d_cells_e": pad1(dil["d_cells_e"].astype(np.int32), ud_b, 0),
        "base_e": pad1(dil["base_e"].astype(np.int32), u_pad, prod_e_pad),
        "cell_start": pad1(
            grid_host["cell_start"].astype(np.int32), u_pad, n
        ),
        "cell_count": pad1(
            grid_host["cell_count"].astype(np.int32), u_pad, 0
        ),
        "prod_d_pad": prod_d_pad,
        "prod_e_pad": prod_e_pad,
        "budgets": budgets,
        "budget_rows": budget_rows,
        "off_e": off_e,
        "cell_size": grid_host["cell_size"],
    }


def plan_pool_host_group(grids: list, targets: list) -> list | None:
    """Plan several scans with ONE shared static geometry.

    SPMD and vmap consumers (parallel/pool_sharded.py target shards,
    parallel/batch.py pair batches) need every member to share the class
    ladder, padded class sizes, scatter-table sizes, and upload shapes so
    a single compiled program serves all of them. Two passes: self-keyed
    plans, then re-planning with ``force`` statics taken as maxima over
    the group. Returns the aligned plans, or None when any member declines
    the pooled engine (callers fall back to the XLA grid engine).
    """
    plans = []
    for g, t in zip(grids, targets):
        p = plan_pool_host(g, t)
        if p is None:
            return None
        plans.append(p)
    ladder = sorted({w for p in plans for w in p["widths"]}, reverse=True)
    real = np.zeros((len(plans), len(ladder)), np.int64)
    for i, p in enumerate(plans):
        ends = _ladder_ends(p["dil"]["union"], ladder)
        if ends is None:
            return None
        real[i] = np.diff([0] + ends)
    force = {
        "widths": tuple(ladder),
        "pad_sizes": tuple(
            int(
                _bucket_rows(
                    int(real[:, c].max()), max(64, (1 << 20) // (16 * w))
                )
            )
            for c, w in enumerate(ladder)
        ),
        "prod_d_pad": max(_pow2(p["dil"]["prod_d"]) for p in plans),
        "prod_e_pad": max(_pow2(p["dil"]["prod_e"]) for p in plans),
        "u_pad": max(
            _bucket_rows(int(p["dil"]["base_e"].shape[0])) for p in plans
        ),
        "n_pad": max(p["packed"].shape[0] - 1 for p in plans),
        "ud_b": max(p["row_vals"].shape[0] for p in plans),
    }
    out = []
    for g, t in zip(grids, targets):
        p2 = plan_pool_host(g, t, force=force)
        if p2 is None:  # cannot happen by construction; belt and braces
            return None
        out.append(p2)
    return out


def estimate_pool_demand_rows(plan: dict, source: np.ndarray,
                              num_valid: int | None = None,
                              class_row_ends: tuple | None = None):
    """EXACT padded-row demand of the grouping (fused_grid._group_by_window)
    for a real source cloud.

    The plan's row budget is estimated from target occupancy (sources are
    assumed to land like targets). Real pairs drift: moved sources fall in
    dilated shell cells whose center-count proxy is 0, and each such window
    still costs a full group of rows — measured 330k real rows vs a 213k
    budget on a KITTI-like sequence pair (1.55x), which tripped the runtime
    overflow flag and forced a discarded chunk + a second scan compile on
    every first pair.

    This replays the grouping arithmetic in vectorized numpy (~20 ms at
    131k): per window row source counts -> ``GROUP * ceil(c / GROUP)``
    rows each. Callers size the search budget as
    ``max(plan_budget, margin * demand)`` so the first dispatched program
    already covers the real pair (the overflow flag stays as the guard for
    intra-pair drift).

    ``class_row_ends`` (the prepack's global row ends per class)
    switches the return to ``(rows, cum_groups)``, where ``cum_groups[c]``
    is the measured group count of classes <= c — the same replay then
    demand-sizes the per-class PREFIX budgets too (every class pass pays
    streaming + dead-block dispatch over its whole prefix, so the plan's
    2x-estimate mid-class budgets cost real select work).
    """
    dil = plan["dil"]
    n = num_valid if num_valid is not None else source.shape[0]
    pts = np.asarray(source[:n], dtype=np.float64)
    dims_d = np.asarray(dil["dims_d"], dtype=np.int64)
    cell = float(plan["cell_size"])
    ijk = np.floor((pts - np.asarray(dil["origin_d"])) / cell).astype(
        np.int64
    )
    inb = np.all((ijk >= 0) & (ijk < dims_d), axis=1)
    lin = ijk[inb, 0] + dims_d[0] * (ijk[inb, 1] + dims_d[1] * ijk[inb, 2])
    size = int(plan["prod_d_pad"]) + 1
    lut = np.full(size, -1, np.int64)
    # Padded tails carry the sentinel cell id prod_d_pad: they land in the
    # table's last slot, which no source cell reaches.
    lut[plan["d_cells"]] = plan["row_vals"]
    q = lut[lin]
    q = q[q >= 0]
    if q.size == 0:
        if class_row_ends is not None:
            return 0, [0] * len(class_row_ends)
        return 0
    rows, counts = np.unique(q, return_counts=True)
    groups = -(-counts // GROUP)
    total = int(GROUP * groups.sum())
    if class_row_ends is not None:
        cum = [int(groups[rows < int(e)].sum()) for e in class_row_ends]
        return total, cum
    return total


def demand_class_budgets(
    cum_groups, last_budget: int, *, boost: int = 0, cap: int | None = None
) -> tuple:
    """Class-PREFIX budgets from a grouping replay's per-class cumulative
    group counts (the single source for the three dispatch sites:
    models/registration.py, parallel/align.py, parallel/pool_sharded.py).

    1.25x margin over the measured counts, ~25% buckets + 1024-group floor
    (compile stability across a sequence's scans), rounded to the kernel
    block multiple, ``boost``-shifted so the overflow-escalation ladder
    raises class budgets too. NOT clamped to the plan's 2x target-proxy
    estimates: the replay may legitimately EXCEED the proxy (the same
    shell-cell undercount that motivated the row-budget demand lift), and
    clamping would reinstate the first-pair coverage overflow the replay
    exists to avoid. ``cap`` (e.g. the dispatch's total group count)
    bounds each entry when given; the last class always gets
    ``last_budget`` (the search forces it to span every group anyway).
    """
    out = []
    for c in cum_groups[:-1]:
        b = round_up(
            _bucket_rows((int(1.25 * c) << boost) + 4 * BLOCK_GROUPS, 1024, 3),
            BLOCK_GROUPS,
        )
        out.append(min(cap, b) if cap is not None else b)
    return tuple(out) + (last_budget,)


def pool_seed_host(plan: dict, dtype=np.float32) -> dict:
    """The pool prepack's upload dict (host numpy), shared by
    :func:`build_pool_prepack` and callers that merge these seeds into a
    larger single ``jax.device_put`` (models/registration.py ctor).

    Deliberately NOT shipped (derived on device in :func:`_build_pools`):
    d_cells and the per-row widths."""
    dil = plan["dil"]
    return {
        "packed": plan["packed"],
        "cell_start": plan["cell_start"],
        "cell_count": plan["cell_count"],
        "base_e": plan["base_e"],
        "d_cells_e": plan["d_cells_e"],
        "off_e": plan["off_e"],
        "row_vals": plan["row_vals"],
        "dims_d": dil["dims_d"],
        "origin_d": dil["origin_d"].astype(dtype),
    }


def build_pool_prepack(
    grid_host: dict,
    target: np.ndarray,
    dtype=np.float32,
    plan: dict | None = None,
    select_max_w: int | None = None,
    dev_seeds: dict | None = None,
) -> PoolPrepack | None:
    """Build the pooled fused-search state (host plan + device packing).

    Pass a precomputed ``plan`` (from :func:`plan_pool_host`, e.g. built on
    the sequence pipeline's target-prep thread) to skip the host half here.
    ``dev_seeds`` takes the already-device-put :func:`pool_seed_host` dict
    (callers batching the upload); None uploads here. ``select_max_w``
    overrides the backend's select cutoff (tests).
    """
    if plan is None:
        plan = plan_pool_host(grid_host, target)
    if plan is None:
        return None
    dil = plan["dil"]
    widths, ends = plan["widths"], plan["ends"]

    dev = (
        dev_seeds
        if dev_seeds is not None
        else jax.device_put(pool_seed_host(plan, dtype))
    )
    # One fused device program builds everything: the dense extended-grid
    # LUT (a >100 MB host write + upload at KITTI scale if materialized
    # host-side), the (UD, 27) neighbor-row table (28 MB shipped vs ~1 MB of
    # seeds), and every width-class pool, in one dispatch. Every static in
    # the plan key AND every upload shape is bucketed (plan_pool_host), so
    # scans of similar geometry reuse this compile across a whole sequence.
    plan_key = (
        tuple(widths),
        tuple(ends),
        plan["prod_d_pad"],
        plan["prod_e_pad"],
        np.dtype(dtype).name,
        plan["assemble"],
    )
    pool_xyz, pool_idx, lut_d, width_lut = _build_pools(
        dev["packed"],
        dev["cell_start"],
        dev["cell_count"],
        dev["base_e"],
        dev["d_cells_e"],
        dev["off_e"],
        dev["row_vals"],
        dev["dims_d"],
        plan_key=plan_key,
    )

    return PoolPrepack(
        pool_xyz=tuple(pool_xyz),
        pool_idx=tuple(pool_idx),
        class_widths=tuple(widths),
        class_ends=tuple(plan["ends"]),
        class_budgets=tuple(plan["budgets"]),
        width_lut=width_lut,
        lut_d=lut_d,
        origin_d=dev["origin_d"],
        dims_d=dev["dims_d"],
        budget_rows=plan["budget_rows"],
        n_dilated=dil["n_dilated"],
        cell_size=plan["cell_size"],
        select_max_w=(
            backend.SELECT_MAX_W if select_max_w is None else select_max_w
        ),
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "radius", "class_widths", "class_ends", "class_budgets",
        "budget_rows", "return_points", "select_max_w",
    ),
)
def fused_pool_search(
    source,
    source_valid,
    pool_xyz,
    pool_idx,
    width_lut,
    lut_d,
    origin_d,
    dims_d,
    *,
    k: int,
    radius: float,
    class_widths: tuple,
    class_ends: tuple,
    class_budgets: tuple,
    budget_rows: int,
    return_points: bool = False,
    select_max_w: int = backend.SELECT_MAX_W,
):
    """Radius-capped KNN via width-class pools + fused_grid.select_windows.

    Same contract as fused_grid_search: returns (Correspondences, overflow
    [, points]); overflow > 0 when either the row budget or a class-prefix
    budget was exceeded — the caller redoes the iteration on an XLA engine.
    ``class_ends`` / ``width_lut`` / ``lut_d`` use the padded window
    numbering (PoolPrepack). ``select_max_w`` is the select cutoff (PoolPrepack.select_max_w).
    """
    n = source.shape[0]
    dtype = source.dtype
    n_rows = width_lut.shape[0] - 1
    s_pad = round_up(budget_rows, 2 * BLOCK_GROUPS * GROUP)
    ng = s_pad // GROUP

    padded, step_rows, order, dst, overflow = _group_by_window(
        source, source_valid, lut_d, origin_d, dims_d, n_rows, radius, s_pad
    )

    class_results = []
    prev_end = 0
    for c, (w_c, e_c, b_c) in enumerate(
        zip(class_widths, class_ends, class_budgets)
    ):
        # The LAST class always covers every group, including when the
        # caller raised budget_rows above the plan's estimate (the plan's
        # last budget is its own ng; trusting it here would silently skip
        # the extra groups and the coverage flag below would fire).
        if c == len(class_widths) - 1:
            b_c = ng
        b_c = min(round_up(b_c, BLOCK_GROUPS), ng)
        n_c = e_c - prev_end
        rows_c = step_rows[:b_c]
        in_class = (rows_c >= prev_end) & (rows_c < e_c)
        local = jnp.where(in_class, rows_c - prev_end, n_c)
        # Class-local widths; the dead row (n_c) has width 0.
        width_c = jnp.concatenate(
            [width_lut[prev_end:e_c], jnp.zeros((1,), width_lut.dtype)]
        )
        res = select_windows(
            padded[: b_c * GROUP], pool_xyz[c], pool_idx[c], local, width_c,
            k=k, radius=radius, return_points=return_points,
            select_max_w=select_max_w,
        )
        class_results.append((b_c, res))
        # Coverage: groups are sorted by row (descending width), so any
        # class-<=c window past this class's budget means a missed group.
        if b_c < ng:
            overflow += jnp.where(step_rows[b_c] < e_c, 1, 0)
        prev_end = e_c

    # Combine the per-class results. The LAST class always spans the full
    # row budget (b_c forced to ng above) and its select emits exactly the
    # empty-slot values (d2=big, idx=-1, zero points) at rows outside its
    # own in_class mask (dummy windows find nothing) — so it IS the
    # initialized output buffer, for free. Only the earlier classes (with
    # strictly smaller row prefixes) overlay their disjoint rows; the
    # previous accumulator formulation paid a full (s_pad, kp) select +
    # dynamic-update-slice per PLANE for the biggest class every iteration
    # (~the single largest glue fusion in the KITTI trace).
    b_last, res_last = class_results[-1]
    assert b_last * GROUP == s_pad
    outd, outi = res_last[0], res_last[1]
    outp = res_last[2] if return_points else None
    # Classes are row-disjoint and every select emits exactly (big, -1, 0)
    # at rows outside its own class, so the overlay needs no mask at all:
    # at each row exactly one operand is real and the other is the empty
    # value — elementwise min / max / add combine them (slots beyond a
    # row's found count are empty in BOTH operands and stay empty).
    for b_c, res in class_results[:-1]:
        n_r = b_c * GROUP
        outd = outd.at[:n_r].set(jnp.minimum(outd[:n_r], res[0]))
        outi = outi.at[:n_r].set(jnp.maximum(outi[:n_r], res[1]))
        if return_points:
            outp = tuple(
                o.at[:n_r].set(o[:n_r] + r) for o, r in zip(outp, res[2])
            )

    corr, pts = _unsort_results(
        outd, outi, outp, order, dst, k=k, n=n, dtype=dtype
    )
    if return_points:
        return corr, overflow, pts
    return corr, overflow
