"""Fused grouped grid search: cell-shared candidate windows + k-select.

The XLA grid engine (ops/grid.py) pays two device-memory taxes every outer
iteration on a dense scan like the 35k bench pair:

  * the candidate gather moves (N, 27, capacity) whole-bucket rows — ~1 GB of
    768 B-granularity random gathers, and
  * ``lax.top_k`` over the (N, 27*capacity) distance matrix, ~90% of whose
    lanes are bucket padding.

This engine exploits the fact that all sources in the same grid cell share
the *same* 27-cell candidate neighborhood (the reference's kd-tree pays this
cost per query instead — src/prob_point_cloud_registration.cc:72-81):

  1. ONCE per pair: prepack, for every cell in the dilated occupied set (any
     cell adjacent to an occupied target cell — a source anywhere else
     provably has zero in-radius neighbors), the full 27-neighborhood
     candidate window as contiguous (3, L) coordinate + (L,) index rows.
  2. Per iteration (all device-side, inside jit): bucket the moved sources
     by cell and group same-cell sources into G=8-row blocks, so one window
     serves a whole group (~4x less traffic than per-source windows), and
  3. select the k nearest per source from the group's window
     (:func:`select_windows`: the Pallas kernel of ops/select_kernel.py for
     wide windows, plain XLA for narrow ones).

Selection semantics are identical to the XLA engines: k smallest f32
distances within ``radius``, ascending, ties broken by candidate-slot order
(the same (neighbor-offset, bucket-slot) enumeration), so neighbor sets are
bit-compatible and tested for parity (tests/test_fused_grid.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import backend
from ..core.types import Correspondences, bucket_rows as _bucket_rows, pow2 as _pow2, round_up
from .select_kernel import kernel_select

# Sources per cell-pure group: one candidate window serves GROUP rows.
GROUP = 8
# Granularity of every row and class budget, in groups: budgets are
# multiples of it, so the select kernel's per-program groups
# (select_kernel.KERNEL_GROUPS, a divisor) tile every pass exactly.
BLOCK_GROUPS = 16
# Dead-candidate coordinate sentinel: squared distances overflow any radius.
_BIG = np.float32(1e30)
class PrepackedGrid(NamedTuple):
    """Per-pair fused-search state (device arrays unless noted).

    Attributes:
      cand_xyz: (UD+1, 3, L) candidate window coordinates per dilated cell;
        row UD is the dead window (all slots empty).
      cand_idx: (UD+1, L) original target index per slot; -1 = empty.
      lut_d: (prod(dims+2),) extended-grid linear cell id -> dilated row,
        -1 where a source has provably no neighbors.
      origin_d: (3,) extended grid origin (origin - cell_size).
      dims_d: (3,) int32 extended grid dims (dims + 2).
      n_lanes: static L.
      n_dilated: static UD.
      cell_size: static float.
    """

    cand_xyz: jnp.ndarray
    cand_idx: jnp.ndarray
    width_lut: jnp.ndarray  # (UD+1,) int32 per-window kernel width (lanes)
    lut_d: jnp.ndarray
    origin_d: jnp.ndarray
    dims_d: jnp.ndarray
    n_lanes: int
    n_dilated: int
    cell_size: float


def dilate_cells_host(
    grid_host: dict,
    counts: np.ndarray | None = None,
    dense_lut: bool = True,
) -> dict | None:
    """Host-side dilation tables for :func:`build_prepack` (numpy only).

    Takes the dict from ops.grid.build_grid_host. Returns None when the
    extended LUT would be too large to materialize densely (sparse scans
    stay on the XLA engines).

    ``counts`` overrides the per-cell candidate counts used for window
    unions/widths: the dense engine packs from the capacity-CAPPED bucket
    tensors (default: live bucket slots), while the capacity-free pool engine
    (ops/fused_pool.py) passes the full ``cell_count`` so hot-cell points
    stay inline in their windows instead of in a separate overflow set.

    ``dense_lut=False`` skips materializing the dense (prod_d,) cell->window
    LUT and returns the sparse pair ("d_cells", "lut_vals", "prod_d")
    instead — at KITTI scale the dense LUT is >100 MB of host write + device
    upload, vs a ~1 MB scatter the device does itself (fused_pool.py).
    """
    dims = grid_host["dims"].astype(np.int64)
    dims_d = dims + 2
    prod_d = int(dims_d.prod())
    if prod_d > (1 << 25):
        return None
    # Only the real occupied cells: the grid pads its arrays to a row
    # bucket (ops/grid.py) with sentinel ids that must not be decoded.
    u = grid_host.get("num_cells", grid_host["cell_ids"].shape[0])
    cell_ids = grid_host["cell_ids"][:u].astype(np.int64)
    # Decode occupied cells, dilate by one in every direction (extended
    # coords = original + 1 so the border ring is always addressable — no
    # bounds mask needed). All index math stays in flat linear space: the
    # 27-neighborhood of extended-linear base b is {b + off_lin} because the
    # extended grid's border ring guarantees no axis wraps.
    x = (cell_ids % dims[0]).astype(np.int32)
    rest = cell_ids // dims[0]
    y = (rest % dims[1]).astype(np.int32)
    z = (rest // dims[1]).astype(np.int32)
    # All neighbor math runs in a DOUBLE-extended (+4) grid: occupied cells
    # sit at coords+2, so dilated cells land in [1, dims+2] and every
    # neighbor-of-a-dilated-cell in [0, dims+3] — always in bounds, which
    # kills the per-axis bounds masks and clips (~12 extra 7M-element passes
    # in the previous formulation; this host dilation is on the per-pair
    # critical path at KITTI scale).
    e0, e1 = int(dims[0] + 4), int(dims[1] + 4)
    prod_e = e0 * e1 * int(dims[2] + 4)
    # Offset enumeration order (x slowest, z fastest) is the tie order shared
    # by every engine — keep it exactly.
    ox, oy, oz = np.meshgrid(*([np.arange(-1, 2, dtype=np.int32)] * 3), indexing="ij")
    off_e = (ox + e0 * (oy + e1 * oz)).reshape(27)
    base_e = (x + 2) + np.int32(e0) * ((y + 2) + np.int32(e1) * (z + 2))

    if counts is None:
        counts = (grid_host["bucket_idx"] >= 0).sum(axis=1)

    # Native C++ dilation when available (the per-pair prepack's host half
    # sits on the cold-pair critical path; the numpy body below is
    # allocation-heavy — measured 0.9-4 s first-call-in-process at KITTI
    # scale vs ~0.1 s native — and is kept as the always-works fallback and
    # parity oracle, tests/test_native.py).
    from .. import native as _native

    nat = _native.dilate_cells(cell_ids, dims, counts[:u])
    if nat is not None:
        d_cells_e, nrows, union = nat
        ud = d_cells_e.shape[0]
        max_union = int(union.max()) if union.size else 0
    else:
        dil_e = (base_e[:, None] + off_e[None, :]).reshape(-1)
        # Dense-flag unique: O(prod_e + 27u) beats sorting 27u linear ids.
        flags = np.zeros((prod_e,), dtype=bool)
        flags[dil_e] = True
        d_cells_e = np.flatnonzero(flags).astype(np.int32)
        ud = d_cells_e.shape[0]

        # Original-grid row of each of the 27 neighbors of each dilated
        # cell: one gather through the extended occupied-cell LUT, no
        # bounds math.
        lut_e = np.full((prod_e,), -1, dtype=np.int32)
        lut_e[base_e] = np.arange(u, dtype=np.int32)
        nrows = lut_e[d_cells_e[:, None] + off_e[None, :]]

        # Largest real candidate-union over all windows: the packed lane
        # width. Typically ~5x smaller than 27*capacity (bunny 35k: 262 vs
        # 1728) — occupancy variance means most bucket slots are padding,
        # and the select kernel's extraction cost is proportional to lane
        # width.
        counts_pad = np.concatenate([counts[:u], [0]]).astype(np.int32)
        union = counts_pad[np.where(nrows >= 0, nrows, u)].sum(
            axis=1, dtype=np.int32
        )
        max_union = int(union.max()) if union.size else 0

        # Renumber dilated rows by DESCENDING union width. Sources are
        # grouped in row order every iteration, so this makes the group
        # sequence width-monotone: each select-kernel block then runs at
        # (roughly) its own real width instead of the global maximum — the
        # kernel's chunk count follows its block's widest window.
        perm = np.argsort(-union, kind="stable").astype(np.int32)
        nrows = nrows[perm]
        union = union[perm]
        # Dilated cell ids in the (+2) extended search grid (row j of the
        # width-sorted numbering lives at extended-linear d_cells[j]).
        d_cells_e = d_cells_e[perm]
    xe = d_cells_e % e0
    re_ = d_cells_e // e0
    ye = re_ % e1
    ze = re_ // e1
    d0, d1 = int(dims_d[0]), int(dims_d[1])
    d_cells = (xe - 1) + np.int32(d0) * ((ye - 1) + np.int32(d1) * (ze - 1))
    # Per-row kernel width (lanes, multiple of 128); dead row (appended by
    # the prepack as row UD) gets width 0 so budget-padding blocks are free.
    width_lut = np.concatenate(
        [
            (np.ceil(np.maximum(union, 1) / 128.0) * 128).astype(np.int32),
            np.zeros((1,), np.int32),
        ]
    )
    out = {
        "nrows": nrows,  # (UD, 27) int32
        "dims_d": dims_d.astype(np.int32),
        "origin_d": grid_host["origin"] - grid_host["cell_size"],
        "n_dilated": ud,
        "max_union": max_union,
        "union": union,  # (UD,) descending real candidate counts
        "width_lut": width_lut,  # (UD+1,) int32
    }
    if dense_lut:
        lut_d = np.full((prod_d,), -1, dtype=np.int32)
        lut_d[d_cells] = np.arange(ud, dtype=np.int32)
        out["lut_d"] = lut_d
    else:
        out["d_cells"] = d_cells
        out["prod_d"] = prod_d
        # Device-side neighbor-row computation (fused_pool.py): the (UD, 27)
        # nrows table is ~27x the size of these seeds (28 MB vs ~1 MB at
        # KITTI scale), so sparse-path callers upload the width-sorted
        # double-extended cell ids + the occupied-cell scatter seeds and
        # rebuild nrows with one device gather instead of shipping it.
        out["d_cells_e"] = d_cells_e
        out["base_e"] = base_e
        out["prod_e"] = prod_e
        out["e_dims"] = (e0, e1)
        # The 27 linear neighbor offsets in the double-extended grid —
        # the enumeration IS the engines' shared tie-break contract, so
        # consumers must use this array, not rebuild it.
        out["off_e"] = off_e.astype(np.int32)
    return out


@partial(jax.jit, static_argnames=("capacity", "n_lanes"))
def _assemble_prepack(bucket_pts, bucket_idx, nrows, *, capacity: int, n_lanes: int):
    """Device assembly of the candidate windows from the bucket tensors.

    When ``n_lanes`` is below the raw 27*capacity width, each window is
    COMPACTED: live slots sort to the front (stable in (neighbor-offset,
    bucket-slot) order, so engine tie-order parity is preserved) and the
    dead-slot tail beyond the largest real union is sliced away — the select
    kernel's per-row extraction cost is proportional to this width.
    """
    ud = nrows.shape[0]
    u = bucket_pts.shape[0]
    dtype = bucket_pts.dtype
    l_full = 27 * capacity
    if n_lanes < l_full:
        # Closed-form packed gather — no sort: within each bucket the live
        # slots are contiguous from slot 0, so packed position p of window u
        # maps to (neighbor j, slot p - start_j) where start_j is the
        # exclusive cumsum of live counts. Values come from whole-bucket
        # contiguous gathers (768 B rows at cap 64) followed by a within-row
        # take_along_axis shuffle — per-element random gathers over the flat
        # bucket tensors measured ~20% slower (21.4 vs 17.7 ms at 35k), and a
        # per-pair device argsort over (UD, 27*cap) ~170 ms.
        safe = jnp.maximum(nrows, 0)  # (UD, 27)
        cnt_cell = jnp.sum(bucket_idx >= 0, axis=1).astype(jnp.int32)  # (U,)
        cnt = jnp.where(nrows >= 0, cnt_cell[safe], 0)  # (UD, 27)
        starts = jnp.cumsum(cnt, axis=1) - cnt  # exclusive prefix
        total = jnp.sum(cnt, axis=1)  # (UD,)
        p = jnp.arange(n_lanes, dtype=jnp.int32)
        owner = (
            jnp.sum(
                starts[:, None, :] <= p[None, :, None], axis=2, dtype=jnp.int32
            )
            - 1
        )  # (UD, n_lanes): last neighbor whose start <= p
        owner = jnp.clip(owner, 0, 26)
        slot = p[None, :] - jnp.take_along_axis(starts, owner, axis=1)
        rel = owner * capacity + slot  # position within the window's own row
        live = p[None, :] < total[:, None]
        rel = jnp.where(live, rel, 0)
        pts = bucket_pts[safe]  # (UD, 27, cap, 3) contiguous bucket rows
        idx = jnp.where(nrows[..., None] < 0, -1, bucket_idx[safe])
        flat_idx = jnp.where(
            live, jnp.take_along_axis(idx.reshape(ud, l_full), rel, axis=1), -1
        )
        flat_pts = jnp.take_along_axis(
            pts.reshape(ud, l_full, 3), rel[..., None], axis=1
        )
        pad = 0
    else:
        pts = bucket_pts[jnp.maximum(nrows, 0)]  # (UD, 27, cap, 3)
        idx = bucket_idx[jnp.maximum(nrows, 0)]  # (UD, 27, cap)
        idx = jnp.where(nrows[..., None] < 0, -1, idx)
        flat_idx = idx.reshape(ud, l_full)
        flat_pts = pts.reshape(ud, l_full, 3)
        pad = n_lanes - l_full
    flat_pts = jnp.where((flat_idx < 0)[..., None], jnp.asarray(_BIG, dtype), flat_pts)
    flat_xyz = jnp.transpose(flat_pts, (0, 2, 1))
    cand_xyz = jnp.pad(flat_xyz, ((0, 1), (0, 0), (0, pad)),
                       constant_values=_BIG)
    cand_idx = jnp.pad(flat_idx, ((0, 1), (0, pad)), constant_values=-1)
    return cand_xyz, cand_idx


@partial(jax.jit, static_argnames=("capacity", "n_lanes", "prod_d", "prod_e", "ud_pad"))
def _build_prepack_dev(bucket_pts, bucket_idx, base_e, d_cells_e, off_e,
                       d_cells, row_vals, *, capacity, n_lanes, prod_d,
                       prod_e, ud_pad):
    """Device half of the dense prepack as ONE program (same seeds-only
    scheme as fused_pool._build_pools: the host ships ~KB of cell-id seeds
    instead of the (UD, 27) neighbor-row table + dense LUT, and the ctor
    pays one dispatch instead of several). Window rows [UD, ud_pad) are
    dead padding (bucketed row count — stable shapes across a sequence)."""
    from .fused_pool import _neighbor_rows, _scatter_lut

    lut_d = _scatter_lut(d_cells, row_vals, prod_d=prod_d)
    nrows_real = _neighbor_rows(base_e, d_cells_e, off_e, prod_e=prod_e)
    nrows = (
        jnp.full((ud_pad, 27), -1, jnp.int32)
        .at[row_vals]
        .set(nrows_real, mode="drop")
    )
    cand_xyz, cand_idx = _assemble_prepack.__wrapped__(
        bucket_pts, bucket_idx, nrows, capacity=capacity, n_lanes=n_lanes
    )
    return cand_xyz, cand_idx, lut_d


def build_prepack(grid_host: dict, device_grid) -> PrepackedGrid | None:
    """Build the per-pair fused-search state.

    Args:
      grid_host: dict from ops.grid.build_grid_host (numpy arrays).
      device_grid: the HashGrid already on device (bucket tensors reused).
    """
    dil = dilate_cells_host(grid_host, dense_lut=False)
    if dil is None:
        return None
    capacity = grid_host["capacity"]
    # Packed lane width: the largest real candidate union, never more than
    # the raw 27*capacity window — bucketed at ~12.5% granularity (128-lane
    # floor) so scan-to-scan max-union noise doesn't recompile the pair
    # programs; the select reads only lanes up to each window's own width
    # (width_lut), so dead lanes cost <=12.5% extra prepack gather.
    n_lanes = min(
        round_up(27 * capacity, 128),
        _bucket_rows(max(dil["max_union"], 128), 128),
    )
    # Bucketed window count: dead rows at the tail (dropped-scatter row ids,
    # zero width) keep every downstream shape stable across similar scans.
    ud = dil["n_dilated"]
    ud_pad = _bucket_rows(ud)

    def pad1(a, length, value):
        out = np.full((length,), value, a.dtype)
        out[: a.shape[0]] = a
        return out

    prod_d_pad = _pow2(dil["prod_d"])
    prod_e_pad = _pow2(dil["prod_e"])
    width_lut = np.zeros((ud_pad + 1,), np.int32)
    width_lut[:ud] = np.minimum(dil["width_lut"][:ud], n_lanes)
    dev = jax.device_put(
        {
            "base_e": pad1(
                dil["base_e"].astype(np.int32),
                _bucket_rows(dil["base_e"].shape[0]),
                prod_e_pad,
            ),
            "d_cells_e": pad1(dil["d_cells_e"].astype(np.int32), ud_pad, 0),
            "off_e": dil["off_e"],
            "d_cells": pad1(
                dil["d_cells"].astype(np.int32), ud_pad, prod_d_pad
            ),
            "row_vals": pad1(
                np.arange(ud, dtype=np.int32), ud_pad, ud_pad
            ),
            "dims_d": dil["dims_d"],
            "origin_d": dil["origin_d"].astype(
                np.dtype(device_grid.bucket_pts.dtype)
            ),
            "width_lut": width_lut,
        }
    )
    cand_xyz, cand_idx, lut_d = _build_prepack_dev(
        device_grid.bucket_pts,
        device_grid.bucket_idx,
        dev["base_e"],
        dev["d_cells_e"],
        dev["off_e"],
        dev["d_cells"],
        dev["row_vals"],
        capacity=capacity,
        n_lanes=n_lanes,
        prod_d=prod_d_pad,
        prod_e=prod_e_pad,
        ud_pad=ud_pad,
    )
    return PrepackedGrid(
        cand_xyz=cand_xyz,
        cand_idx=cand_idx,
        width_lut=dev["width_lut"],
        lut_d=lut_d,
        origin_d=dev["origin_d"],
        dims_d=dev["dims_d"],
        n_lanes=n_lanes,
        n_dilated=dil["n_dilated"],
        cell_size=grid_host["cell_size"],
    )


def _group_by_window(source, source_valid, lut_d, origin_d, dims_d, ud,
                     radius, s_pad: int):
    """Phases 1-2 of the fused and pooled engines: map each source to its
    window row and sort same-window sources into cell-pure GROUP-row blocks.

    ``lut_d`` maps an extended-grid cell to its window row (-1: no
    neighbours possible); ``ud`` is the dead window row.

    Returns (padded, step_rows, order, dst, overflow):
      padded: (s_pad, 4) sorted sources, lane 3 the valid flag (1 for a
        source, 0 for an unfilled slot).
      step_rows: (s_pad // GROUP,) window row per group (ud = dead window).
      order / dst: the sort permutation and each source's padded-row slot
        (callers un-sort the kernel outputs with these).
      overflow: count of sources past the ``s_pad`` row budget (caller must
        redo the iteration with an XLA engine when nonzero).
    """
    n = source.shape[0]
    dtype = source.dtype
    ng = s_pad // GROUP
    cell = jnp.asarray(radius, dtype)

    # 1. source cell -> dilated-window row (UD = dead window).
    ijk = jnp.floor((source - origin_d.astype(dtype)) / cell).astype(jnp.int32)
    inb = jnp.all((ijk >= 0) & (ijk < dims_d[None, :]), axis=-1) & source_valid
    safe = jnp.clip(ijk, 0, dims_d[None, :] - 1)
    lin = safe[:, 0] + dims_d[0] * (safe[:, 1] + dims_d[1] * safe[:, 2])
    row = jnp.where(inb, lut_d[lin], -1)
    row = jnp.where(row < 0, ud, row)  # no-neighbor sources -> dead window

    # 2. group same-cell sources into cell-pure GROUP-row blocks.
    # Dead-window sources (provably zero neighbors: outside the dilated
    # occupied set) are DROPPED from the grouping instead of packed into
    # dead-window groups: at KITTI scale ~27% of moved sources land there
    # and used to consume 36k of the 90k budget groups — pure pass
    # overhead. They sort to the tail (ud is the max row), allocate no
    # group, scatter nowhere (dst = s_pad is dropped), and _unsort_results
    # maps them to mask=False — exactly the result the kernel's dead
    # branch produced for them.
    # One sort delivers both the permutation and the sorted keys.
    rs, order = lax.sort_key_val(row, jnp.arange(n, dtype=jnp.int32))
    dead = rs == ud
    pos = jnp.arange(n, dtype=jnp.int32)
    starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), rs[1:] != rs[:-1]]
    )
    start_pos = lax.associative_scan(jnp.maximum, jnp.where(starts, pos, -1))
    local = pos - start_pos
    gstart = (starts | (local % GROUP == 0)) & jnp.logical_not(dead)
    gid = jnp.cumsum(gstart.astype(jnp.int32)) - 1
    dst = jnp.where(dead, s_pad, gid * GROUP + local % GROUP)
    overflow = jnp.sum(jnp.where(dst >= s_pad, 1, 0)) - jnp.sum(dead)

    src_sorted = source[order]
    # Inverse-map + gather instead of a direct (N, 4) scatter: an s32
    # slot->source scatter + one 16 B-row gather; unfilled slots gather
    # the zero row (valid flag 0).
    slot2src = (
        jnp.full((s_pad,), n, jnp.int32)
        .at[dst]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    src5 = jnp.concatenate(
        [
            jnp.concatenate(
                [src_sorted, jnp.ones((n, 1), dtype)], axis=1
            ),
            jnp.zeros((1, 4), dtype),
        ]
    )
    padded = src5[slot2src]
    step_rows = (
        jnp.full((ng,), ud, jnp.int32)
        .at[jnp.where(dead, ng, gid)]
        .set(rs, mode="drop")
    )
    return padded, step_rows, order, dst, overflow


def select_cols(k: int) -> int:
    """Output columns of a select: k rounded up to a power of two >= 32."""
    return max(32, 1 << (k - 1).bit_length())


def _xla_class_select(rows4, win_xyz, win_idx, *, k, kp, radius,
                      return_points):
    """Plain-XLA select over pre-gathered windows: distances + ``lax.top_k``.

    ``rows4``: (B*GROUP, 4) padded sources (xyz + the valid flag in lane
    3), ``win_xyz``: (B, 3, w) per-group candidate
    windows, ``win_idx``: (B, w). Returns (outd, outi, outp) at ``kp``
    columns: the k smallest in-radius f32 squared distances per row,
    ascending, with their target indices (-1 = empty) and, with
    ``return_points``, the three coordinate planes of the chosen
    candidates. ``lax.top_k`` on the negated distances breaks ties toward
    the lower lane, so slots follow the (distance, lane) order of the
    candidate enumeration; for w <= k it is a full stable sort.
    """
    b, _, w = win_xyz.shape
    big = jnp.float32(3e38)
    src = rows4.reshape(b, GROUP, 4).astype(jnp.float32)
    wx = win_xyz.astype(jnp.float32)
    # Same expression, in the same order, as the select kernel.
    dx = wx[:, None, 0, :] - src[:, :, 0:1]
    dy = wx[:, None, 1, :] - src[:, :, 1:2]
    dz = wx[:, None, 2, :] - src[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz  # (B, G, w)
    live = (
        (win_idx[:, None, :] >= 0)
        & (src[:, :, 3:4] > 0)
        & (d2 <= jnp.float32(radius) ** 2)
    )
    d2 = jnp.where(live, d2, big)
    kk = min(k, w)
    negd, args = lax.top_k(-d2.reshape(b * GROUP, w), kk)
    outd = -negd
    found = outd < big
    gargs = args.reshape(b, GROUP, kk)
    outi = jnp.take_along_axis(
        jnp.broadcast_to(win_idx[:, None, :], (b, GROUP, w)), gargs, axis=2
    ).reshape(b * GROUP, kk)
    outi = jnp.where(found, outi, -1)
    pad = kp - kk
    outd = jnp.pad(outd, ((0, 0), (0, pad)), constant_values=big)
    outi = jnp.pad(outi, ((0, 0), (0, pad)), constant_values=-1)
    if not return_points:
        return outd, outi, None
    pts = jnp.take_along_axis(
        jnp.broadcast_to(wx[:, None, :, :], (b, GROUP, 3, w)),
        gargs[:, :, None, :],
        axis=3,
    ).reshape(b * GROUP, 3, kk)
    pts = jnp.where(found[:, None, :], pts, 0.0)
    pts = jnp.pad(pts, ((0, 0), (0, 0), (0, pad)))
    return outd, outi, tuple(pts[:, i, :] for i in range(3))


def select_windows(rows4, pool_xyz, pool_idx, win, width_lut, *, k, radius,
                   return_points, select_max_w):
    """k-nearest select of every group's window, by the backend's choice.

    ``rows4``: (B*GROUP, 4) padded sources, ``pool_xyz``: (R, 3, W) and
    ``pool_idx``: (R, W) candidate windows, ``win``: (B,) window row of
    each group, ``width_lut``: (R,) lanes up to each window's last live
    candidate. Windows wider than ``select_max_w`` run the Pallas kernel
    (ops/select_kernel.py), which reads the pool in place; narrower ones
    gather their windows and select in XLA. Both give the same slots.
    Returns (outd, outi, outp) at :func:`select_cols` columns.
    """
    kp = select_cols(k)
    if pool_xyz.shape[-1] > select_max_w:
        return kernel_select(
            rows4, pool_xyz, pool_idx, win, width_lut, k=k, kp=kp,
            radius=radius, return_points=return_points,
        )
    return _xla_class_select(
        rows4, pool_xyz[win], pool_idx[win], k=k, kp=kp, radius=radius,
        return_points=return_points,
    )


def _unsort_results(outd, outi, outp, order, dst, *, k, n, dtype):
    """Map kernel outputs (padded-row order) back to original source order."""
    s_pad = outd.shape[0]
    inv = jnp.full((n,), s_pad, jnp.int32).at[order].set(
        jnp.where(dst < s_pad, dst, s_pad), mode="drop"
    )
    in_range = inv < s_pad
    inv_safe = jnp.minimum(inv, s_pad - 1)
    d_rows = outd[inv_safe][:, :k]
    i_rows = outi[inv_safe][:, :k]
    found = (i_rows >= 0) & in_range[:, None]
    corr = Correspondences(
        indices=jnp.where(found, i_rows, 0),
        sq_dists=jnp.where(found, d_rows.astype(dtype), 0.0),
        mask=found,
    )
    if outp is None:
        return corr, None
    p_rows = jnp.stack(
        [o[inv_safe][:, :k] for o in outp], axis=-1
    )  # (n, k, 3)
    pts = jnp.where(found[..., None], p_rows.astype(dtype), 0.0)
    return corr, pts


@partial(
    jax.jit,
    static_argnames=("k", "radius", "budget_rows", "return_points",
                     "select_max_w"),
)
def fused_grid_search(
    source,
    source_valid,
    cand_xyz,
    cand_idx,
    width_lut,
    lut_d,
    origin_d,
    dims_d,
    *,
    k: int,
    radius: float,
    budget_rows: int | None = None,
    return_points: bool = False,
    select_max_w: int = backend.SELECT_MAX_W,
):
    """Radius-capped KNN via cell-grouped windows + :func:`select_windows`.

    Same contract as ops.grid.grid_radius_search.

    Returns (Correspondences, overflow[, points]) where overflow > 0 means
    the group-row budget (``budget_rows``, default 2N) overflowed
    (pathologically scattered sources) and the caller must re-run the
    iteration with an XLA engine. ``return_points=True`` appends the selected
    neighbors' coordinates (N, k, 3) from the select itself, which replaces
    the caller's 12 B-granularity ``target[indices]`` gather.
    """
    n = source.shape[0]
    dtype = source.dtype
    ud = cand_idx.shape[0] - 1  # last row is the dead window
    s_pad = round_up(budget_rows or 2 * n, BLOCK_GROUPS * GROUP)

    padded, step_rows, order, dst, overflow = _group_by_window(
        source, source_valid, lut_d, origin_d, dims_d, ud, radius, s_pad,
    )
    outd, outi, outp = select_windows(
        padded, cand_xyz, cand_idx, step_rows, width_lut, k=k,
        radius=radius, return_points=return_points, select_max_w=select_max_w,
    )
    corr, pts = _unsort_results(
        outd, outi, outp, order, dst, k=k, n=n, dtype=dtype
    )
    if return_points:
        return corr, overflow, pts
    return corr, overflow
