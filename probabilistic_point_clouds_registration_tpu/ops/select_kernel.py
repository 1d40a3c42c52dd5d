"""Pallas select kernel for the pooled and fused engines (Triton route).

For each padded source row, the k nearest in-radius candidates of its
group's window: the k smallest f32 squared distances, ascending, ties broken
by lane. Same contract, slot for slot, as the plain-XLA select
(``fused_grid._xla_class_select``), which is its reference.

The XLA select gathers every group's whole window into device memory,
writes the (rows x width) distance matrix and runs ``lax.top_k`` over it.
This kernel never materializes either: each program takes ``KERNEL_GROUPS``
groups (8 source rows each), reads its windows straight out of the pool by
row id, and streams them in lane chunks of at most 128, keeping the running
k best of every row in registers. A chunk costs one extraction round per
candidate that beats the row's current k-th best, so once the running set
is full, later chunks mostly cost their distance pass alone. The chunk
count is the block's own widest window (``width_lut``), so narrow windows
read only their own lanes.

Ties: the running set and the final sort order candidates by the pair
(distance, lane), which is the candidate enumeration order of every engine.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import backend

# Cell-pure source rows per group (the grouping's unit, ops/fused_grid.py).
_GROUP = 8
# Groups per program: 32 source rows keep the (rows x chunk) distance tile
# at 32 f32 registers per thread with four warps.
KERNEL_GROUPS = 4
# Lanes per streamed chunk.
CHUNK = 128
_BIG = np.float32(3e38)
# Lane sentinel above any real lane; empty running slots get _LANE_BIG + col
# so every slot's (distance, lane) key is distinct.
_LANE_BIG = np.int32(1 << 30)


def _select_kernel(win_ref, wl_ref, rows_ref, pxyz_ref, pidx_ref, outd_ref,
                   outi_ref, *outp_refs, k, kp, r2, ch, w):
    p = pl.program_id(0)
    nr = KERNEL_GROUPS * _GROUP
    r = jnp.arange(nr, dtype=jnp.int32)
    row = p * nr + r
    win = plgpu.load(win_ref.at[p * KERNEL_GROUPS + r // _GROUP])
    n_chunks = (jnp.max(plgpu.load(wl_ref.at[win])) + ch - 1) // ch
    sx = plgpu.load(rows_ref.at[row, 0])[:, None]
    sy = plgpu.load(rows_ref.at[row, 1])[:, None]
    sz = plgpu.load(rows_ref.at[row, 2])[:, None]
    valid = plgpu.load(rows_ref.at[row, 3])[:, None] > 0
    wrow = win[:, None]
    col = jnp.arange(kp, dtype=jnp.int32)[None, :]
    lane0 = jnp.arange(ch, dtype=jnp.int32)[None, :]

    def chunk_best(d2, lane):
        m = jnp.min(d2, axis=1)
        ml = jnp.min(jnp.where(d2 == m[:, None], lane, _LANE_BIG), axis=1)
        return m, ml

    def worst(bd, bl):
        wd = jnp.max(bd, axis=1)
        wl = jnp.max(jnp.where(bd == wd[:, None], bl, -1), axis=1)
        return wd, wl

    def beats(m, ml, wd, wl):
        return (m < _BIG) & ((m < wd) | ((m == wd) & (ml < wl)))

    def chunk_body(c, carry):
        lane = c * ch + lane0
        cx = plgpu.load(pxyz_ref.at[wrow, lane]).astype(jnp.float32)
        cy = plgpu.load(pxyz_ref.at[wrow, w + lane]).astype(jnp.float32)
        cz = plgpu.load(pxyz_ref.at[wrow, 2 * w + lane]).astype(jnp.float32)
        ci = plgpu.load(pidx_ref.at[wrow, lane])
        dx = cx - sx
        dy = cy - sy
        dz = cz - sz
        d2 = dx * dx + dy * dy + dz * dz
        live = (ci >= 0) & valid & (d2 <= r2)
        d2 = jnp.where(live, d2, _BIG)

        def any_beats(d2, bd, bl):
            return jnp.max(beats(*chunk_best(d2, lane), *worst(bd, bl))
                           .astype(jnp.int32)) > 0

        def round_body(s):
            d2, bd, bl, _ = s
            m, ml = chunk_best(d2, lane)
            wd, wl = worst(bd, bl)
            ins = beats(m, ml, wd, wl)[:, None]
            at = ins & (bd == wd[:, None]) & (bl == wl[:, None])
            bd = jnp.where(at, m[:, None], bd)
            bl = jnp.where(at, ml[:, None], bl)
            d2 = jnp.where(ins & (lane == ml[:, None]), _BIG, d2)
            return d2, bd, bl, any_beats(d2, bd, bl)

        bd, bl = carry
        _, bd, bl, _ = lax.while_loop(
            lambda s: s[3], round_body, (d2, bd, bl, any_beats(d2, bd, bl))
        )
        return bd, bl

    # Slots >= k hold -1, which no candidate ever displaces.
    bd0 = jnp.where(col < k, _BIG, -1.0) + jnp.zeros((nr, kp), jnp.float32)
    bl0 = _LANE_BIG + col + jnp.zeros((nr, kp), jnp.int32)
    bd, bl = lax.fori_loop(0, n_chunks, chunk_body, (bd0, bl0))

    # Emit the running set in ascending (distance, lane) order.
    def sort_body(j, s):
        bd, outd, outl = s
        m = jnp.min(bd, axis=1)
        ml = jnp.min(jnp.where(bd == m[:, None], bl, _LANE_BIG + kp), axis=1)
        hit = (col == j) & (m < _BIG)[:, None]
        outd = jnp.where(hit, m[:, None], outd)
        outl = jnp.where(hit, ml[:, None], outl)
        return jnp.where(bl == ml[:, None], _BIG, bd), outd, outl

    _, outd, outl = lax.fori_loop(
        0, k, sort_body,
        (
            jnp.where(col < k, bd, _BIG),
            jnp.full((nr, kp), _BIG, jnp.float32),
            jnp.full((nr, kp), -1, jnp.int32),
        ),
    )
    found = outl >= 0
    safe = jnp.where(found, outl, 0)
    outd_ref[...] = outd
    outi_ref[...] = jnp.where(found, plgpu.load(pidx_ref.at[wrow, safe]), -1)
    for plane, ref in enumerate(outp_refs):
        v = plgpu.load(pxyz_ref.at[wrow, plane * w + safe])
        ref[...] = jnp.where(found, v.astype(jnp.float32), 0.0)


def kernel_select(rows4, pool_xyz, pool_idx, win, width_lut, *, k, kp,
                  radius, return_points):
    """Run the select kernel for ``win.shape[0]`` groups.

    ``rows4``: (groups * 8, 4) sources (xyz + the valid flag),
    ``pool_xyz``: (R, 3, W) and ``pool_idx``: (R, W) candidate windows,
    ``win``: (groups,) window row per group, ``width_lut``: (R,) lanes up to
    each window's last live candidate (0 = dead window). Returns
    (outd, outi, outp) at ``kp`` columns, ``outp`` the three coordinate
    planes of the chosen candidates or None.
    """
    n_rows = rows4.shape[0]
    nr = KERNEL_GROUPS * _GROUP
    if n_rows % nr or kp & (kp - 1):
        raise ValueError(
            f"rows ({n_rows}) must be a multiple of {nr} and kp ({kp}) a "
            f"power of two"
        )
    w = pool_xyz.shape[-1]
    ch = min(CHUNK, w)
    if w % ch:
        raise ValueError(f"window width {w} is not a multiple of {ch}")
    kernel = partial(
        _select_kernel, k=k, kp=kp, r2=np.float32(radius) ** 2, ch=ch, w=w,
    )
    n_out = 5 if return_points else 2
    out_shape = [
        jax.ShapeDtypeStruct((n_rows, kp), jnp.float32),
        jax.ShapeDtypeStruct((n_rows, kp), jnp.int32),
    ] + [jax.ShapeDtypeStruct((n_rows, kp), jnp.float32)] * (n_out - 2)
    whole = pl.BlockSpec(memory_space=pl.ANY)
    outs = pl.pallas_call(
        kernel,
        grid=(n_rows // nr,),
        in_specs=[whole] * 5,
        out_specs=[pl.BlockSpec((nr, kp), lambda i: (i, 0))] * n_out,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=backend.interpret_kernels(),
        name="pool_select",
    )(
        win.astype(jnp.int32),
        width_lut.astype(jnp.int32),
        rows4.astype(jnp.float32),
        pool_xyz.reshape(pool_xyz.shape[0], 3 * w),
        pool_idx,
    )
    if return_points:
        return outs[0], outs[1], tuple(outs[2:])
    return outs[0], outs[1], None
