"""Demand-based row budget for the pooled engine.

The plan's row budget is a target-occupancy proxy; real pairs (a source
that is NOT the target plus a shift) land sources in dilated shell cells
the proxy scores zero, undercounting padded rows ~1.5x at KITTI-like
density. estimate_pool_demand_rows must replay the device grouping's
arithmetic exactly so the ctor can size the first compiled program to the
real pair and never burn a discarded chunk + second compile on the
overflow ladder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import (
    pad_cloud,
    round_up,
)
from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp
from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
    BLOCK_GROUPS,
    GROUP,
    _group_by_window,
)
from probabilistic_point_clouds_registration_tpu.ops.grid import (
    build_grid_host,
)


def _drifted_pair(n=6000, seed=0, radius=0.35):
    """Source is a DIFFERENT sampling of the target's region — the
    sequence-odometry situation the center-count proxy undercounts."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 14, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=n)
    src = rng.uniform(0, 14, size=(n, 3))
    src[:, 2] = rng.normal(scale=0.4, size=n)
    return src, tgt, radius


def _plan_and_pool(tgt, radius, k=8):
    tg, n_tgt = pad_cloud(tgt, 256, pad_value=0.0)
    grid = build_grid_host(tg, radius, num_valid=n_tgt)
    assert grid is not None
    plan = fp.plan_pool_host(grid, tg)
    assert plan is not None
    pool = fp.build_pool_prepack(grid, tg, plan=plan)
    assert pool is not None
    return tg, plan, pool


def _real_rows_used(pool, src, radius, s_pad):
    fs, n_src = pad_cloud(src, 256, pad_value=0.0)
    valid = jnp.asarray(np.arange(fs.shape[0]) < n_src)
    n_rows = pool.width_lut.shape[0] - 1
    padded, step_rows, order, dst, overflow = _group_by_window(
        jnp.asarray(fs, jnp.float32), valid, pool.lut_d, pool.origin_d,
        pool.dims_d, n_rows, radius, s_pad,
    )
    return int(overflow)


def test_demand_estimate_is_exact_bound():
    src, tgt, radius = _drifted_pair()
    tg, plan, pool = _plan_and_pool(tgt, radius)
    demand = fp.estimate_pool_demand_rows(plan, src)
    assert demand > 0
    # At the estimated demand (padded to the kernel block multiple) the
    # device grouping must NOT overflow...
    s_pad = round_up(max(demand, 2 * BLOCK_GROUPS * GROUP),
                     2 * BLOCK_GROUPS * GROUP)
    assert _real_rows_used(pool, src, radius, s_pad) == 0
    # ...and the estimate is tight: meaningfully undercutting it overflows
    # (the estimate replays the real grouping, not a loose upper bound).
    lo = round_up(max(demand // 2, 2 * BLOCK_GROUPS * GROUP),
                  2 * BLOCK_GROUPS * GROUP)
    if lo < s_pad:
        assert _real_rows_used(pool, src, radius, lo) > 0


def test_demand_exact_on_self_pair_too():
    """Exactness holds for the benchmark fixture (src = tgt + shift) as
    well — the bound is the real grouping, not a drift-only special case."""
    rng = np.random.default_rng(11)
    tgt = rng.uniform(0, 14, size=(5000, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=5000)
    src = tgt + np.array([0.07, -0.04, 0.01])
    tg, plan, pool = _plan_and_pool(tgt, 0.35)
    demand = fp.estimate_pool_demand_rows(plan, src)
    s_pad = round_up(max(demand, 2 * BLOCK_GROUPS * GROUP),
                     2 * BLOCK_GROUPS * GROUP)
    assert _real_rows_used(pool, src, 0.35, s_pad) == 0


def test_self_pair_demand_within_plan_budget():
    """src = tgt + small shift (the benchmark fixture): the proxy holds and
    the demand-based budget must not inflate the program."""
    rng = np.random.default_rng(5)
    tgt = rng.uniform(0, 14, size=(6000, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=6000)
    src = tgt + np.array([0.05, 0.02, 0.0])
    tg, plan, pool = _plan_and_pool(tgt, 0.35)
    demand = fp.estimate_pool_demand_rows(plan, src)
    assert int(1.25 * demand) <= 2 * plan["budget_rows"]


def test_registration_uses_demand_budget_no_overflow(capsys):
    """End-to-end: a drifted pair registers WITHOUT the overflow-retry
    message (previously: discarded chunk + 2x-budget recompile)."""
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        ProbabilisticRegistration,
    )

    src, tgt, radius = _drifted_pair(n=4000, seed=7)
    params = RegistrationParams(
        max_neighbours=8, radius=radius, n_iter=4, dof=5.0,
        dtype="float32", pad_multiple=256, outer_chunk=4,
        search_impl="pool", verbose=True,
    )
    reg = ProbabilisticRegistration(src, tgt, params)
    assert reg._pool is not None
    assert reg._pool_budget_base >= reg._pool.budget_rows
    reg.align()
    out = capsys.readouterr().out
    assert "budget overflow" not in out


def test_demand_per_class_groups_match_device_grouping():
    """estimate_pool_demand_rows(class_row_ends=...) must return per-class
    cumulative group counts that (a) sum to the total row demand and
    (b) upper-bound the device grouping's real class boundaries — the
    dispatch sizes class-PREFIX budgets from them (1.25x margin), so an
    undercount would fire the coverage flag on every healthy pair."""
    src, tgt, radius = _drifted_pair(seed=3)
    tg, plan, pool = _plan_and_pool(tgt, radius)
    total, cum = fp.estimate_pool_demand_rows(
        plan, src, class_row_ends=pool.class_ends
    )
    assert total == fp.estimate_pool_demand_rows(plan, src)
    assert len(cum) == len(pool.class_ends)
    assert all(b >= a for a, b in zip(cum, cum[1:])), cum
    assert cum[-1] * GROUP == total

    # Device check: group the real source and count groups whose pool row
    # falls in each class — the replay must match exactly.
    fs, n_src = pad_cloud(src, 256, pad_value=0.0)
    valid = jnp.asarray(np.arange(fs.shape[0]) < n_src)
    n_rows = pool.width_lut.shape[0] - 1
    s_pad = round_up(max(total, 2 * BLOCK_GROUPS * GROUP),
                     2 * BLOCK_GROUPS * GROUP)
    padded, step_rows, order, dst, overflow = _group_by_window(
        jnp.asarray(fs, jnp.float32), valid, pool.lut_d, pool.origin_d,
        pool.dims_d, n_rows, radius, s_pad,
    )
    assert int(overflow) == 0
    rows = np.asarray(step_rows)
    live = rows < n_rows
    for c, e in zip(cum, pool.class_ends):
        assert int((live & (rows < e)).sum()) == c
