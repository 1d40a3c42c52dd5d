"""Width classes of the pooled engine: planning + kernel/XLA path parity.

The pooled engine splits its candidate windows into pow2 width classes
down to fused_pool.MIN_CLASS_LANES, one window per pool row. These tests
pin:
  * the class binning on a sparse scan and on one with a dense hot spot,
  * slot-for-slot parity of the all-kernel path (select_max_w=0, interpret
    mode on CPU) against the XLA grid engine, and against the all-XLA path,
  * exact-distance tie ordering by lane in both selects.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import (
    pad_cloud,
    round_up,
    valid_mask,
)
from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp
from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
    GROUP,
    _xla_class_select,
)
from probabilistic_point_clouds_registration_tpu.ops.grid import (
    build_grid,
    build_grid_host,
    grid_search,
)
from probabilistic_point_clouds_registration_tpu.ops.select_kernel import (
    kernel_select,
)

K, RADIUS = 8, 0.5


def _pair(n=2500, seed=2, blob=0):
    """A sparse scan (~1 point per 0.5 m cell); ``blob`` points packed
    into one cell add a dense hot spot (wide windows around it)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 25, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=n)
    tgt[:blob] = np.array([12.2, 12.2, 0.1]) + rng.uniform(
        0, 0.4, size=(blob, 3)
    )
    src = tgt + np.array([0.2, 0.05, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


def _plan(tgt):
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    gh = build_grid_host(tgt_p, RADIUS, num_valid=n_tgt, max_overflow=64)
    plan = fp.plan_pool_host(gh, tgt_p)
    assert plan is not None
    return gh, tgt_p, n_tgt, plan


def _search(src, gh, tgt_p, plan, select_max_w):
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    pre = fp.build_pool_prepack(gh, tgt_p, plan=plan, select_max_w=select_max_w)
    sv = valid_mask(src_p.shape[0], n_src)
    # 8x source rows: the drifted fixture scatters sources away from the
    # aligned packing the plan predicted (production escalates on overflow).
    budget = round_up(max(pre.budget_rows, 8 * src_p.shape[0]), 512)
    corr, overflow, pts = fp.fused_pool_search(
        jnp.asarray(src_p, jnp.float32), sv,
        pre.pool_xyz, pre.pool_idx, pre.width_lut, pre.lut_d, pre.origin_d,
        pre.dims_d, k=K, radius=RADIUS, class_widths=pre.class_widths,
        class_ends=pre.class_ends, class_budgets=pre.class_budgets,
        budget_rows=budget, return_points=True, select_max_w=select_max_w,
    )
    assert int(overflow) == 0
    return src_p, n_src, sv, corr, pts


@pytest.mark.parametrize("blob", [0, 48], ids=["sparse", "hot_spot"])
def test_class_binning(blob):
    """Classes are pow2 widths, descending, down to MIN_CLASS_LANES; every
    window sits in the narrowest class that holds its union."""
    _, tgt = _pair(blob=blob)
    _, _, _, plan = _plan(tgt)
    widths = plan["widths"]
    assert widths == sorted(widths, reverse=True)
    assert min(widths) == fp.MIN_CLASS_LANES
    assert all(w & (w - 1) == 0 for w in widths)
    union = plan["dil"]["union"]
    # Real windows head each class's padded row range, in width order.
    start = 0
    for c, (w, e) in enumerate(zip(widths, plan["ends"])):
        rows = plan["row_vals"][: union.shape[0]]
        u = union[(rows >= start) & (rows < e)]
        assert u.size and u.max() <= w
        if c < len(widths) - 1:
            assert u.min() > w // 2
        start = e
    if blob:
        assert widths[0] >= 64


@pytest.mark.parametrize("blob", [0, 48], ids=["sparse", "hot_spot"])
def test_kernel_path_matches_grid_engine(blob):
    """Every class through the Pallas kernel (select_max_w=0):
    slot-for-slot parity vs the XLA grid engine."""
    src, tgt = _pair(blob=blob)
    gh, tgt_p, n_tgt, plan = _plan(tgt)
    src_p, n_src, sv, got, pts = _search(src, gh, tgt_p, plan, 0)

    grid = build_grid(tgt_p, RADIUS, num_valid=n_tgt, max_overflow=64)
    grid = grid._replace(
        bucket_pts=jnp.asarray(grid.bucket_pts, jnp.float32),
        origin=jnp.asarray(grid.origin, jnp.float32),
        overflow_pts=None if grid.overflow_pts is None
        else jnp.asarray(grid.overflow_pts, jnp.float32),
    )
    ref = grid_search(
        grid, jnp.asarray(src_p, jnp.float32), k=K, radius=RADIUS,
        source_valid=sv,
    )
    m = np.asarray(ref.mask)[:n_src]
    np.testing.assert_array_equal(np.asarray(got.mask)[:n_src], m)
    np.testing.assert_array_equal(
        np.asarray(got.indices)[:n_src][m], np.asarray(ref.indices)[:n_src][m]
    )
    gathered = np.asarray(tgt_p)[np.asarray(got.indices)[:n_src]]
    np.testing.assert_array_equal(
        np.asarray(pts)[:n_src][m], gathered.astype(np.float32)[m]
    )


@pytest.mark.parametrize("blob", [0, 48], ids=["sparse", "hot_spot"])
def test_kernel_path_matches_xla_path(blob):
    """The all-kernel and all-XLA selects give the same slots, distances
    and points over every class of the plan."""
    src, tgt = _pair(blob=blob)
    gh, tgt_p, _, plan = _plan(tgt)
    _, n_src, _, kern, kpts = _search(src, gh, tgt_p, plan, 0)
    _, _, _, xla, xpts = _search(src, gh, tgt_p, plan, 1 << 30)
    np.testing.assert_array_equal(
        np.asarray(kern.mask)[:n_src], np.asarray(xla.mask)[:n_src]
    )
    np.testing.assert_array_equal(
        np.asarray(kern.indices)[:n_src], np.asarray(xla.indices)[:n_src]
    )
    np.testing.assert_array_equal(
        np.asarray(kern.sq_dists)[:n_src], np.asarray(xla.sq_dists)[:n_src]
    )
    np.testing.assert_array_equal(
        np.asarray(kpts)[:n_src], np.asarray(xpts)[:n_src]
    )


def _tie_window(w=256, groups=16):
    """Window 0: candidates at distance 1 and an exact tie pair at distance
    2 (lanes 3 and 5), plus a far tie (lanes 130, 200) past the first
    128-lane chunk. Row 0 of group 0 sits at the origin."""
    win_xyz = np.full((groups, 3, w), 1e30, np.float32)
    win_idx = np.full((groups, w), -1, np.int32)
    win_xyz[0, :, 0] = [1.0, 0.0, 0.0]
    win_xyz[0, :, 3] = [0.0, 2.0, 0.0]
    win_xyz[0, :, 5] = [2.0, 0.0, 0.0]  # same |.|^2 = 4 as lane 3
    win_xyz[0, :, 130] = [0.0, 0.0, 2.5]
    win_xyz[0, :, 200] = [0.0, -2.5, 0.0]  # same |.|^2 as lane 130
    win_idx[0, [0, 3, 5, 130, 200]] = [10, 11, 12, 13, 14]
    rows4 = np.zeros((groups * GROUP, 4), np.float32)
    rows4[0, 3] = 1.0
    return rows4, win_xyz, win_idx


@pytest.mark.parametrize("select", ["kernel", "xla"])
def test_tie_order_within_window(select):
    """Exact-distance ties resolve by candidate lane, also across the
    kernel's lane chunks; invalid rows find nothing."""
    rows4, win_xyz, win_idx = _tie_window()
    groups = win_xyz.shape[0]
    if select == "kernel":
        outd, outi, _ = kernel_select(
            jnp.asarray(rows4), jnp.asarray(win_xyz), jnp.asarray(win_idx),
            jnp.arange(groups, dtype=jnp.int32),
            jnp.full((groups,), win_xyz.shape[-1], jnp.int32),
            k=4, kp=32, radius=3.0, return_points=False,
        )
    else:
        outd, outi, _ = _xla_class_select(
            jnp.asarray(rows4), jnp.asarray(win_xyz), jnp.asarray(win_idx),
            k=4, kp=32, radius=3.0, return_points=False,
        )
    outi, outd = np.asarray(outi), np.asarray(outd)
    assert outi[0, :4].tolist() == [10, 11, 12, 13]
    np.testing.assert_allclose(outd[0, :4], [1.0, 4.0, 4.0, 6.25])
    assert (outi[1:, :4] == -1).all()
