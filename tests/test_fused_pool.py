"""Parity of the capacity-free pooled engine (ops/fused_pool.py) vs the XLA
grid engine on sparse, occupancy-skewed scans (interpret-mode kernel on CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import (
    pad_cloud,
    round_up,
    valid_mask,
)
from probabilistic_point_clouds_registration_tpu.ops.fused_pool import (
    MAX_CLASS_LANES,
    _plan_classes,
    build_pool_prepack,
    fused_pool_search,
)
from probabilistic_point_clouds_registration_tpu.ops.grid import (
    build_grid,
    build_grid_host,
    grid_search,
)


def _sparse_pair(n=3000, seed=0, hot=200):
    """LiDAR-like skew: a thin scattered sheet + one hot near-sensor blob."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 30, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.4, size=n)  # ground sheet
    tgt[:hot] = rng.normal(scale=0.15, size=(hot, 3)) + np.array([15.0, 15.0, 0.0])
    theta = 0.02
    rot = np.array([
        [np.cos(theta), -np.sin(theta), 0.0],
        [np.sin(theta), np.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ])
    src = tgt @ rot.T + np.array([0.3, 0.05, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


def _run_both(src, tgt, radius, k, max_overflow=64):
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    # The XLA reference path uses the hot-cell overflow capacity (the
    # production configuration for skewed scans); the pool engine is
    # capacity-free and must agree anyway.
    gh = build_grid_host(tgt_p, radius, num_valid=n_tgt, max_overflow=max_overflow)
    assert gh is not None
    grid = build_grid(tgt_p, radius, num_valid=n_tgt, max_overflow=max_overflow)
    grid = grid._replace(
        bucket_pts=jnp.asarray(grid.bucket_pts, jnp.float32),
        origin=jnp.asarray(grid.origin, jnp.float32),
        overflow_pts=None
        if grid.overflow_pts is None
        else jnp.asarray(grid.overflow_pts, jnp.float32),
    )
    sv = valid_mask(src_p.shape[0], n_src)
    ref = grid_search(grid, jnp.asarray(src_p, jnp.float32), k=k, radius=radius,
                      source_valid=sv)
    pre = build_pool_prepack(gh, tgt_p)
    assert pre is not None
    # Direct-call budget: 8x the source rows (the provable worst case — one
    # group per source). These fixtures shift the source by over a cell, so
    # drifted sources scatter away from the grouping the plan predicted
    # from aligned occupancy (production callers escalate the
    # budget on overflow instead; registration._align_loop).
    budget = round_up(max(pre.budget_rows, 8 * src_p.shape[0]), 128)
    got, overflow, pts = fused_pool_search(
        jnp.asarray(src_p, jnp.float32), sv,
        pre.pool_xyz, pre.pool_idx, pre.width_lut, pre.lut_d, pre.origin_d,
        pre.dims_d, k=k, radius=radius,
        class_widths=pre.class_widths, class_ends=pre.class_ends,
        class_budgets=pre.class_budgets, budget_rows=budget,
        return_points=True,
    )
    return ref, got, int(overflow), pts, n_src, tgt_p, pre


def test_pool_matches_grid_engine():
    src, tgt = _sparse_pair()
    ref, got, overflow, pts, n, tgt_p, pre = _run_both(src, tgt, radius=0.5, k=8)
    assert overflow == 0
    assert len(pre.class_widths) >= 2  # the hot blob must create a wide class
    np.testing.assert_array_equal(np.asarray(got.mask)[:n], np.asarray(ref.mask)[:n])
    m = np.asarray(ref.mask)[:n]
    np.testing.assert_array_equal(
        np.asarray(got.indices)[:n][m], np.asarray(ref.indices)[:n][m]
    )
    np.testing.assert_allclose(
        np.asarray(got.sq_dists)[:n][m].astype(np.float32),
        np.asarray(ref.sq_dists)[:n][m].astype(np.float32),
        rtol=3e-7, atol=1e-9,
    )


def test_pool_points_output_matches_gather():
    """The kernel-emitted neighbor coordinates must equal target[indices]."""
    src, tgt = _sparse_pair(n=1500, seed=3)
    ref, got, overflow, pts, n, tgt_p, _ = _run_both(src, tgt, radius=0.5, k=6)
    assert overflow == 0
    gathered = np.asarray(tgt_p)[np.asarray(got.indices)]
    m = np.asarray(got.mask)
    np.testing.assert_array_equal(
        np.asarray(pts)[m], gathered.astype(np.float32)[m]
    )
    assert not np.asarray(pts)[~m].any()


def test_pool_uniform_scan_single_class():
    """A uniform sparse scan has no wide tail: only narrow pow2 classes
    (every real union fits 128 lanes, split at pow2 sub-widths so the
    narrow classes take the XLA top_k path)."""
    rng = np.random.default_rng(7)
    tgt = rng.uniform(0, 40, size=(4000, 3)).astype(np.float32)
    src = (tgt + 0.05).astype(np.float32)
    ref, got, overflow, pts, n, _, pre = _run_both(src, tgt, radius=0.6, k=5)
    assert overflow == 0
    assert max(pre.class_widths) <= 128
    assert list(pre.class_widths) == sorted(pre.class_widths, reverse=True)
    np.testing.assert_array_equal(np.asarray(got.mask)[:n], np.asarray(ref.mask)[:n])
    m = np.asarray(ref.mask)[:n]
    np.testing.assert_array_equal(
        np.asarray(got.indices)[:n][m], np.asarray(ref.indices)[:n][m]
    )


def test_pool_budget_overflow_flag():
    """A tiny row budget must raise the overflow flag, not crash."""
    src, tgt = _sparse_pair(n=1200, seed=5)
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    gh = build_grid_host(tgt_p, 0.5, num_valid=n_tgt, max_overflow=64)
    pre = build_pool_prepack(gh, tgt_p)
    sv = valid_mask(src_p.shape[0], n_src)
    got, overflow = fused_pool_search(
        jnp.asarray(src_p, jnp.float32), sv,
        pre.pool_xyz, pre.pool_idx, pre.width_lut, pre.lut_d, pre.origin_d,
        pre.dims_d, k=5, radius=0.5,
        class_widths=pre.class_widths, class_ends=pre.class_ends,
        class_budgets=pre.class_budgets, budget_rows=256,
        )
    assert int(overflow) > 0


def test_plan_classes_boundaries():
    union = np.array([900, 600, 400, 200, 130, 90, 10, 3, 1, 1])
    widths, ends = _plan_classes(union)
    assert widths == [1024, 512, 128]
    # widths rounded up: [1024, 640->? ...]; class 0: >512 -> unions 900, 600
    # (640 lanes > 512). class 1: >128 -> 400 (512), 200 (256), 130 (256).
    assert ends == [2, 5, 10]
    # All-narrow input collapses to one class.
    widths, ends = _plan_classes(np.array([100, 50, 2]))
    assert widths == [128] and ends == [3]


def test_pool_registration_matches_grid_engine():
    """Full outer-loop registration via the pooled engine must reproduce the
    XLA grid engine's trajectory (same associations -> same solves)."""
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        register_pair,
    )

    src, tgt = _sparse_pair(n=2500, seed=11)
    finals = {}
    for impl in ("pool", "grid"):
        p = RegistrationParams(
            max_neighbours=8, radius=0.5, n_iter=4, cost_drop_thresh=-1.0,
            dof=5.0, search_impl=impl, dtype="float32", outer_chunk=2,
            grid_max_overflow=64,
        )
        T, reg = register_pair(src, tgt, p)
        if impl == "pool":
            assert reg._pool is not None, "pooled engine must have engaged"
        finals[impl] = T
    np.testing.assert_allclose(finals["pool"], finals["grid"], atol=1e-5)


def test_xla_class_select_matches_kernel():
    """_xla_class_select must be slot-for-slot identical to the Pallas
    select kernel (stable top_k ties toward the lower lane == the kernel's
    (distance, lane) order), including distances, indices, and emitted
    coordinates."""
    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        BLOCK_GROUPS,
        GROUP,
        _xla_class_select,
    )
    from probabilistic_point_clouds_registration_tpu.ops.select_kernel import (
        kernel_select,
    )
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    b, w, k, kp = BLOCK_GROUPS, 16, 8, 32
    win_xyz = rng.uniform(-1, 1, size=(b, 3, w)).astype(np.float32)
    win_idx = rng.integers(0, 500, size=(b, w)).astype(np.int32)
    win_idx[:, -3:] = -1  # dead lanes
    win_xyz[:, :, -3:] = 1e30
    # Duplicate some candidates to force exact distance ties.
    win_xyz[:, :, 5] = win_xyz[:, :, 2]
    rows = np.repeat(win_xyz.mean(axis=2)[:, None, :], GROUP, axis=1)
    rows = rows + rng.normal(scale=0.3, size=rows.shape).astype(np.float32)
    rows4 = np.concatenate(
        [
            rows.reshape(b * GROUP, 3),
            np.ones((b * GROUP, 1), np.float32),
        ],
        axis=1,
    )
    rows4[-2:, 3] = 0.0  # invalid sources
    radius = 0.9

    got = _xla_class_select(
        jnp.asarray(rows4), jnp.asarray(win_xyz), jnp.asarray(win_idx),
        k=k, kp=kp, radius=radius, return_points=True,
    )
    ref = kernel_select(
        jnp.asarray(rows4), jnp.asarray(win_xyz), jnp.asarray(win_idx),
        jnp.arange(b, dtype=jnp.int32), jnp.full((b,), w, jnp.int32),
        k=k, kp=kp, radius=radius, return_points=True,
    )
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    m = np.asarray(ref[1]) >= 0
    np.testing.assert_array_equal(
        np.asarray(got[0])[m], np.asarray(ref[0])[m]
    )
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))


def test_pool_compile_stability_across_scans():
    """Two different scans of similar geometry must share every static key:
    same plan_key for _build_pools and same (class_widths, ends, budgets,
    budget_rows) for the search — the bucketing that keeps a sequence from
    recompiling per pair (each new key is a compile)."""
    from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp

    keys = []
    for seed in (21, 22):
        rng = np.random.default_rng(seed)
        n = 4000 + int(rng.integers(0, 120))  # scan-to-scan count jitter
        tgt = rng.uniform(0, 30, size=(n, 3))
        tgt[:, 2] = rng.normal(scale=0.4, size=n)
        tgt = tgt.astype(np.float32)
        tgt_p, n_tgt = pad_cloud(tgt, 1024, pad_value=0.0)
        gh = build_grid_host(tgt_p, 0.5, num_valid=n_tgt, max_overflow=64)
        plan = fp.plan_pool_host(gh, tgt_p)
        assert plan is not None
        keys.append((
            tuple(plan["widths"]), tuple(plan["ends"]),
            tuple(plan["budgets"]), plan["budget_rows"],
            plan["prod_d_pad"], plan["prod_e_pad"],
            plan["packed"].shape, plan["base_e"].shape,
            plan["d_cells"].shape,
            # Grid-level bucketing: the XLA engine's tensors key the jitted
            # search by shape too.
            gh["bucket_pts"].shape, gh["bucket_idx"].shape,
            gh["cell_ids"].shape, gh["capacity"],
            gh["lut"].shape if "lut" in gh else None,
        ))
    assert keys[0] == keys[1], (
        "bucketing failed to stabilize the static geometry:\n"
        f"{keys[0]}\nvs\n{keys[1]}"
    )
