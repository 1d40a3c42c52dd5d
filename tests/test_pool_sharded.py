"""Sharded POOLED engine parity: the 2D-mesh step must reproduce the
single-device pooled engine (multi-device execution runs the same engine
as one device).

Both sides run the SAME search semantics (radius-capped KNN, ascending
(distance, slot) order) so the solves must agree to f32 collective-order
noise (5e-6, like tests/test_grid_sharded.py); the neighbor SETS must be
exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import (
    pad_cloud,
    valid_mask,
)
from probabilistic_point_clouds_registration_tpu.models.em_lm import (
    LMConfig,
    em_lm_solve,
)
from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp
from probabilistic_point_clouds_registration_tpu.ops.grid import build_grid_host
from probabilistic_point_clouds_registration_tpu.parallel import (
    build_sharded_pool_host,
    build_sharded_pools_device,
    make_mesh,
    make_sharded_pool_registration_step,
)


def _bunny_pair(n):
    from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like

    tgt = bunny_like(n, seed=0)
    theta = 0.02
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    src = tgt @ rot.T + np.array([0.02, -0.015, 0.01])
    return src.astype(np.float32), tgt.astype(np.float32)


def _kitti_pair(n):
    from probabilistic_point_clouds_registration_tpu.io.synthetic import kitti_like

    tgt = kitti_like(n, seed=0)
    theta = 0.01
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    src = tgt @ rot.T + np.array([0.8, 0.1, 0.02])
    return src.astype(np.float32), tgt.astype(np.float32)


def _single_device_pool(src_p, sv, tgt_p, n_tgt, k, radius):
    """Reference: the single-device pooled engine (interpret kernel)."""
    gh = build_grid_host(tgt_p, radius, num_valid=n_tgt)
    assert gh is not None
    pre = fp.build_pool_prepack(gh, tgt_p)
    assert pre is not None, "fixture must fit the pooled engine"
    corr, overflow, pts = fp.fused_pool_search(
        jnp.asarray(src_p, jnp.float32),
        jnp.asarray(sv),
        pre.pool_xyz,
        pre.pool_idx,
        pre.width_lut,
        pre.lut_d,
        pre.origin_d,
        pre.dims_d,
        k=k,
        radius=radius,
        class_widths=pre.class_widths,
        class_ends=pre.class_ends,
        class_budgets=pre.class_budgets,
        budget_rows=pre.budget_rows,
        return_points=True,
        select_max_w=pre.select_max_w,
    )
    assert int(overflow) == 0
    return corr, pts


def _run_sharded(src_p, sv, tgt_p, n_tgt, k, radius, cfg, dp, tp):
    mesh = make_mesh(n_points_shards=dp, n_target_shards=tp)
    sp = build_sharded_pool_host(tgt_p, radius, tp, num_valid=n_tgt)
    assert sp is not None, "fixture must fit the sharded pooled engine"
    pools = build_sharded_pools_device(mesh, sp)
    step = make_sharded_pool_registration_step(
        mesh,
        sp,
        k=k,
        radius=radius,
        lm_config=cfg,
        source_rows_per_shard=src_p.shape[0] // dp,
        )
    q0 = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    out = step(
        jnp.asarray(src_p, jnp.float32), jnp.asarray(sv), pools, q0, t0, q0, t0
    )
    assert int(out.overflow) == 0
    return out


@pytest.mark.parametrize("dof", [np.inf, 5.0], ids=["gaussian", "t5"])
def test_sharded_pool_step_matches_single_device_bunny(dof):
    """Full outer iteration (pooled search + EM-LM solve) on a 2x4 mesh vs
    the single-device pooled engine, dense bench-style pair. Parametrized
    over both weight models: dof=inf flips the weight kernel's static
    Gaussian branch (ops/weights.py), which needs mesh coverage of its own."""
    k, radius = 20, 0.075
    n = 12_000  # interpret-mode kernel on CPU: bench scale is minutes
    src, tgt = _bunny_pair(n)
    src_p, n_src = pad_cloud(src, 512, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 512, pad_value=0.0)
    sv = np.asarray(valid_mask(src_p.shape[0], n_src))
    cfg = LMConfig(dof=dof, dimension=3, max_iterations=12)

    corr, pts = _single_device_pool(src_p, sv, tgt_p, n_tgt, k, radius)
    ref = em_lm_solve(
        jnp.asarray(src_p, jnp.float32), pts, corr.mask,
        jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
        cfg,
    )
    ref_ncorr = int(jnp.sum(corr.mask))

    out = _run_sharded(src_p, sv, tgt_p, n_tgt, k, radius, cfg, dp=2, tp=4)
    assert int(out.num_correspondences) == ref_ncorr
    q_got = np.asarray(out.result.q, np.float64)
    q_ref = np.asarray(ref.q, np.float64)
    np.testing.assert_allclose(
        q_got / np.linalg.norm(q_got), q_ref / np.linalg.norm(q_ref),
        rtol=0, atol=5e-6,
    )
    np.testing.assert_allclose(
        np.asarray(out.result.t), np.asarray(ref.t), rtol=0, atol=5e-6
    )
    np.testing.assert_allclose(
        float(out.result.final_cost), float(ref.final_cost), rtol=1e-4
    )


def test_sharded_pool_step_matches_single_device_kitti_like():
    """Same parity on the sparse LiDAR-like geometry (the pooled engine's
    home regime: occupancy skew, hot near-sensor cells)."""
    k, radius = 20, 0.5
    n = 16_000
    src, tgt = _kitti_pair(n)
    # kitti_like spans ~150 m; scale density so radius 0.5 keeps neighbors.
    scale = (16_000 / 131_072) ** (1 / 2)
    src, tgt = src * scale, tgt * scale
    src_p, n_src = pad_cloud(src, 512, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 512, pad_value=0.0)
    sv = np.asarray(valid_mask(src_p.shape[0], n_src))
    cfg = LMConfig(dof=5.0, dimension=3, max_iterations=10)

    corr, pts = _single_device_pool(src_p, sv, tgt_p, n_tgt, k, radius)
    ref = em_lm_solve(
        jnp.asarray(src_p, jnp.float32), pts, corr.mask,
        jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
        cfg,
    )
    ref_ncorr = int(jnp.sum(corr.mask))

    out = _run_sharded(src_p, sv, tgt_p, n_tgt, k, radius, cfg, dp=2, tp=4)
    assert int(out.num_correspondences) == ref_ncorr
    q_got = np.asarray(out.result.q, np.float64)
    q_ref = np.asarray(ref.q, np.float64)
    np.testing.assert_allclose(
        q_got / np.linalg.norm(q_got), q_ref / np.linalg.norm(q_ref),
        rtol=0, atol=5e-6,
    )
    np.testing.assert_allclose(
        np.asarray(out.result.t), np.asarray(ref.t), rtol=0, atol=5e-6
    )


def test_sharded_pool_sets_match_exactly():
    """Merged sharded neighbor sets == single-device pooled sets, row for
    row (order may differ only among exact distance ties)."""
    k, radius = 10, 0.09
    src, tgt = _bunny_pair(4000)
    src_p, n_src = pad_cloud(src, 256, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 256, pad_value=0.0)
    sv = np.asarray(valid_mask(src_p.shape[0], n_src))

    ref_corr, _ = _single_device_pool(src_p, sv, tgt_p, n_tgt, k, radius)

    from jax import lax
    from jax.sharding import PartitionSpec as P
    from probabilistic_point_clouds_registration_tpu.parallel.grid_sharded import (
        merge_topk,
    )
    from probabilistic_point_clouds_registration_tpu.parallel.mesh import (
        TARGETS_AXIS,
    )

    mesh = make_mesh(n_points_shards=1, n_target_shards=4)
    sp = build_sharded_pool_host(tgt_p, radius, 4, num_valid=n_tgt)
    assert sp is not None
    pools = build_sharded_pools_device(mesh, sp)

    from probabilistic_point_clouds_registration_tpu.core.types import round_up
    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        BLOCK_GROUPS,
        GROUP,
    )

    budget = round_up(
        max(sp.budget_rows, 8 * src_p.shape[0]), 2 * BLOCK_GROUPS * GROUP
    )
    scale = max(1, -(-budget // max(sp.budget_rows, 1)))
    budgets = tuple(
        min(budget // GROUP, round_up(b * scale, BLOCK_GROUPS))
        for b in sp.class_budgets[:-1]
    ) + (budget // GROUP,)

    def body(fs, sv_, pool_xyz, pool_idx, width_lut, lut_d, origin_d,
             dims_d):
        sq = lambda a: a.reshape(a.shape[1:])
        corr, overflow, _ = fp.fused_pool_search(
            fs, sv_,
            tuple(sq(x) for x in pool_xyz), tuple(sq(x) for x in pool_idx),
            sq(width_lut), sq(lut_d), sq(origin_d),
            sq(dims_d),
            k=k, radius=radius, class_widths=sp.class_widths,
            class_ends=sp.class_ends, class_budgets=budgets,
            budget_rows=budget, return_points=True, select_max_w=sp.select_max_w,
        )
        all_d = lax.all_gather(
            jnp.where(corr.mask, corr.sq_dists, jnp.inf), TARGETS_AXIS
        )
        all_i = lax.all_gather(corr.indices, TARGETS_AXIS)
        best_i, best_d, found = merge_topk(all_d, all_i, k=k)
        return best_i, found, overflow

    nc = len(sp.class_widths)
    run = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(
                P(), P(), (P(TARGETS_AXIS),) * nc, (P(TARGETS_AXIS),) * nc,
                P(TARGETS_AXIS), P(TARGETS_AXIS), P(TARGETS_AXIS),
                P(TARGETS_AXIS),
            ),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )
    got_i, got_f, overflow = run(
        jnp.asarray(src_p, jnp.float32), jnp.asarray(sv), pools.pool_xyz,
        pools.pool_idx, pools.width_lut, pools.lut_d,
        pools.origin_d, pools.dims_d,
    )
    assert int(jnp.sum(overflow)) == 0
    m_ref = np.asarray(ref_corr.mask)[:n_src]
    m_got = np.asarray(got_f)[:n_src]
    np.testing.assert_array_equal(m_got, m_ref)
    ri = np.sort(np.where(m_ref, np.asarray(ref_corr.indices)[:n_src], -1), axis=1)
    gi = np.sort(np.where(m_got, np.asarray(got_i)[:n_src], -1), axis=1)
    np.testing.assert_array_equal(gi, ri)


def test_forced_plan_matches_self_plan_results():
    """A plan built with force-mode statics must produce the same search
    results as the self-keyed plan (binning/padding is semantics-free)."""
    k, radius = 8, 0.1
    src, tgt = _bunny_pair(3000)
    src_p, n_src = pad_cloud(src, 256, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 256, pad_value=0.0)
    sv = np.asarray(valid_mask(src_p.shape[0], n_src))
    gh = build_grid_host(tgt_p, radius, num_valid=n_tgt)
    plan = fp.plan_pool_host(gh, tgt_p)
    assert plan is not None
    # Force a DIFFERENT (wider) static geometry: extra class, fatter pads.
    force = {
        "widths": tuple([2 * plan["widths"][0]] + list(plan["widths"])),
        "pad_sizes": tuple(
            [64] + [2 * (e - s) for s, e in zip([0] + plan["ends"][:-1], plan["ends"])]
        ),
        "prod_d_pad": 2 * plan["prod_d_pad"],
        "prod_e_pad": 2 * plan["prod_e_pad"],
        "u_pad": plan["cell_start"].shape[0] + 256,
        "n_pad": plan["packed"].shape[0] + 255,
        "ud_b": plan["row_vals"].shape[0] + 256,
    }
    plan_f = fp.plan_pool_host(gh, tgt_p, force=force)
    assert plan_f is not None
    assert list(plan_f["widths"]) == list(force["widths"])

    def search(p):
        pre = fp.build_pool_prepack(gh, tgt_p, plan=p)
        corr, overflow = fp.fused_pool_search(
            jnp.asarray(src_p, jnp.float32), jnp.asarray(sv),
            pre.pool_xyz, pre.pool_idx, pre.width_lut, pre.lut_d, pre.origin_d, pre.dims_d,
            k=k, radius=radius, class_widths=pre.class_widths,
            class_ends=pre.class_ends, class_budgets=pre.class_budgets,
            budget_rows=pre.budget_rows, select_max_w=pre.select_max_w,
        )
        assert int(overflow) == 0
        return corr

    a = search(plan)
    b = search(plan_f)
    np.testing.assert_array_equal(np.asarray(a.mask), np.asarray(b.mask))
    np.testing.assert_array_equal(
        np.asarray(a.indices)[np.asarray(a.mask)],
        np.asarray(b.indices)[np.asarray(b.mask)],
    )
    np.testing.assert_array_equal(
        np.asarray(a.sq_dists)[np.asarray(a.mask)],
        np.asarray(b.sq_dists)[np.asarray(b.mask)],
    )


def test_demand_sized_sharded_budget_shrinks_and_stays_correct():
    """source_slices switches the sharded budget from the 8x floor to
    measured demand: the budget must SHRINK on a dense scan and the step
    must still match the single-device engine with zero overflow."""
    k, radius = 20, 0.075
    n = 12_000
    src, tgt = _bunny_pair(n)
    src_p, n_src = pad_cloud(src, 512, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 512, pad_value=0.0)
    sv = np.asarray(valid_mask(src_p.shape[0], n_src))
    cfg = LMConfig(dof=5.0, dimension=3, max_iterations=12)
    dp, tp = 2, 4
    rps = src_p.shape[0] // dp
    slices = [src[d * rps : min((d + 1) * rps, n_src)] for d in range(dp)]

    mesh = make_mesh(n_points_shards=dp, n_target_shards=tp)
    sp = build_sharded_pool_host(
        tgt_p, radius, tp, num_valid=n_tgt, source_slices=slices
    )
    assert sp is not None and sp.demand_sized
    from probabilistic_point_clouds_registration_tpu.core.types import round_up
    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        BLOCK_GROUPS,
        GROUP,
    )

    budget = round_up(
        max(sp.budget_rows, rps + 4096), 2 * BLOCK_GROUPS * GROUP
    )
    assert budget < 8 * rps, (budget, 8 * rps)

    pools = build_sharded_pools_device(mesh, sp)
    step = make_sharded_pool_registration_step(
        mesh, sp, k=k, radius=radius, lm_config=cfg,
        source_rows_per_shard=rps, )
    q0 = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    out = step(
        jnp.asarray(src_p, jnp.float32), jnp.asarray(sv), pools, q0, t0,
        q0, t0,
    )
    assert int(out.overflow) == 0

    corr, pts = _single_device_pool(src_p, sv, tgt_p, n_tgt, k, radius)
    ref = em_lm_solve(
        jnp.asarray(src_p, jnp.float32), pts, corr.mask, q0, t0, cfg
    )
    assert int(out.num_correspondences) == int(jnp.sum(corr.mask))
    np.testing.assert_allclose(
        np.asarray(out.result.t), np.asarray(ref.t), rtol=0, atol=5e-6
    )
