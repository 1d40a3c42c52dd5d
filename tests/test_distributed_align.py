"""Multi-device align(): full product-loop parity vs the single-device path.

DistributedRegistration must reproduce the single-device
ProbabilisticRegistration end to end — trajectory, per-iteration CSV
records, convergence decisions — on a 2x4 ("points" x "targets") virtual
mesh. This is the reference's whole user-facing unit
(src/prob_point_cloud_registration.cc:63-136) running sharded, not a bare
one-step function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import (
    RegistrationParams,
)
from probabilistic_point_clouds_registration_tpu.models.registration import (
    ProbabilisticRegistration,
)
from probabilistic_point_clouds_registration_tpu.parallel import (
    DistributedRegistration,
    make_mesh,
)


def _pair(n=4000, seed=4):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 20, size=(n, 3))
    tgt[:, 2] = rng.normal(scale=0.5, size=n)
    theta = 0.015
    rot = np.array([
        [np.cos(theta), -np.sin(theta), 0.0],
        [np.sin(theta), np.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ])
    src = tgt @ rot.T + np.array([0.15, -0.1, 0.02])
    return src.astype(np.float32), tgt.astype(np.float32)


def _params(**kw):
    base = dict(
        max_neighbours=8,
        radius=0.5,
        n_iter=6,
        cost_drop_thresh=0.01,
        n_cost_drop_it=2,
        dof=5.0,
        dtype="float32",
        outer_chunk=3,
        pad_multiple=256,
        summary=True,
    )
    base.update(kw)
    return RegistrationParams(**base)


@pytest.mark.parametrize("dof", [np.inf, 5.0], ids=["gaussian", "t5"])
def test_distributed_align_matches_single_device(dof):
    # Both weight models: the Gaussian (dof=inf) branch changes the weight
    # kernel's STATIC structure (ops/weights.py), so the mesh path needs its
    # own coverage — a single-device-only Gaussian suite would not catch a
    # sharded static-branch divergence.
    src, tgt = _pair()
    single = ProbabilisticRegistration(
        src, tgt, _params(search_impl="pool", dof=dof)
    )
    t_single = single.align()

    mesh = make_mesh(2, 4)
    dist = DistributedRegistration(src, tgt, _params(dof=dof), mesh=mesh)
    t_dist = dist.align()

    # Same trajectory (5e-6: f32 collectives reduce in a different order
    # than the single-device sums) and the same convergence decisions.
    np.testing.assert_allclose(t_dist, t_single, atol=5e-6)
    assert len(dist.records) == len(single.records)
    assert dist.current_iteration == single.current_iteration
    for rd, rs in zip(dist.records, single.records):
        assert rd.iteration == rs.iteration
        assert rd.num_correspondences == rs.num_correspondences
        np.testing.assert_allclose(
            rd.translation, rs.translation, atol=5e-6
        )
        np.testing.assert_allclose(
            rd.final_cost, rs.final_cost, rtol=2e-4, atol=1e-7
        )
        np.testing.assert_allclose(
            rd.mse_prev_iter, rs.mse_prev_iter, rtol=1e-4, atol=5e-6
        )
    # Full history, not just the final transform.
    assert len(dist.transformation_history) == len(
        single.transformation_history
    )
    # Report CSV has the exact reference columns and one row per iteration.
    rep = dist.report().strip().splitlines()
    assert rep[0].startswith("iter, n_success_steps, initial_cost")
    assert len(rep) == 1 + len(dist.records)


def test_distributed_align_mesh_shapes_agree():
    """1x8 and 4x2 meshes must agree with each other (pure layout change)."""
    src, tgt = _pair(n=3000, seed=9)
    finals = {}
    for dp, tp in ((1, 8), (4, 2)):
        reg = DistributedRegistration(
            src, tgt, _params(n_iter=4, cost_drop_thresh=-1.0),
            mesh=make_mesh(dp, tp),
        )
        finals[(dp, tp)] = reg.align()
    np.testing.assert_allclose(
        finals[(1, 8)], finals[(4, 2)], atol=5e-6
    )


def test_distributed_align_ground_truth_and_traces():
    """Ground-truth MSE column + per-LM traces work on the mesh path."""
    src, tgt = _pair(n=2500, seed=5)
    mesh = make_mesh(2, 2)
    reg = DistributedRegistration(
        src, tgt,
        _params(n_iter=3, cost_drop_thresh=-1.0, trace_inner=True,
                verbose=False),
        mesh=mesh,
        ground_truth_cloud=tgt[: src.shape[0]],
    )
    reg.align()
    assert len(reg.records) == 3
    assert all(np.isfinite(r.mse_ground_truth) for r in reg.records)


def test_distributed_align_budget_escalation():
    """A pooled budget overflow must escalate (and still match the
    single-device result), not crash or silently consume bad results."""
    src, tgt = _pair(n=2500, seed=7)
    mesh = make_mesh(1, 2)
    p = _params(n_iter=3, cost_drop_thresh=-1.0, outer_chunk=3)
    reg = DistributedRegistration(src, tgt, p, mesh=mesh)
    # Starve the initial budget: pretend the plan estimated almost nothing.
    reg._sp = reg._sp._replace(budget_rows=1024)
    # With 8x source rows always floored in, only extreme cases overflow;
    # force a tiny floor by shrinking the recorded per-shard rows.
    reg._rows_per_shard = 16
    t_dist = reg.align()
    single = ProbabilisticRegistration(src, tgt, _params(
        n_iter=3, cost_drop_thresh=-1.0, search_impl="pool", outer_chunk=3,
    ))
    np.testing.assert_allclose(t_dist, single.align(), atol=5e-6)


def test_debug_replication_check_passes():
    """The runtime replication assert (check_vma=False substitute) must be
    clean on a healthy mesh run."""
    from probabilistic_point_clouds_registration_tpu.parallel.pool_sharded import (
        build_sharded_pool_host,
        build_sharded_pools_device,
        make_sharded_pool_align_scan,
    )
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        LMConfig,
    )
    from probabilistic_point_clouds_registration_tpu.core.types import (
        pad_cloud,
    )

    src, tgt = _pair(n=2000, seed=12)
    mesh = make_mesh(2, 2)
    k, radius = 8, 0.5
    sp = build_sharded_pool_host(tgt, radius, 2, num_valid=tgt.shape[0])
    assert sp is not None
    pools = build_sharded_pools_device(mesh, sp)
    src_p, n_src = pad_cloud(src, 256, pad_value=0.0)
    scan = make_sharded_pool_align_scan(
        mesh, sp, k=k, radius=radius, lm_config=LMConfig(dof=5.0),
        source_rows_per_shard=src_p.shape[0] // 2, chunk=2, n_iter=2,
        cost_drop_thresh=-1.0, n_cost_drop_it=5, debug_replication=True,
    )
    q0 = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    outs = scan(
        jnp.asarray(src_p, jnp.float32),
        jnp.asarray(np.arange(src_p.shape[0]) < n_src),
        pools, q0, t0, q0, t0,
        np.float32(0.0), np.int32(0), np.int32(0),
    )
    qs = np.asarray(outs[0])
    assert np.isfinite(qs).all(), "replication check poisoned the outputs"


def _world_sequence(n_scans=4, n=3000, seed=11):
    """A moving-sensor sequence over a fixed random world (the odometry
    fixture shape: scan i = world seen from pose i)."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(0, 20, size=(n, 3))
    world[:, 2] = rng.normal(scale=0.5, size=n)
    th = 0.02
    rot = np.array([
        [np.cos(th), -np.sin(th), 0.0],
        [np.sin(th), np.cos(th), 0.0],
        [0.0, 0.0, 1.0],
    ])
    delta = np.eye(4)
    delta[:3, :3] = rot
    delta[:3, 3] = [0.15, -0.05, 0.02]
    scans, pose = [], np.eye(4)
    for _ in range(n_scans):
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
        pose = pose @ delta
    return scans


def test_mesh_odometry_matches_single_device(tmp_path):
    """run_odometry(mesh=...) — the multi-device SEQUENCE pipeline: per-pair
    DistributedRegistration with prep-thread-staged shard plans + device
    pool builds. Trajectory must match the single-device sequence at 5e-6
    and the checkpoint/resume contract must hold on the mesh path."""
    from probabilistic_point_clouds_registration_tpu.models.odometry import (
        load_checkpoint,
        run_odometry,
    )

    scans = _world_sequence()
    params = _params(n_iter=4, cost_drop_thresh=-1.0)

    seq_single = run_odometry(scans, params)
    mesh = make_mesh(2, 4)
    ck = tmp_path / "traj.json"
    seq_mesh = run_odometry(scans, params, mesh=mesh, checkpoint_path=ck)

    assert len(seq_mesh.poses) == len(seq_single.poses)
    for a, b in zip(seq_mesh.poses, seq_single.poses):
        np.testing.assert_allclose(a, b, atol=5e-6)
    # Reports align pair-for-pair (same columns, same iteration counts).
    assert len(seq_mesh.reports) == len(seq_single.reports)
    for ra, rb in zip(seq_mesh.reports, seq_single.reports):
        assert len(ra.strip().splitlines()) == len(rb.strip().splitlines())

    # Resume: a fresh run against the completed checkpoint must return the
    # identical trajectory without re-registering any pair.
    resumed = run_odometry(scans, params, mesh=mesh, checkpoint_path=ck)
    for a, b in zip(resumed.poses, seq_mesh.poses):
        np.testing.assert_allclose(a, b, atol=0)
    # Partial resume: drop the last pair from the checkpoint and re-run.
    from probabilistic_point_clouds_registration_tpu.models.odometry import (
        OdometryResult,
        save_checkpoint,
    )

    partial = OdometryResult(
        poses=seq_mesh.poses[:-1],
        relative_transforms=seq_mesh.relative_transforms[:-1],
        per_pair_cost=seq_mesh.per_pair_cost[:-1],
        reports=seq_mesh.reports[:-1],
    )
    save_checkpoint(ck, partial)
    resumed2 = run_odometry(scans, params, mesh=mesh, checkpoint_path=ck)
    assert len(resumed2.poses) == len(seq_mesh.poses)
    for a, b in zip(resumed2.poses, seq_mesh.poses):
        np.testing.assert_allclose(a, b, atol=5e-6)


def test_distributed_prepared_target_matches_fresh():
    """A DistributedRegistration built from prepare_target(device=True)
    must produce the exact same align() as the fresh-constructed one."""
    src, tgt = _pair(n=2500, seed=21)
    mesh = make_mesh(2, 2)
    p = _params(n_iter=3, cost_drop_thresh=-1.0)
    fresh = DistributedRegistration(src, tgt, p, mesh=mesh)
    t_fresh = fresh.align()
    prepared = DistributedRegistration.prepare_target(
        tgt, p, mesh, device=True
    )
    assert prepared["sp"] is not None
    reg = DistributedRegistration(
        src, tgt, p, mesh=mesh, prepared_target=prepared
    )
    t_prep = reg.align()
    np.testing.assert_allclose(t_prep, t_fresh, atol=5e-6)
    assert len(reg.records) == len(fresh.records)
