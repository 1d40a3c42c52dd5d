"""Batched scan-pair registration: parity with sequential odometry + sharding."""
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams
from probabilistic_point_clouds_registration_tpu.io.synthetic import wave_grid
from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig
from probabilistic_point_clouds_registration_tpu.models.odometry import run_odometry
from probabilistic_point_clouds_registration_tpu.parallel import make_mesh
from probabilistic_point_clouds_registration_tpu.parallel.batch import (
    run_odometry_batched,
)


def _sequence(n_scans=5):
    world = wave_grid()
    th = 0.04
    rot = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]]
    )
    delta = np.eye(4)
    delta[:3, :3] = rot
    delta[:3, 3] = [0.12, -0.04, 0.02]
    scans, pose = [], np.eye(4)
    poses = []
    for _ in range(n_scans):
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
        poses.append(pose.copy())
        pose = pose @ delta
    return scans, poses


def _ate(a, b):
    ta = np.stack([p[:3, 3] for p in a])
    tb = np.stack([p[:3, 3] for p in b])
    return float(np.sqrt(np.mean(np.sum((ta - tb) ** 2, axis=1))))


@pytest.mark.parametrize("dof", [np.inf, 5.0], ids=["gaussian", "t5"])
def test_batched_matches_sequential(dof):
    # dof=inf flips the weight kernel's static Gaussian branch
    # (ops/weights.py) — the batched/vmapped path needs its own coverage.
    scans, gt = _sequence(4)
    cfg = LMConfig(dof=dof, max_iterations=25)
    poses_b, result = run_odometry_batched(
        scans, k=10, radius=1.0, lm_config=cfg, n_outer=6,
        pad_multiple=128, dtype="float64",
    )
    assert result.initial_costs.shape == (3, 6)
    assert _ate(poses_b, gt) < 0.03

    seq = run_odometry(
        scans,
        RegistrationParams(max_neighbours=10, radius=1.0, n_iter=6,
                           cost_drop_thresh=-1.0, dtype="float64",
                           max_inner_iterations=25, dof=dof),
    )
    # Same relative transforms to solver precision.
    for a, b in zip(poses_b, seq.poses):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_batched_sharded_over_mesh():
    scans, gt = _sequence(5)  # 4 pairs -> padded to 8 across the mesh
    mesh = make_mesh(n_points_shards=8, n_target_shards=1)
    cfg = LMConfig(dof=5.0, max_iterations=25)
    poses, result = run_odometry_batched(
        scans, k=10, radius=1.0, lm_config=cfg, n_outer=6,
        pad_multiple=128, mesh=mesh, dtype="float64",
    )
    assert len(poses) == 5
    assert _ate(poses, gt) < 0.03
    # Unsharded reference.
    poses_ref, _ = run_odometry_batched(
        scans, k=10, radius=1.0, lm_config=cfg, n_outer=6,
        pad_multiple=128, dtype="float64",
    )
    for a, b in zip(poses, poses_ref):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_batched_convergence_masking_matches_sequential():
    """With the convergence rule ON, each batched pair must stop exactly
    where the sequential host loop stops (same iteration counts, same
    trajectory) and report fewer iterations than the cap."""
    scans, gt = _sequence(4)
    cfg = LMConfig(dof=5.0, max_iterations=25)
    n_outer = 12
    poses_b, result = run_odometry_batched(
        scans, k=10, radius=1.0, lm_config=cfg, n_outer=n_outer,
        pad_multiple=128, dtype="float64",
        cost_drop_thresh=0.01, n_cost_drop_it=3,
    )
    seq = run_odometry(
        scans,
        RegistrationParams(max_neighbours=10, radius=1.0, n_iter=n_outer,
                           cost_drop_thresh=0.01, n_cost_drop_it=3,
                           dtype="float64", max_inner_iterations=25),
    )
    # Iteration counts must match the host convergence rule exactly.
    seq_iters = [
        len(r.strip().splitlines()) - 1 for r in seq.reports
    ]
    np.testing.assert_array_equal(np.asarray(result.num_iterations), seq_iters)
    assert np.all(np.asarray(result.num_iterations) < n_outer), (
        "fixture must actually converge early for this test to bite"
    )
    for a, b in zip(poses_b, seq.poses):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_batched_grid_engine_matches_brute():
    """The batched grid engine (production search) must reproduce the
    batched brute-force trajectories."""
    scans, gt = _sequence(4)
    cfg = LMConfig(dof=5.0, max_iterations=25)
    kw = dict(k=10, radius=0.5, lm_config=cfg, n_outer=6, pad_multiple=128,
              dtype="float64")
    poses_g, res_g = run_odometry_batched(scans, search_impl="grid", **kw)
    poses_b, res_b = run_odometry_batched(scans, search_impl="brute", **kw)
    for a, b in zip(poses_g, poses_b):
        np.testing.assert_allclose(a, b, atol=1e-9)
    np.testing.assert_array_equal(
        np.asarray(res_g.num_correspondences), np.asarray(res_b.num_correspondences)
    )


def test_batched_pool_engine_matches_grid():
    """The batched POOLED engine (pair-harmonized static geometry, vmapped
    select) must reproduce the batched grid trajectories."""
    scans, gt = _sequence(4)
    cfg = LMConfig(dof=5.0, max_iterations=25)
    kw = dict(k=10, radius=0.5, lm_config=cfg, n_outer=6, pad_multiple=128,
              dtype="float32")
    poses_p, res_p = run_odometry_batched(scans, search_impl="pool", **kw)
    poses_g, res_g = run_odometry_batched(scans, search_impl="grid", **kw)
    assert int(np.sum(np.asarray(res_p.overflow))) == 0
    for a, b in zip(poses_p, poses_g):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(res_p.num_correspondences),
        np.asarray(res_g.num_correspondences),
    )


def test_batched_pool_overflow_redo_splices_grid_results():
    """Pairs whose pooled budget flag fires are redone on the batched grid
    engine and spliced back — trajectories must equal an all-grid run."""
    from probabilistic_point_clouds_registration_tpu.parallel import batch as B

    scans, gt = _sequence(4)
    cfg = LMConfig(dof=5.0, max_iterations=25)
    kw = dict(k=10, radius=0.5, lm_config=cfg, n_outer=6, pad_multiple=128,
              dtype="float32")

    real = B._batched_pools_host

    def strangled(*args, **kwargs):
        pools = real(*args, **kwargs)
        assert pools is not None
        # Strangle every non-last class's group-prefix budget so the REAL
        # runtime flag fires (the coverage check only exists for non-last
        # classes — the fixture must produce >= 2).
        assert len(pools["class_budgets"]) >= 2, pools["class_widths"]
        pools["class_budgets"] = (16,) * (len(pools["class_budgets"]) - 1) + (
            pools["class_budgets"][-1],
        )
        return pools

    B._batched_pools_host = strangled
    try:
        poses_p, res_p = run_odometry_batched(scans, search_impl="pool", **kw)
    finally:
        B._batched_pools_host = real
    assert int(np.sum(np.asarray(res_p.overflow) > 0)) > 0, (
        "fixture must trigger the overflow redo"
    )
    poses_g, res_g = run_odometry_batched(scans, search_impl="grid", **kw)
    for a, b in zip(poses_p, poses_g):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_batched_pool_engine_sharded_over_mesh():
    """Pooled batched odometry with the pair axis sharded across the mesh
    (vmapped select kernel under a batch sharding) must equal the
    unsharded pooled run."""
    scans, gt = _sequence(5)  # 4 pairs -> padded to 8 across the mesh
    mesh = make_mesh(n_points_shards=8, n_target_shards=1)
    cfg = LMConfig(dof=5.0, max_iterations=25)
    kw = dict(k=10, radius=0.5, lm_config=cfg, n_outer=6, pad_multiple=128,
              dtype="float32", search_impl="pool")
    poses, result = run_odometry_batched(scans, mesh=mesh, **kw)
    assert len(poses) == 5
    assert int(np.sum(np.asarray(result.overflow))) == 0
    poses_ref, _ = run_odometry_batched(scans, **kw)
    for a, b in zip(poses, poses_ref):
        np.testing.assert_allclose(a, b, atol=1e-6)
