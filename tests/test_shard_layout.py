"""Occupancy-aware shard-axis selection for the pooled engine.

Target-sharding thins per-window source occupancy toward 1 and pads every
live window to a full 8-row group (the 8x budget of
parallel/pool_sharded.py), while it shrinks window widths tp-fold. With
pow2 width classes down to 8 lanes the two effects cancel on sparse scans
(a tie, which keeps "targets"), and on dense scans the width shrink wins.
DistributedRegistration must produce identical results either layout.
"""
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
    choose_pool_shard_layout,
    make_mesh,
)


def test_chooser_sparse_scan_ties_to_targets():
    # Occupancy ~1: target-sharding multiplies padded rows by at most tp
    # and divides pow2 window widths by tp, so it never loses; at equal
    # work the tie keeps "targets".
    out = choose_pool_shard_layout(
        n_src=100_000, n_tgt=100_000, occupied_cells=40_000,
        n_devices=8, tp=4,
    )
    assert out["w_targets"] <= out["w_points"]
    assert out["layout"] == "targets"
    tie = choose_pool_shard_layout(
        n_src=8_000, n_tgt=100_000, occupied_cells=100_000,
        n_devices=8, tp=4,
    )
    assert tie["w_points"] == tie["w_targets"]
    assert tie["layout"] == "targets"


def test_chooser_dense_scan_prefers_targets():
    # Dense: wide unions (27 * 131k / 800 ~ 4.4k lanes) and
    # occupancy/devrow >> 8, so the width shrink beats the row growth.
    out = choose_pool_shard_layout(
        n_src=131_072, n_tgt=131_072, occupied_cells=800,
        n_devices=8, tp=4,
    )
    assert out["layout"] == "targets"
    assert out["w_targets"] < out["w_points"]


def test_chooser_tp1_is_targets_noop():
    out = choose_pool_shard_layout(
        n_src=10_000, n_tgt=10_000, occupied_cells=5_000,
        n_devices=8, tp=1,
    )
    # tp=1: both estimates coincide (no split), layout stays "targets".
    assert out["layout"] == "targets"


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
        n_iter=5,
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


def test_points_layout_matches_single_device():
    src, tgt = _pair()
    single = ProbabilisticRegistration(src, tgt, _params(search_impl="pool"))
    t_single = single.align()

    mesh = make_mesh(2, 4)
    dist = DistributedRegistration(
        src, tgt, _params(), mesh=mesh, layout="points"
    )
    assert dist.layout == "points"
    # The mesh collapsed onto the points axis; the target pool is unsharded.
    assert dist.mesh.shape["points"] == 8
    assert dist.mesh.shape["targets"] == 1
    t_dist = dist.align()

    np.testing.assert_allclose(t_dist, t_single, atol=5e-6)
    assert len(dist.records) == len(single.records)
    for rd, rs in zip(dist.records, single.records):
        assert rd.num_correspondences == rs.num_correspondences
        np.testing.assert_allclose(rd.translation, rs.translation, atol=5e-6)


def test_auto_layout_collapses_sparse_scan():
    # A genuinely sparse scan (every point its own cell at this radius):
    # auto must pick points-only sharding and still align correctly.
    src, tgt = _pair(n=3000, seed=7)
    mesh = make_mesh(2, 4)
    params = _params(radius=0.35, max_neighbours=4)
    dist = DistributedRegistration(src, tgt, params, mesh=mesh)
    single = ProbabilisticRegistration(
        src, tgt, _params(radius=0.35, max_neighbours=4, search_impl="pool")
    )
    if dist.layout == "points":
        assert dist.mesh.shape["targets"] == 1
    t_dist = dist.align()
    t_single = single.align()
    np.testing.assert_allclose(t_dist, t_single, atol=5e-6)


def test_explicit_targets_layout_respected():
    src, tgt = _pair(n=2500, seed=9)
    mesh = make_mesh(2, 4)
    dist = DistributedRegistration(
        src, tgt, _params(), mesh=mesh, layout="targets"
    )
    assert dist.layout == "targets"
    assert dist.mesh.shape["targets"] == 4
