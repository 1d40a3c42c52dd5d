"""Hash-grid radius search: exact parity with the brute-force engine.

The grid engine must return identical neighbor sets to
ops.neighbors.radius_search (the golden-tested reference implementation of
FLANN's capped radiusSearch, src/prob_point_cloud_registration.cc:72-81).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud, valid_mask
from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like, wave_grid
from probabilistic_point_clouds_registration_tpu.ops.grid import build_grid, grid_search
from probabilistic_point_clouds_registration_tpu.ops.neighbors import radius_search


def _check_parity(src_np, tgt_np, k, radius, pad=64):
    src_p, n_src = pad_cloud(src_np, pad, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt_np, pad, pad_value=0.0)
    sv = valid_mask(src_p.shape[0], n_src)
    tv = valid_mask(tgt_p.shape[0], n_tgt)
    source = jnp.asarray(src_p)
    target = jnp.asarray(tgt_p)

    ref = radius_search(
        source, target, k=k, radius=radius, source_valid=sv, target_valid=tv,
        source_tile=256, target_tile=256,
    )
    grid = build_grid(tgt_p, radius, num_valid=n_tgt)
    assert grid is not None, "grid should be buildable for this fixture"
    got = grid_search(grid, source, k=k, radius=radius, source_valid=sv,
                      source_tile=256)

    # Same number of neighbors per row.
    np.testing.assert_array_equal(
        np.asarray(got.mask).sum(1), np.asarray(ref.mask).sum(1)
    )
    # Same neighbor sets with the same distances (order may differ only at
    # exact ties; these fixtures have none).
    for row_got_i, row_got_d, row_ref_i, row_ref_d, m in zip(
        np.asarray(got.indices), np.asarray(got.sq_dists),
        np.asarray(ref.indices), np.asarray(ref.sq_dists),
        np.asarray(ref.mask),
    ):
        nm = m.sum()
        assert set(row_got_i[:nm]) == set(row_ref_i[:nm])
        np.testing.assert_allclose(
            np.sort(row_got_d[:nm]), np.sort(row_ref_d[:nm]), atol=1e-9
        )


def test_grid_matches_bruteforce_wave():
    src = wave_grid()
    rng = np.random.default_rng(0)
    tgt = src + rng.normal(scale=0.05, size=src.shape)
    _check_parity(src, tgt, k=8, radius=0.7)


def test_grid_matches_bruteforce_random():
    rng = np.random.default_rng(1)
    src = rng.random((500, 3)) * 4.0
    tgt = rng.random((900, 3)) * 4.0
    _check_parity(src, tgt, k=5, radius=0.5)


def test_grid_matches_bruteforce_bunny():
    tgt = bunny_like(4000)
    src = bunny_like(3000, seed=7)
    _check_parity(src, tgt, k=10, radius=0.15)


def test_grid_source_outside_bbox():
    """Sources far outside the target bbox must simply find nothing."""
    rng = np.random.default_rng(2)
    tgt = rng.random((5000, 3)) * 4.0
    src = np.concatenate([rng.random((50, 3)) * 4.0, rng.random((50, 3)) + 100.0])
    _check_parity(src, tgt, k=4, radius=0.3)


def test_grid_refuses_pathological():
    # Degenerate cell size.
    assert build_grid(np.random.rand(10, 3), 0.0) is None
    # Occupancy too high: all points in one cell.
    pts = np.zeros((100, 3))
    assert build_grid(pts, 1.0) is None


def test_grid_empty_target():
    assert build_grid(np.zeros((0, 3)), 1.0) is None


def test_pipeline_grid_chunked_matches_brute():
    """Full registration: grid engine + fused outer chunks == brute force.

    Same association sets -> same EM solves -> same trajectory; also checks
    the chunked scan's convergence bookkeeping truncates identically."""
    import dataclasses

    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        ProbabilisticRegistration,
    )

    tgt = bunny_like(6000)
    th = 0.06
    rot = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]]
    )
    src = tgt @ rot.T + np.array([0.03, -0.02, 0.01])

    base = RegistrationParams(
        max_neighbours=10, radius=0.15, n_iter=6, cost_drop_thresh=0.001,
        dtype="float64", search_impl="brute",
    )
    reg_b = ProbabilisticRegistration(src, tgt, base)
    t_brute = reg_b.align()

    grid_params = dataclasses.replace(base, search_impl="grid", outer_chunk=3)
    reg_g = ProbabilisticRegistration(src, tgt, grid_params)
    assert reg_g._grid is not None, "grid must build for this fixture"
    t_grid = reg_g.align()

    assert len(reg_g.records) == len(reg_b.records)
    np.testing.assert_allclose(t_grid, t_brute, atol=1e-8)
    for rb, rg in zip(reg_b.records, reg_g.records):
        assert rb.num_correspondences == rg.num_correspondences
        np.testing.assert_allclose(rg.final_cost, rb.final_cost, rtol=1e-9)


def test_grid_approx_selection_high_recall():
    """approx_max_k selection: opt-in approximate path must keep >=95% of the
    exact neighbor pairs on a realistic fixture."""
    import jax.numpy as jnp

    from probabilistic_point_clouds_registration_tpu.core.types import (
        pad_cloud, valid_mask,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import (
        grid_radius_search,
    )

    tgt = bunny_like(4000)
    src = bunny_like(3000, seed=7)
    src_p, n_src = pad_cloud(src, 64, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 64, pad_value=0.0)
    sv = valid_mask(src_p.shape[0], n_src)
    grid = build_grid(tgt_p, 0.15, num_valid=n_tgt)

    def run(select):
        return grid_radius_search(
            jnp.asarray(src_p), grid.bucket_pts, grid.bucket_idx, grid.cell_ids,
            grid.origin, grid.dims, grid.lut,
            k=10, radius=0.15, capacity=grid.capacity, source_valid=sv,
            source_tile=256, select_impl=select,
        )

    exact = run("topk")
    approx = run("approx")
    exact_pairs = {
        (i, j)
        for i, (row, m) in enumerate(zip(np.asarray(exact.indices), np.asarray(exact.mask)))
        for j in row[: m.sum()]
    }
    approx_pairs = {
        (i, j)
        for i, (row, m) in enumerate(zip(np.asarray(approx.indices), np.asarray(approx.mask)))
        for j in row[: m.sum()]
    }
    assert approx_pairs  # sanity
    recall = len(exact_pairs & approx_pairs) / len(exact_pairs)
    assert recall >= 0.95, recall


def test_grid_hier_selection_matches_topk():
    """Hierarchical two-stage selection must be exactly equal to flat top_k."""
    import jax.numpy as jnp

    from probabilistic_point_clouds_registration_tpu.core.types import (
        pad_cloud, valid_mask,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import (
        grid_radius_search,
    )

    tgt = bunny_like(4000)
    src = bunny_like(3000, seed=7)
    src_p, n_src = pad_cloud(src, 64, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 64, pad_value=0.0)
    sv = valid_mask(src_p.shape[0], n_src)
    grid = build_grid(tgt_p, 0.15, num_valid=n_tgt)

    def run(select):
        return grid_radius_search(
            jnp.asarray(src_p), grid.bucket_pts, grid.bucket_idx, grid.cell_ids,
            grid.origin, grid.dims, grid.lut,
            k=10, radius=0.15, capacity=grid.capacity, source_valid=sv,
            source_tile=256, select_impl=select,
        )

    a = run("topk")
    b = run("hier")
    np.testing.assert_array_equal(np.asarray(a.mask), np.asarray(b.mask))
    np.testing.assert_array_equal(
        np.asarray(a.mask).sum(1), np.asarray(b.mask).sum(1)
    )
    for ia, da, ib, db, m in zip(
        np.asarray(a.indices), np.asarray(a.sq_dists),
        np.asarray(b.indices), np.asarray(b.sq_dists), np.asarray(a.mask),
    ):
        nm = m.sum()
        assert set(ia[:nm]) == set(ib[:nm])
        np.testing.assert_allclose(np.sort(da[:nm]), np.sort(db[:nm]), atol=0)
