"""Sharded hash-grid engine parity: 2D-mesh step vs the single-device grid
engine at bench scale (the production engine must be the one that
scales)."""
import jax
import jax.numpy as jnp
import numpy as np

from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud, valid_mask
from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig, em_lm_solve
from probabilistic_point_clouds_registration_tpu.ops.grid import build_grid, grid_search
from probabilistic_point_clouds_registration_tpu.parallel import make_mesh
from probabilistic_point_clouds_registration_tpu.parallel.grid_sharded import (
    build_sharded_grid_host,
    make_sharded_grid_registration_step,
)
from probabilistic_point_clouds_registration_tpu.core.se3 import quat_rotate


def _bench_like_pair(n=35_000):
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


def test_sharded_grid_step_matches_single_device_35k():
    """One full outer iteration (search + EM-LM solve) on a 2x4 mesh must
    reproduce the single-device grid engine's solve at 35k bench scale."""
    k, radius = 20, 0.075
    src, tgt = _bench_like_pair()
    fs, n_src = pad_cloud(src, 1024, pad_value=0.0)
    tg, n_tgt = pad_cloud(tgt, 1024, pad_value=0.0)
    fs = fs.astype(np.float32)
    tg = tg.astype(np.float32)
    sv = np.arange(fs.shape[0]) < n_src
    tv = np.arange(tg.shape[0]) < n_tgt
    cfg = LMConfig(dof=5.0, dimension=3, max_iterations=12)

    # Single-device reference.
    grid = build_grid(tg, radius, num_valid=n_tgt)
    assert grid is not None
    grid = grid._replace(
        bucket_pts=jnp.asarray(grid.bucket_pts, jnp.float32),
        origin=jnp.asarray(grid.origin, jnp.float32),
    )
    corr = grid_search(
        grid, jnp.asarray(fs), k=k, radius=radius,
        source_valid=jnp.asarray(sv),
    )
    gathered = jnp.asarray(tg)[corr.indices]
    ref = em_lm_solve(jnp.asarray(fs), gathered, corr.mask,
                      jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                      jnp.zeros(3, jnp.float32), cfg)
    ref_ncorr = int(jnp.sum(corr.mask))

    # Sharded: points axis 2 x targets axis 4.
    mesh = make_mesh(n_points_shards=2, n_target_shards=4)
    sg = build_sharded_grid_host(tg, radius, 4, num_valid=n_tgt)
    assert sg is not None
    assert sg.capacity < grid.capacity, "sharding must shrink local capacity"
    step = make_sharded_grid_registration_step(
        mesh, k=k, radius=radius, lm_config=cfg, capacity=sg.capacity,
    )
    out = step(
        jnp.asarray(fs), jnp.asarray(sv),
        jnp.asarray(sg.bucket_pts, jnp.float32),
        jnp.asarray(sg.bucket_idx),
        jnp.asarray(sg.lut),
        jnp.asarray(sg.origin, jnp.float32),
        jnp.asarray(sg.dims),
        jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
        jnp.asarray([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
    )
    assert int(out.num_correspondences) == ref_ncorr
    # The quaternion is a free R^4 parameter (reference parity: no manifold),
    # so solves may converge to different scales of the same rotation —
    # compare normalized.
    q_got = np.asarray(out.result.q, np.float64)
    q_ref = np.asarray(ref.q, np.float64)
    np.testing.assert_allclose(q_got / np.linalg.norm(q_got),
                               q_ref / np.linalg.norm(q_ref), rtol=0, atol=5e-6)
    np.testing.assert_allclose(np.asarray(out.result.t), np.asarray(ref.t),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(
        float(out.result.final_cost), float(ref.final_cost), rtol=1e-4
    )


def test_sharded_grid_search_sets_match_exactly():
    """The merged sharded neighbor sets equal the single-grid sets (smaller
    fixture, exact comparison per source row)."""
    k, radius = 10, 0.09
    src, tgt = _bench_like_pair(6000)
    fs, n_src = pad_cloud(src, 256, pad_value=0.0)
    tg, n_tgt = pad_cloud(tgt, 256, pad_value=0.0)
    fs, tg = fs.astype(np.float32), tg.astype(np.float32)
    sv = np.arange(fs.shape[0]) < n_src

    grid = build_grid(tg, radius, num_valid=n_tgt)
    grid = grid._replace(bucket_pts=jnp.asarray(grid.bucket_pts, jnp.float32),
                         origin=jnp.asarray(grid.origin, jnp.float32))
    ref = grid_search(grid, jnp.asarray(fs), k=k, radius=radius,
                      source_valid=jnp.asarray(sv))

    from probabilistic_point_clouds_registration_tpu.ops.grid import grid_radius_search
    from probabilistic_point_clouds_registration_tpu.parallel.grid_sharded import (
        merge_topk,
    )
    import jax as _jax

    sg = build_sharded_grid_host(tg, radius, 4, num_valid=n_tgt)
    mesh = make_mesh(n_points_shards=1, n_target_shards=4)
    P = jax.sharding.PartitionSpec

    def body(fs_, sv_, bp, bi, lut):
        corr = grid_radius_search(
            fs_, bp, bi, jnp.zeros((bp.shape[0],), jnp.int32),
            jnp.asarray(sg.origin, jnp.float32), jnp.asarray(sg.dims), lut,
            k=k, radius=radius, capacity=sg.capacity, source_valid=sv_,
        )
        from jax import lax
        all_d = lax.all_gather(jnp.where(corr.mask, corr.sq_dists, jnp.inf),
                               "targets")
        all_i = lax.all_gather(corr.indices, "targets")
        return merge_topk(all_d, all_i, k=k)

    run = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("targets"), P("targets"), P("targets")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    ))
    got_i, got_d, got_f = run(
        jnp.asarray(fs), jnp.asarray(sv),
        jnp.asarray(sg.bucket_pts, jnp.float32), jnp.asarray(sg.bucket_idx),
        jnp.asarray(sg.lut),
    )
    m_ref = np.asarray(ref.mask)[:n_src]
    m_got = np.asarray(got_f)[:n_src]
    np.testing.assert_array_equal(m_got, m_ref)
    # Sets must match; order can differ only among exact distance ties, so
    # compare per-row sorted index sets.
    ri = np.sort(np.where(m_ref, np.asarray(ref.indices)[:n_src], -1), axis=1)
    gi = np.sort(np.where(m_got, np.asarray(got_i)[:n_src], -1), axis=1)
    np.testing.assert_array_equal(gi, ri)
