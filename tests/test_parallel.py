"""Multi-device sharding tests on the virtual 8-CPU mesh.

The reference has no distributed execution (SURVEY.md §2 checklist); these
tests validate the device-parallel axes the rebuild adds: points-sharded
normal-equation psum, target-sharded search with all-gather top-k merge, and
the combined 2D-mesh registration step. Each asserts parity against the
single-device pipeline, the multi-device analogue of the reference's
exact-association solver tests (test/PointCloudRegistrationTest.cc:30-116).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import valid_mask
from probabilistic_point_clouds_registration_tpu.io.synthetic import wave_grid
from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig
from probabilistic_point_clouds_registration_tpu.ops.neighbors import radius_search
from probabilistic_point_clouds_registration_tpu.parallel import (
    make_mesh,
    make_sharded_registration_step,
    make_target_sharded_search,
    pad_for_mesh,
)


def _pair(n_pad_shards=8):
    """Source/target pair with shard-compatible padding."""
    src = wave_grid()  # 1500 pts
    theta = 0.15
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    tgt = src @ rot.T + np.array([0.4, -0.2, 0.1])
    src_p, n_src = pad_for_mesh(src, n_pad_shards, multiple=8)
    tgt_p, n_tgt = pad_for_mesh(tgt, n_pad_shards, multiple=8)
    return src_p, n_src, tgt_p, n_tgt


@pytest.mark.parametrize("tp", [2, 8])
def test_target_sharded_search_matches_single_device(tp):
    src_p, n_src, tgt_p, n_tgt = _pair(tp)
    sv = valid_mask(src_p.shape[0], n_src)
    tv = valid_mask(tgt_p.shape[0], n_tgt)
    k, radius = 8, 1.5

    ref = radius_search(
        jnp.asarray(src_p), jnp.asarray(tgt_p), k=k, radius=radius,
        source_valid=sv, target_valid=tv, source_tile=512, target_tile=256,
    )

    mesh = make_mesh(n_points_shards=1, n_target_shards=tp)
    search = make_target_sharded_search(
        mesh, k=k, radius=radius, source_tile=512, target_tile=256
    )
    got = search(jnp.asarray(src_p), jnp.asarray(tgt_p), sv, tv)

    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(ref.mask))
    # Same neighbor sets; order can differ only at exact-distance ties (none
    # in this fixture), so indices must match exactly.
    np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(ref.indices))
    np.testing.assert_allclose(
        np.asarray(got.sq_dists), np.asarray(ref.sq_dists), rtol=0, atol=1e-12
    )


@pytest.mark.parametrize("dp,tp", [(8, 1), (2, 4), (1, 8)])
def test_sharded_step_matches_single_device(dp, tp):
    shards = max(dp, tp) if dp * tp == 8 else dp * tp
    src_p, n_src, tgt_p, n_tgt = _pair(8)
    sv = valid_mask(src_p.shape[0], n_src)
    tv = valid_mask(tgt_p.shape[0], n_tgt)
    k, radius = 10, 1.5
    cfg = LMConfig(dof=5.0, max_iterations=30)

    # Single-device reference result through the same math.
    from probabilistic_point_clouds_registration_tpu.models.em_lm import em_lm_solve

    corr = radius_search(
        jnp.asarray(src_p), jnp.asarray(tgt_p), k=k, radius=radius,
        source_valid=sv, target_valid=tv, source_tile=512, target_tile=256,
    )
    gathered = jnp.asarray(tgt_p)[corr.indices]
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0])
    t0 = jnp.zeros(3)
    ref = em_lm_solve(jnp.asarray(src_p), gathered, corr.mask, q0, t0, cfg)

    mesh = make_mesh(n_points_shards=dp, n_target_shards=tp)
    step = make_sharded_registration_step(
        mesh, k=k, radius=radius, lm_config=cfg, source_tile=512, target_tile=256
    )
    out = step(
        jnp.asarray(src_p), jnp.asarray(tgt_p), sv, tv,
        q0, t0, q0, t0,
    )

    assert int(out.num_correspondences) == int(jnp.sum(corr.mask))
    np.testing.assert_allclose(np.asarray(out.result.q), np.asarray(ref.q), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.result.t), np.asarray(ref.t), atol=1e-9)
    np.testing.assert_allclose(
        float(out.result.final_cost), float(ref.final_cost), rtol=1e-10
    )


def test_sharded_step_recovers_transform():
    """End-to-end: a few sharded outer iterations shrink the alignment error."""
    from probabilistic_point_clouds_registration_tpu.core.se3 import (
        SE3, matrix_to_quat, quat_normalize, se3_to_matrix,
    )

    src_p, n_src, tgt_p, n_tgt = _pair(8)
    sv = valid_mask(src_p.shape[0], n_src)
    tv = valid_mask(tgt_p.shape[0], n_tgt)
    mesh = make_mesh(n_points_shards=4, n_target_shards=2)
    cfg = LMConfig(dof=5.0, max_iterations=50)
    step = make_sharded_registration_step(
        mesh, k=10, radius=1.5, lm_config=cfg, source_tile=512, target_tile=256
    )

    q0 = jnp.array([1.0, 0.0, 0.0, 0.0])
    t0 = jnp.zeros(3)
    current = np.eye(4)
    for _ in range(12):
        q_cum = jnp.asarray(matrix_to_quat(current[:3, :3]))
        t_cum = jnp.asarray(current[:3, 3])
        out = step(jnp.asarray(src_p), jnp.asarray(tgt_p), sv, tv, q_cum, t_cum, q0, t0)
        q = quat_normalize(out.result.q)
        delta = np.asarray(se3_to_matrix(SE3(q=q, t=out.result.t)))
        current = delta @ current

    moved = src_p[:n_src] @ current[:3, :3].T + current[:3, 3]
    err = np.mean(np.linalg.norm(moved - tgt_p[:n_src], axis=1))
    # Initial misalignment is ~1.9; the soft-association EM fixed point at
    # radius 1.5 on a 0.5-spaced grid sits near 0.02 (the t-posterior blends
    # several neighbors), so assert a ~70x error reduction, not exact zero.
    assert err < 0.03, err
