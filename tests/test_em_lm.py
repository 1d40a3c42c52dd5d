"""Inner-solver integration tests: the reference's exact-association fixtures.

Mirrors test/PointCloudRegistrationTest.cc:30-116 — a 30x50 z=sin(x)+cos(y)
grid, target = source moved by (tx=2.5, rot 0.34 rad about Z), identity data
association, solved once; mean alignment error must be < 1e-6 (both Gaussian
and t-distribution dof=5). Runs in float64 like the reference.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core import se3
from probabilistic_point_clouds_registration_tpu.io.synthetic import transform_cloud, wave_grid
from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig, em_lm_solve


def _fixture():
    source = wave_grid()  # 1500 points
    angle = 0.34
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    m[0, 3] = 2.5
    target = transform_cloud(source, m)
    return source, target, m


@pytest.mark.parametrize("dof", [math.inf, 5.0], ids=["gaussian", "t5"])
def test_exact_association_recovers_transform(dof):
    source, target, m = _fixture()
    n = source.shape[0]
    targets = jnp.asarray(target)[:, None, :]  # (N, 1, 3): identity association
    mask = jnp.ones((n, 1), bool)

    config = LMConfig(dof=dof, function_tolerance=1e-4, max_iterations=200)
    # function_tolerance=10e-5 in the reference test (:55); tightened values
    # also pass — use the same.
    result = em_lm_solve(
        jnp.asarray(source),
        targets,
        mask,
        jnp.asarray([1.0, 0.0, 0.0, 0.0]),
        jnp.zeros(3),
        config,
    )
    est = se3.SE3(q=result.q, t=result.t)
    aligned = np.asarray(se3.se3_apply(est, jnp.asarray(source)))
    mean_error = np.mean(np.linalg.norm(aligned - target, axis=1))
    assert mean_error < 1e-6
    assert int(result.num_iterations) < 200


def test_cost_decreases_and_summary_sane():
    source, target, _ = _fixture()
    targets = jnp.asarray(target)[:, None, :]
    mask = jnp.ones((source.shape[0], 1), bool)
    result = em_lm_solve(
        jnp.asarray(source),
        targets,
        mask,
        jnp.asarray([1.0, 0.0, 0.0, 0.0]),
        jnp.zeros(3),
        LMConfig(dof=5.0, function_tolerance=1e-4, max_iterations=200),
    )
    assert float(result.final_cost) < float(result.initial_cost)
    assert int(result.num_successful_steps) >= 1
    assert np.isfinite(float(result.final_cost))


def test_masked_slots_do_not_affect_solution():
    source, target, _ = _fixture()
    n = source.shape[0]
    rng = np.random.default_rng(0)
    # K=3 with garbage in masked slots; only slot 0 (exact match) is valid.
    garbage = rng.random((n, 2, 3)) * 100
    targets = jnp.concatenate([jnp.asarray(target)[:, None, :], jnp.asarray(garbage)], axis=1)
    mask = jnp.asarray(np.stack([np.ones(n, bool), np.zeros(n, bool), np.zeros(n, bool)], axis=1))
    result = em_lm_solve(
        jnp.asarray(source),
        targets,
        mask,
        jnp.asarray([1.0, 0.0, 0.0, 0.0]),
        jnp.zeros(3),
        LMConfig(dof=5.0, function_tolerance=1e-4, max_iterations=200),
    )
    est = se3.SE3(q=result.q, t=result.t)
    aligned = np.asarray(se3.se3_apply(est, jnp.asarray(source)))
    mean_error = np.mean(np.linalg.norm(aligned - target, axis=1))
    assert mean_error < 1e-6


def test_initial_transform_is_respected():
    # Seeding with the exact answer must converge immediately to it.
    source, target, m = _fixture()
    targets = jnp.asarray(target)[:, None, :]
    mask = jnp.ones((source.shape[0], 1), bool)
    q0 = se3.matrix_to_quat(jnp.asarray(m[:3, :3]))
    t0 = jnp.asarray(m[:3, 3])
    result = em_lm_solve(
        jnp.asarray(source), targets, mask, q0, t0,
        LMConfig(dof=math.inf, function_tolerance=1e-4, max_iterations=50),
    )
    est = se3.SE3(q=result.q, t=result.t)
    aligned = np.asarray(se3.se3_apply(est, jnp.asarray(source)))
    assert np.mean(np.linalg.norm(aligned - target, axis=1)) < 1e-9


def test_lm_trace_records_iterations():
    """LMConfig.trace must record per-iteration (cost, step_quality, radius,
    accepted) rows — the Ceres FullReport parity surface."""
    import numpy as np
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        LMConfig,
        em_lm_solve,
    )

    rng = np.random.default_rng(0)
    src = rng.normal(size=(200, 3))
    tgt = (src + np.array([0.1, -0.05, 0.02]))[:, None, :]  # exact association
    mask = np.ones((200, 1), bool)
    cfg = LMConfig(dof=np.inf, dimension=3, max_iterations=30, trace=True)
    res = em_lm_solve(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3), cfg,
    )
    n = int(res.num_iterations)
    tr = np.asarray(res.trace)
    assert tr.shape == (30, 4)
    assert n >= 1
    assert np.all(tr[:n, 2] > 0), "radius rows must be populated"
    accepted = tr[:n, 3] > 0
    assert accepted.any()
    costs = tr[:n, 0][accepted]
    assert costs[-1] <= float(res.initial_cost)
    assert np.allclose(costs[-1], float(res.final_cost), rtol=1e-6)
    # rows past num_iterations stay zero
    assert np.all(tr[n:] == 0)

    # trace off -> empty buffer, identical solution
    res2 = em_lm_solve(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3),
        cfg._replace(trace=False),
    )
    assert np.asarray(res2.trace).shape == (0, 4)
    np.testing.assert_allclose(np.asarray(res2.q), np.asarray(res.q))


def test_moments_path_matches_direct_normal_equations():
    """The fused moments formulation (one (N,K) pass -> 26 scalars) must
    reproduce the direct H/g/cost and the candidate-cost evaluation of the
    three-pass reference form to f64 precision."""
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        _cost_change_from_moments,
        _estep_moments,
        _normal_equations,
        _normal_from_moments,
        _residuals,
        _weighted_cost,
    )
    from probabilistic_point_clouds_registration_tpu.ops.weights import (
        update_weights,
    )

    rng = np.random.default_rng(7)
    n, k = 500, 6
    # Large-coordinate regime (KITTI-like) to exercise conditioning.
    source = jnp.asarray(rng.normal(size=(n, 3)) * 40.0)
    targets = source[:, None, :] + jnp.asarray(rng.normal(size=(n, k, 3)) * 0.3)
    mask = jnp.asarray(rng.random((n, k)) < 0.8)
    q = jnp.asarray([0.9, 0.05, -0.03, 0.02])
    t = jnp.asarray([0.3, -0.1, 0.05])

    for dof in (5.0, math.inf):
        r = _residuals(q, t, source, targets)
        e2 = jnp.sum(r * r, axis=-1)
        w = update_weights(e2, mask, dof=dof, dimension=3)
        H_d, g_d, cost_d = _normal_equations(q, t, source, targets, w, mask)

        st = _estep_moments(q, t, source, targets, mask, dof, 3)
        H_m, g_m = _normal_from_moments(q, st, source.dtype)

        np.testing.assert_allclose(np.asarray(H_m), np.asarray(H_d), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(g_m), np.asarray(g_d),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(st.cost), float(cost_d), rtol=1e-12)

        # Candidate cost at a trial step, same (current) weights.
        q_new = q + jnp.asarray([1e-3, -2e-3, 5e-4, 1e-3])
        t_new = t + jnp.asarray([0.01, -0.02, 0.005])
        r_new = _residuals(q_new, t_new, source, targets)
        cand_direct = _weighted_cost(r_new, w, mask)
        change = _cost_change_from_moments(q, t, q_new, t_new, st, source.dtype)
        np.testing.assert_allclose(
            float(st.cost - change), float(cand_direct), rtol=1e-10
        )


def test_moments_path_f32_accuracy_large_coordinates():
    """The production device path runs the moments formulation in f32. Against
    the f64 direct form as ground truth, the f32 moments H/g/cost and the
    closed-form candidate cost must stay within f32-appropriate bounds in
    the KITTI-like large-coordinate regime (second moments ~1e8)."""
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        _cost_change_from_moments,
        _estep_moments,
        _normal_equations,
        _normal_from_moments,
        _residuals,
    )
    from probabilistic_point_clouds_registration_tpu.ops.weights import (
        update_weights,
    )

    rng = np.random.default_rng(11)
    n, k = 2000, 8
    source64 = jnp.asarray(rng.normal(size=(n, 3)) * 40.0)
    targets64 = source64[:, None, :] + jnp.asarray(
        rng.normal(size=(n, k, 3)) * 0.3
    )
    mask = jnp.asarray(rng.random((n, k)) < 0.85)
    q = jnp.asarray([0.9, 0.05, -0.03, 0.02])
    t = jnp.asarray([0.3, -0.1, 0.05])

    # f64 ground truth via the direct form.
    r = _residuals(q, t, source64, targets64)
    e2 = jnp.sum(r * r, axis=-1)
    w = update_weights(e2, mask, dof=5.0, dimension=3)
    H_ref, g_ref, cost_ref = _normal_equations(
        q, t, source64, targets64, w, mask
    )

    # f32 moments path (what the device executes).
    s32 = source64.astype(jnp.float32)
    t32 = targets64.astype(jnp.float32)
    q32, tt32 = q.astype(jnp.float32), t.astype(jnp.float32)
    st = _estep_moments(q32, tt32, s32, t32, mask, 5.0, 3)
    H_m, g_m = _normal_from_moments(q32, st, jnp.float32)

    H_ref_n, g_ref_n = np.asarray(H_ref), np.asarray(g_ref)
    assert np.abs(np.asarray(H_m) - H_ref_n).max() < 1e-3 * np.abs(H_ref_n).max()
    assert np.abs(np.asarray(g_m) - g_ref_n).max() < 1e-3 * np.abs(g_ref_n).max()
    np.testing.assert_allclose(float(st.cost), float(cost_ref), rtol=1e-4)

    # Closed-form cost change of a realistic small step vs the f64 truth:
    # relative error must stay well under the ftol (1e-5) decision scale
    # relative to the cost itself.
    q_new64 = q + jnp.asarray([1e-3, -2e-3, 5e-4, 1e-3])
    t_new64 = t + jnp.asarray([0.01, -0.02, 0.005])
    r_new = _residuals(q_new64, t_new64, source64, targets64)
    e2n = jnp.sum(r_new * r_new, axis=-1)
    cand_ref = 0.5 * float(jnp.sum(jnp.where(mask, w * e2n, 0.0)))
    change_ref = float(cost_ref) - cand_ref
    change32 = float(
        _cost_change_from_moments(
            q32, tt32, q_new64.astype(jnp.float32),
            t_new64.astype(jnp.float32), st, jnp.float32,
        )
    )
    assert abs(change32 - change_ref) < 1e-4 * float(cost_ref)


def test_xtol_terminates_rejection_stall():
    """Ceres checks ParameterToleranceReached on every valid step, accepted
    or not; at the cost rounding floor (perfect-fit data) steps shrink to
    nothing while being rejected, and xtol — not dead radius — must end the
    solve promptly."""
    source, target, _ = _fixture()
    targets = jnp.asarray(target)[:, None, :]
    mask = jnp.ones((source.shape[0], 1), bool)
    res = em_lm_solve(
        jnp.asarray(source), targets, mask,
        jnp.asarray([1.0, 0.0, 0.0, 0.0]), jnp.zeros(3),
        LMConfig(dof=math.inf, function_tolerance=-1.0, max_iterations=200),
    )
    # ftol is disarmed (negative): only xtol can stop before the cap, and
    # it must (dead radius alone needs ~a hundred halvings from 1e4).
    assert int(res.num_iterations) < 200
    assert np.isfinite(float(res.final_cost))


def test_inner_iteration_cap_warning():
    """Hitting max_inner_iterations must warn (the reference runs unbounded)."""
    import warnings

    import numpy as np
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.io.synthetic import wave_grid
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        register_pair,
    )

    tgt = wave_grid()
    src = tgt + np.array([0.3, -0.2, 0.1])
    p = RegistrationParams(max_neighbours=8, radius=1.0, n_iter=2,
                           cost_drop_thresh=-1.0, max_inner_iterations=2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, reg = register_pair(src, tgt, p)
    assert reg.inner_cap_hits >= 1
    assert any("max_inner_iterations" in str(w.message) for w in rec)
