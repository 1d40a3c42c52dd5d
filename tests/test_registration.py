"""Full-pipeline tests: outer loop with real NN association.

This is the coverage the reference *lacks* (its full-pipeline test is
commented out, test/PointCloudRegistrationTest.cc:118-193); SURVEY.md S4 calls
for adding it.
"""
import math

import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams
from probabilistic_point_clouds_registration_tpu.io.synthetic import transform_cloud, wave_grid
from probabilistic_point_clouds_registration_tpu.models.registration import (
    ProbabilisticRegistration,
    register_pair,
)


def _pair(angle=0.1, tx=0.3):
    source = wave_grid()
    m = np.eye(4)
    c, s = np.cos(angle), np.sin(angle)
    m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    m[0, 3] = tx
    return source, transform_cloud(source, m), m


@pytest.mark.parametrize("dof", [math.inf, 5.0], ids=["gaussian", "t5"])
def test_full_pipeline_recovers_transform(dof):
    source, target, m = _pair()
    params = RegistrationParams(
        dof=dof, radius=3.0, max_neighbours=10, n_iter=50, dtype="float64", pad_multiple=64
    )
    final, reg = register_pair(source, target, params)
    # Transform recovery. Soft multi-neighbor association on a 0.5-spaced grid
    # leaves an O(0.02) bias — inherent to probabilistic ICP without
    # annealing; the reference's own full-pipeline test (at 1e-2, rotation
    # only) was left commented out.
    diff = m @ np.linalg.inv(final)
    np.testing.assert_allclose(diff, np.eye(4), atol=0.03)
    aligned = transform_cloud(source, final)
    mean_err = np.mean(np.linalg.norm(aligned - target, axis=1))
    assert mean_err < 0.05
    assert reg.current_iteration < 50  # converged via cost drop, not max iters


def test_convergence_counter_semantics():
    # cost_drop starts at 0 => the stall counter pre-increments before the
    # first iteration (cc:145-156); with n_cost_drop_it=0 the loop must still
    # run at least one iteration (counter must EXCEED the threshold).
    source, target, _ = _pair()
    params = RegistrationParams(
        dof=5.0, radius=3.0, max_neighbours=5, n_iter=50, n_cost_drop_it=0,
        dtype="float64", pad_multiple=64,
    )
    reg = ProbabilisticRegistration(source, target, params)
    reg.align()
    assert reg.current_iteration >= 1


def test_report_columns_and_history():
    source, target, _ = _pair()
    params = RegistrationParams(
        dof=5.0, radius=3.0, max_neighbours=10, n_iter=8, summary=True,
        dtype="float64", pad_multiple=64,
    )
    reg = ProbabilisticRegistration(source, target, params)
    reg.align()
    lines = reg.report().strip().splitlines()
    assert lines[0] == (
        "iter, n_success_steps, initial_cost, final_cost, tx, ty, tz, "
        "roll, pitch, yaw, mse_prev_iter, mse_gtruth"
    )
    assert len(lines) == 1 + len(reg.transformation_history)
    row0 = [field.strip() for field in lines[1].split(",")]
    assert len(row0) == 12
    assert row0[0] == "0"
    # History stores cumulative transforms: last one equals transformation().
    np.testing.assert_array_equal(reg.transformation(), reg.transformation_history[-1])


def test_ground_truth_mse_tracked(capsys):
    source, target, m = _pair()
    gt = transform_cloud(source, m)  # ground truth = perfectly aligned source
    params = RegistrationParams(
        dof=5.0, radius=3.0, max_neighbours=10, n_iter=30, dtype="float64", pad_multiple=64
    )
    reg = ProbabilisticRegistration(source, target, params, ground_truth_cloud=gt)
    reg.align()
    out = capsys.readouterr().out
    assert "MSE w.r.t. ground truth" in out
    assert reg.mse_ground_truth < 0.05


def test_voxel_filters_applied():
    source, target, _ = _pair()
    params = RegistrationParams(
        dof=5.0, radius=3.0, max_neighbours=10, n_iter=5,
        source_filter_size=0.6, target_filter_size=0.6, dtype="float64", pad_multiple=64,
    )
    reg = ProbabilisticRegistration(source, target, params)
    assert reg.filtered_source.shape[0] < source.shape[0]
    assert reg.target_cloud.shape[0] < target.shape[0]
    reg.align()  # must still run end-to-end on the filtered clouds
    assert reg.current_iteration >= 1


def test_target_not_mutated():
    # Deliberate fix of the reference's in-place target mutation (cc:34-41).
    source, target, _ = _pair()
    target_copy = target.copy()
    params = RegistrationParams(
        dof=5.0, radius=3.0, max_neighbours=5, n_iter=2, target_filter_size=0.7,
        dtype="float64", pad_multiple=64,
    )
    reg = ProbabilisticRegistration(source, target, params)
    reg.align()
    np.testing.assert_array_equal(target, target_copy)


def test_empty_association_stays_identity():
    """Radius too small for any neighbor: solver must remain at identity and
    terminate cleanly, never NaN (verify-recipe probe)."""
    import numpy as np

    from probabilistic_point_clouds_registration_tpu import (
        ProbabilisticRegistration,
        RegistrationParams,
    )

    src = np.random.default_rng(0).random((200, 3))
    tgt = src + 100.0  # disjoint
    reg = ProbabilisticRegistration(
        src, tgt, RegistrationParams(radius=0.1, n_iter=3)
    )
    t = reg.align()
    np.testing.assert_array_equal(t, np.eye(4))
    assert all(np.isfinite(r.final_cost) for r in reg.records)


def test_trace_inner_diagnostics(capsys):
    """trace_inner + verbose must stream per-LM-iteration rows (cost, step
    quality, trust radius, accept/reject) — the Ceres FullReport parity
    surface (src/prob_point_cloud_registration.cc:108)."""
    import re

    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, 4, size=(400, 3)).astype(np.float32)
    src = tgt + np.array([0.05, -0.03, 0.02], dtype=np.float32)
    p = RegistrationParams(
        max_neighbours=5, radius=0.6, n_iter=2, cost_drop_thresh=-1.0,
        dof=5.0, dtype="float32", verbose=True, trace_inner=True,
    )
    register_pair(src, tgt, p)
    out = capsys.readouterr().out
    rows = re.findall(
        r"lm_iter \d+: cost=\S+ step_quality=\S+ trust_radius=\S+ "
        r"(?:accepted|rejected)", out
    )
    assert len(rows) >= 2, out[-2000:]


def test_chunked_convergence_matches_single_step():
    """The device-side stopping rule (_scan_convergence) must stop exactly
    where the single-step host loop stops: same record count, same
    trajectory, same CSV rows — at the reference's default cost-drop rule
    (cc:138-158), not the fixed-iteration bench mode."""
    source, target, _ = _pair()
    base = dict(
        dof=5.0, radius=3.0, max_neighbours=10, n_iter=50,
        cost_drop_thresh=0.01, n_cost_drop_it=3, dtype="float64",
        pad_multiple=64, summary=True,
    )
    reg_1 = ProbabilisticRegistration(
        source, target, RegistrationParams(outer_chunk=1, **base)
    )
    reg_1.align()
    reg_c = ProbabilisticRegistration(
        source, target, RegistrationParams(outer_chunk=16, **base)
    )
    reg_c.align()

    # Converged well before n_iter (the rule actually fired mid-chunk) and
    # produced the identical per-iteration history.
    assert reg_1.current_iteration < 50
    assert reg_c.current_iteration == reg_1.current_iteration
    assert len(reg_c.records) == len(reg_1.records)
    np.testing.assert_allclose(
        reg_c.transformation(), reg_1.transformation(), rtol=0, atol=1e-9
    )
    for r1, rc in zip(reg_1.records, reg_c.records):
        assert rc.iteration == r1.iteration
        assert rc.num_correspondences == r1.num_correspondences
        np.testing.assert_allclose(rc.translation, r1.translation, atol=1e-9)
        np.testing.assert_allclose(
            rc.final_cost, r1.final_cost, rtol=1e-9, atol=1e-12
        )


def test_trace_inner_on_chunked_path(capsys):
    """trace_inner must stream per-LM rows from the CHUNKED scan path too —
    diagnostics no longer force the slow single-step engine (reference
    analogue cc:108)."""
    import re

    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, 4, size=(400, 3)).astype(np.float32)
    src = tgt + np.array([0.05, -0.03, 0.02], dtype=np.float32)
    p = RegistrationParams(
        max_neighbours=5, radius=0.6, n_iter=4, cost_drop_thresh=-1.0,
        dof=5.0, dtype="float32", verbose=True, trace_inner=True,
        outer_chunk=4,
    )
    final, reg = register_pair(src, tgt, p)
    out = capsys.readouterr().out
    rows = re.findall(
        r"lm_iter \d+: cost=\S+ step_quality=\S+ trust_radius=\S+ "
        r"(?:accepted|rejected)", out
    )
    assert len(rows) >= 4, out[-2000:]
    # All four outer iterations ran through the chunked path in one call.
    assert reg.current_iteration == 4


def test_trace_inner_on_pooled_engine(capsys):
    """trace_inner composes with the pooled engine (its select kernel in
    interpret mode on the CPU): per-LM rows stream out of the scan without disabling the
    engine."""
    import re

    rng = np.random.default_rng(5)
    tgt = rng.uniform(0, 20, size=(2000, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=2000)
    src = tgt + np.array([0.1, -0.05, 0.02])
    p = RegistrationParams(
        max_neighbours=8, radius=0.7, n_iter=3, cost_drop_thresh=-1.0,
        dof=5.0, dtype="float32", verbose=True, trace_inner=True,
        outer_chunk=3, search_impl="pool", pad_multiple=128,
    )
    reg = ProbabilisticRegistration(
        src.astype(np.float32), tgt.astype(np.float32), p
    )
    assert reg._pool is not None, "fixture must engage the pooled engine"
    reg.align()
    assert reg._pool is not None, "trace_inner must not disable the engine"
    out = capsys.readouterr().out
    rows = re.findall(r"lm_iter \d+: cost=\S+", out)
    assert len(rows) >= 3, out[-2000:]


@pytest.mark.parametrize(
    "thresh,n_drop",
    [(-1.0, 5), (0.99, 3)],
    ids=["fixed-iterations", "stall-rule"],
)
def test_pooled_budget_overflow_falls_back_to_grid_mid_pair(thresh, n_drop):
    """End-to-end coverage of the mid-pair engine fallback: when the pooled
    engine's runtime budget flag fires inside align(), the chunk is
    discarded and the pair redone on the XLA grid engine — the records and
    trajectory must be IDENTICAL to a forced-grid run. The stall-rule variant guards the fallback's stall-counter
    restore: the loop-top has_converged() mutates the counter for an
    iteration the discarded chunk never produced, and without the restore
    the fallback pair terminates one iteration early."""
    rng = np.random.default_rng(11)
    tgt = rng.uniform(0, 15, size=(2500, 3))
    tgt[:, 2] = rng.normal(scale=0.3, size=2500)
    src = tgt + np.array([0.1, -0.05, 0.02])
    base = dict(
        max_neighbours=8, radius=0.7, n_iter=10, cost_drop_thresh=thresh,
        n_cost_drop_it=n_drop, dof=5.0, dtype="float32", outer_chunk=4,
        pad_multiple=128,
    )

    reg = ProbabilisticRegistration(
        src.astype(np.float32), tgt.astype(np.float32),
        RegistrationParams(search_impl="pool", **base),
    )
    # The grid is deliberately NOT on device while the pooled engine holds
    # the pair (lazy fallback upload); the host arrays must be retained.
    assert reg._pool is not None and reg._grid is None
    assert reg._grid_host is not None
    # Strangle every non-last class's group-prefix budget so the REAL
    # coverage flag fires on the first chunk (the same flag a
    # pathologically scattered source cloud raises); the coverage check
    # only exists for non-last classes, so the fixture must produce >= 2.
    assert len(reg._pool.class_budgets) >= 2, reg._pool.class_widths
    reg._pool = reg._pool._replace(
        class_budgets=(16,) * (len(reg._pool.class_budgets) - 1)
        + (reg._pool.class_budgets[-1],)
    )
    # The dispatch normally REPLACES the plan's class budgets with the
    # ctor's demand-replay sizing (floored at 1024 groups — unstranglable);
    # drop that so the strangled plan budgets above reach the program.
    reg._pool_class_cum = None
    reg.align()
    assert reg._pool is None, "overflow must drop the pooled engine"
    assert reg._grid is not None, "fallback must materialize the grid"
    assert reg.current_iteration >= 1

    ref = ProbabilisticRegistration(
        src.astype(np.float32), tgt.astype(np.float32),
        RegistrationParams(search_impl="grid", **base),
    )
    ref.align()
    assert reg.current_iteration == ref.current_iteration
    np.testing.assert_allclose(
        reg.transformation(), ref.transformation(), rtol=0, atol=0
    )
    assert len(reg.records) == len(ref.records)
    for a, b in zip(reg.records, ref.records):
        assert a.num_correspondences == b.num_correspondences
        assert a.initial_cost == b.initial_cost
        assert a.final_cost == b.final_cost
        np.testing.assert_array_equal(a.translation, b.translation)


def test_prepared_target_reuse_matches_fresh_ctor():
    """The README static-map recipe: one prepare_target(device=True) shared
    across several registrations must give bit-identical results to fresh
    per-pair ctors, and must not mutate the shared preparation."""
    source, target, _ = _pair()
    p = RegistrationParams(max_neighbours=8, radius=1.0, n_iter=5,
                           cost_drop_thresh=-1.0, pad_multiple=128)
    prep = ProbabilisticRegistration.prepare_target(target, p, device=True)

    results_shared = []
    for shift in (0.0, 0.05):
        src = source + shift
        reg = ProbabilisticRegistration(src, target, p, prepared_target=prep)
        reg.align()
        results_shared.append(np.asarray(reg.transformation()))

    for shift, t_shared in zip((0.0, 0.05), results_shared):
        src = source + shift
        reg = ProbabilisticRegistration(src, target, p)
        reg.align()
        np.testing.assert_array_equal(np.asarray(reg.transformation()), t_shared)
