"""Inner EM solve: weighted nonlinear least squares on SE(3).

Device-native replacement for the reference's Ceres problem
(prob_point_cloud_registration_iteration.hpp:21-78): one residual block per
correspondence, shared (quaternion[4], translation[3]) parameters, per-term
weights refreshed by an EM E-step after *every* Levenberg-Marquardt iteration
(weight_updater_callback.hpp:36-63 with update_state_every_iteration=true,
iteration.hpp:55).

Design translation, not a port:
  * The per-term Ceres autodiff Jacobians (error_term.hpp:21-37) never
    materialize as a big J. The residual r_ij = y_j - (R(q) x_i + t) has
    Jacobian [-A_i, -I3] where A_i = d(R(q)x_i)/dq is LINEAR in the source
    point (the rotation is a matrix apply), so the whole LM step — 7x7
    normal equations, gradient, current cost, and the trial iterate's
    candidate cost — collapses onto 26 weighted moment scalars
    (`_Moments`) accumulated in ONE fused pass over the (N, K) table per
    LM iteration. The direct three-pass form (E-step, normal equations,
    candidate evaluation) is kept as `_normal_equations` for parity
    testing only.
  * The whole solve runs inside one ``lax.while_loop`` under jit — no host
    round-trips between E-steps and LM steps.
  * Levenberg-Marquardt trust-region dynamics mirror Ceres defaults: diagonal
    damping D = clamp(diag(H)) / radius, step quality rho against model cost
    change, Ceres's radius update rule, and the nonmonotonic (Conn-Gould-
    Toint) step acceptance the reference enables
    (src/prob_point_cloud_registration.cc:90). One deliberate divergence:
    when the E-step changes the weights, this solver re-evaluates the current
    cost under the *new* weights, whereas Ceres keeps a stale cached cost
    (the callback mutates loss functions behind its back). The clean EM
    bookkeeping is better-behaved; trajectories agree within the ATE bound.

Rotation parameterization matches the reference exactly: a free R^4
quaternion with a scale-invariant rotation operator and no manifold
(iteration.hpp:42-44 adds no local parameterization); the quaternion is
normalized only on extraction (iteration.hpp:62-63). The gauge direction is
regularized by the LM damping, exactly as in Ceres.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.se3 import quat_rotate, quat_rotate_points
from ..ops.weights import update_weights

# Every f32 contraction over points runs at full f32 precision: a GPU may
# otherwise run an f32 dot in TF32 (~3 significant digits), which at LiDAR
# coordinate scales (+-75 m) corrupts H and g.
_HIGHEST = jax.lax.Precision.HIGHEST

_MAX_TRUST_REGION_RADIUS = 1e16
_MIN_TRUST_REGION_RADIUS = 1e-32
_MAX_CONSECUTIVE_NONMONOTONIC_STEPS = 5


class LMConfig(NamedTuple):
    """Static solver configuration (mirrors the Ceres options the reference
    sets at src/prob_point_cloud_registration.cc:88-99).

    ``axis_name``: when set, the solver runs SPMD inside ``shard_map`` with
    source rows sharded over that mesh axis; the 7x7 normal equations, the
    gradient, and the scalar cost are reduced with ``lax.psum`` over the device mesh so
    every device steps the identical replicated (q, t) iterate. This is the
    Device-native replacement for Ceres's OpenMP-threaded residual evaluation
    (src/prob_point_cloud_registration.cc:98)."""

    dof: float = 5.0
    dimension: int = 3
    function_tolerance: float = 1e-5
    # Ceres's parameter_tolerance default, active in the reference (it only
    # overrides function_tolerance, src/prob_point_cloud_registration.cc:97):
    # stop when an accepted step moves the iterate by less than
    # xtol * (|x| + xtol). This is also what terminates perfect-fit solves,
    # where the cost reaches the rounding floor and the relative
    # function-tolerance test can no longer fire.
    parameter_tolerance: float = 1e-8
    max_iterations: int = 100
    initial_radius: float = 1e4
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    min_relative_decrease: float = 1e-3
    use_nonmonotonic_steps: bool = True
    # A tuple reduces over several mesh axes (the reduce-scatter merge
    # shards the solve over both "points" and "targets").
    axis_name: str | tuple | None = None
    # Record per-LM-iteration (cost, step_quality, radius, accepted) into
    # LMResult.trace — the analogue of Ceres's per-iteration summary rows in
    # ``summary.FullReport()`` that the reference prints when verbose
    # (src/prob_point_cloud_registration.cc:108). Off by default: the trace
    # buffer is (max_iterations, 4) of carried state.
    trace: bool = False


class LMState(NamedTuple):
    q: jnp.ndarray
    t: jnp.ndarray
    cost: jnp.ndarray
    radius: jnp.ndarray
    decrease_factor: jnp.ndarray
    iteration: jnp.ndarray
    num_successful: jnp.ndarray
    done: jnp.ndarray
    # Nonmonotonic (Conn-Gould-Toint) bookkeeping.
    minimum_cost: jnp.ndarray
    reference_cost: jnp.ndarray
    candidate_cost: jnp.ndarray
    acc_reference_mcc: jnp.ndarray
    acc_candidate_mcc: jnp.ndarray
    num_nonmonotonic: jnp.ndarray
    # (max_iterations, 4) rows [cost, step_quality, radius, accepted] when
    # LMConfig.trace, else (0, 4).
    trace: jnp.ndarray


class LMResult(NamedTuple):
    q: jnp.ndarray
    t: jnp.ndarray
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    num_iterations: jnp.ndarray
    num_successful_steps: jnp.ndarray
    # Per-LM-iteration [cost, step_quality, radius, accepted]; empty (0, 4)
    # unless LMConfig.trace. Rows beyond num_iterations are zeros.
    trace: jnp.ndarray


def _residuals(q, t, source, targets):
    """r_ij = y_ij - (R(q) x_i + t); source (N,3), targets (N,K,3)."""
    moved = quat_rotate_points(q, source) + t  # (N, 3)
    return targets - moved[:, None, :]


def _weighted_cost(r, w, mask, axis_name=None):
    e2 = jnp.sum(r * r, axis=-1)
    cost = 0.5 * jnp.sum(jnp.where(mask, w * e2, 0.0))
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    return cost


def _normal_equations(q, t, source, targets, w, mask, axis_name=None):
    """Reference-clarity direct form: (H (7,7), g (7,), cost).

    H = sum w J^T J, g = sum w J^T r with J = [-A, -I3],
    A_i = d(R(q) x_i)/dq (3,4). Kept as the ground truth the fused
    moments path (`_estep_moments` + `_normal_from_moments`) is
    parity-tested against (tests/test_em_lm.py); the hot solve no
    longer calls it.
    """
    r = _residuals(q, t, source, targets)  # (N, K, 3)
    wm = jnp.where(mask, w, 0.0)
    sw = jnp.sum(wm, axis=-1)  # (N,)
    m = jnp.sum(wm[..., None] * r, axis=1)  # (N, 3)
    cost = 0.5 * jnp.sum(wm * jnp.sum(r * r, axis=-1))

    # A: (N, 3, 4) Jacobian of the scale-invariant rotation wrt q.
    A = jax.jacfwd(lambda qq: quat_rotate(qq, source))(q)

    h_qq = jnp.einsum("n,nia,nib->ab", sw, A, A, precision=_HIGHEST)
    h_qt = jnp.einsum("n,nba->ab", sw, A, precision=_HIGHEST)  # (4, 3)
    h_tt = jnp.sum(sw) * jnp.eye(3, dtype=source.dtype)
    H = jnp.block([[h_qq, h_qt], [h_qt.T, h_tt]])

    g_q = -jnp.einsum("nba,nb->a", A, m, precision=_HIGHEST)
    g_t = -jnp.sum(m, axis=0)
    g = jnp.concatenate([g_q, g_t])
    if axis_name is not None:
        H, g, cost = jax.lax.psum((H, g, cost), axis_name)
    return H, g, cost


class _Moments(NamedTuple):
    """Sufficient statistics of one E-step pass over the (N, K) table.

    ``quat_rotate`` is exactly linear in the point (a 3x3 matrix apply), so
    every quantity the LM step needs — normal equations, gradient, current
    cost, and the candidate cost at ANY trial iterate sharing the current
    weights — reduces to these 26 scalars. One fused read of the (N, K, 3)
    neighbor tensor per LM iteration replaces the three passes of the
    direct form (E-step, normal equations, candidate-cost evaluation); the
    Ceres analogue re-evaluates every residual block for each of those
    (weight_updater_callback.hpp:42-51 plus the solver's own evaluations).
    """

    m0: jnp.ndarray   # sum_i sw_i                      (scalar)
    m1: jnp.ndarray   # sum_i sw_i x_i                  (3,)
    m2: jnp.ndarray   # sum_i sw_i x_i x_i^T            (3, 3)
    sm: jnp.ndarray   # sum_i m_i                       (3,)
    smx: jnp.ndarray  # sum_i m_i x_i^T                 (3, 3)
    cost: jnp.ndarray # 0.5 sum_ij w_ij |r_ij|^2        (scalar)


def _rotation_matrix(q, dtype):
    """M(q) with quat_rotate(q, x) == M(q) @ x, bit-consistent with the
    operator (columns are the rotated basis vectors)."""
    return quat_rotate(q, jnp.eye(3, dtype=dtype)).T


def _estep_moments(q, t, source, targets, mask, dof, dimension, axis_name=None):
    """E-step + sufficient statistics in one fused (N, K) pass."""
    r = _residuals(q, t, source, targets)  # (N, K, 3)
    e2 = jnp.sum(r * r, axis=-1)
    w = update_weights(e2, mask, dof=dof, dimension=dimension)
    wm = jnp.where(mask, w, 0.0)
    sw = jnp.sum(wm, axis=-1)  # (N,)
    m = jnp.sum(wm[..., None] * r, axis=1)  # (N, 3)
    cost = 0.5 * jnp.sum(wm * e2)
    stats = _Moments(
        m0=jnp.sum(sw),
        m1=jnp.dot(sw, source, precision=_HIGHEST),
        m2=jnp.einsum("n,na,nb->ab", sw, source, source, precision=_HIGHEST),
        sm=jnp.sum(m, axis=0),
        smx=jnp.einsum("na,nb->ab", m, source, precision=_HIGHEST),
        cost=cost,
    )
    if axis_name is not None:
        # One collective of 26 scalars replaces the per-step psum of
        # (H, g, cost) — same information, moved before the (replicated)
        # tiny algebra below.
        stats = jax.lax.psum(stats, axis_name)
    return stats


def _normal_from_moments(q, stats: _Moments, dtype):
    """(H (7,7), g (7,)) from the moment statistics.

    A_i = d(R(q) x_i)/dq = J . x_i with J[c,d,a] = dM(q)[c,d]/dq_a, so the
    big-N contractions of the direct form collapse onto the moments:
      H_qq[a,b] = sum_i sw_i (A_i^T A_i)[a,b] = J[c,d,a] J[c,e,b] m2[d,e]
      H_qt[a,b] = sum_i sw_i A_i[b,:,a]      = J[b,d,a] m1[d]
      g_q[a]    = -sum_i (A_i^T m_i)[a]      = -J[c,d,a] smx[c,d]
    """
    J = jax.jacfwd(lambda qq: _rotation_matrix(qq, dtype))(q)  # (3, 3, 4)
    h_qq = jnp.einsum("cda,ceb,de->ab", J, J, stats.m2)
    h_qt = jnp.einsum("bda,d->ab", J, stats.m1)  # (4, 3)
    h_tt = stats.m0 * jnp.eye(3, dtype=dtype)
    H = jnp.block([[h_qq, h_qt], [h_qt.T, h_tt]])
    g = jnp.concatenate([-jnp.einsum("cda,cd->a", J, stats.smx), -stats.sm])
    return H, g


def _cost_change_from_moments(q, t, q_new, t_new, stats: _Moments, dtype):
    """cost(q,t) - cost(q_new,t_new) under the CURRENT weights, exactly.

    With d_i = (M(q_new) - M(q)) x_i + (t_new - t) the per-slot identity
    |r_ij - d_i|^2 = |r_ij|^2 - 2 r_ij.d_i + |d_i|^2 gives
      cost_change = sum_i m_i.d_i - 0.5 sum_i sw_i |d_i|^2
    — evaluated from the moments in O(1), no pass over the neighbor
    tensor, and better conditioned than (cost - recomputed candidate):
    the difference is formed from small step-scale terms instead of
    subtracting two nearly equal totals.
    """
    dM = _rotation_matrix(q_new, dtype) - _rotation_matrix(q, dtype)
    dt = t_new - t
    dm = jnp.sum(dM * stats.smx) + dt @ stats.sm
    swd2 = (
        jnp.sum((dM.T @ dM) * stats.m2)
        + 2.0 * dt @ (dM @ stats.m1)
        + stats.m0 * (dt @ dt)
    )
    return dm - 0.5 * swd2


@partial(jax.jit, static_argnames=("config",))
def em_lm_solve(
    source: jnp.ndarray,
    targets: jnp.ndarray,
    mask: jnp.ndarray,
    q0: jnp.ndarray,
    t0: jnp.ndarray,
    config: LMConfig,
) -> LMResult:
    """Run one full inner EM solve (the reference's ``solve()``,
    iteration.hpp:52-57) and return the estimated transform + cost summary.

    Args:
      source: (N, 3) source points (already moved by the outer loop).
      targets: (N, K, 3) gathered target neighbors per source point.
      mask: (N, K) validity of each association slot.
      q0 / t0: initial quaternion (w,x,y,z) and translation
        (params.initial_rotation / initial_translation, iteration.hpp:31-34).
      config: static LM configuration.
    """
    # The O(1) algebra below (7x7 normal equations, step and cost-change
    # dots) traces at full precision too.
    with jax.default_matmul_precision("highest"):
        return _em_lm_solve(source, targets, mask, q0, t0, config)


def _em_lm_solve(source, targets, mask, q0, t0, config):
    dtype = source.dtype
    f = lambda v: jnp.asarray(v, dtype)

    def moments(q, t):
        return _estep_moments(
            q, t, source, targets, mask,
            config.dof, config.dimension, config.axis_name,
        )

    # Initial E-step at the initial iterate (iteration.hpp:49 invokes the
    # weight callback once at construction, before the first LM step).
    initial_cost = moments(q0, t0).cost

    init = LMState(
        q=q0.astype(dtype),
        t=t0.astype(dtype),
        cost=initial_cost,
        radius=f(config.initial_radius),
        decrease_factor=f(2.0),
        iteration=jnp.asarray(0, jnp.int32),
        num_successful=jnp.asarray(1, jnp.int32),  # Ceres counts iteration 0
        done=jnp.asarray(False),
        minimum_cost=initial_cost,
        reference_cost=initial_cost,
        candidate_cost=initial_cost,
        acc_reference_mcc=f(0.0),
        acc_candidate_mcc=f(0.0),
        num_nonmonotonic=jnp.asarray(0, jnp.int32),
        trace=jnp.zeros(
            (config.max_iterations if config.trace else 0, 4), dtype
        ),
    )

    def cond(s: LMState):
        return jnp.logical_and(~s.done, s.iteration < config.max_iterations)

    def body(s: LMState) -> LMState:
        # E-step at the current iterate (weight_updater_callback.hpp:36-63
        # fires after every LM iteration; on rejected steps the iterate is
        # unchanged so recomputing is idempotent). ONE fused pass over the
        # (N, K) table yields the weights' sufficient statistics; everything
        # below is O(1) in N.
        st = moments(s.q, s.t)
        cost = st.cost
        H, g = _normal_from_moments(s.q, st, dtype)

        # Levenberg-Marquardt step: (H + diag(clamp(diag H)) / radius) d = -g.
        diag = jnp.clip(jnp.diagonal(H), config.min_lm_diagonal, config.max_lm_diagonal)
        H_damped = H + jnp.diag(diag / s.radius)
        delta = jnp.linalg.solve(H_damped, -g)
        delta_finite = jnp.all(jnp.isfinite(delta))
        step_ok = delta_finite
        delta = jnp.where(step_ok, delta, 0.0)

        q_new = s.q + delta[:4]
        t_new = s.t + delta[4:]
        # Candidate cost under the current weights, closed-form from the
        # moments (no second pass over the neighbor tensor).
        cost_change_fwd = _cost_change_from_moments(
            s.q, s.t, q_new, t_new, st, dtype
        )
        candidate_cost = cost - cost_change_fwd

        # Model cost change m(0) - m(delta) = -(g.d + 0.5 d^T H d).
        model_cost_change = -(g @ delta + 0.5 * delta @ (H @ delta))
        step_ok &= model_cost_change > 0
        step_ok &= jnp.isfinite(candidate_cost)

        relative_decrease = cost_change_fwd / model_cost_change
        historical = (s.reference_cost - candidate_cost) / (
            s.acc_reference_mcc + model_cost_change
        )
        if config.use_nonmonotonic_steps:
            step_quality = jnp.maximum(relative_decrease, historical)
        else:
            step_quality = relative_decrease
        accepted = step_ok & (step_quality > config.min_relative_decrease)

        # --- trust-region radius update (Ceres LevenbergMarquardtStrategy) --
        boost = 1.0 / jnp.maximum(
            f(1.0 / 3.0), 1.0 - (2.0 * step_quality - 1.0) ** 3
        )
        radius_acc = jnp.minimum(s.radius * boost, f(_MAX_TRUST_REGION_RADIUS))
        radius_rej = s.radius / s.decrease_factor
        radius = jnp.where(accepted, radius_acc, radius_rej)
        decrease_factor = jnp.where(accepted, f(2.0), s.decrease_factor * 2.0)

        # --- nonmonotonic bookkeeping on acceptance -------------------------
        new_cost = jnp.where(accepted, candidate_cost, cost)
        acc_cand = s.acc_candidate_mcc + model_cost_change
        acc_ref = s.acc_reference_mcc + model_cost_change
        improved = new_cost < s.minimum_cost
        minimum_cost = jnp.where(accepted & improved, new_cost, s.minimum_cost)
        num_nm = jnp.where(
            accepted, jnp.where(improved, 0, s.num_nonmonotonic + 1), s.num_nonmonotonic
        )
        cand_cost = jnp.where(
            accepted & (improved | (new_cost > s.candidate_cost)), new_cost, s.candidate_cost
        )
        acc_cand = jnp.where(
            accepted & (improved | (new_cost > s.candidate_cost)), f(0.0), jnp.where(accepted, acc_cand, s.acc_candidate_mcc)
        )
        promote = accepted & (num_nm == _MAX_CONSECUTIVE_NONMONOTONIC_STEPS)
        reference_cost = jnp.where(promote, cand_cost, s.reference_cost)
        acc_ref = jnp.where(promote, acc_cand, jnp.where(accepted, acc_ref, s.acc_reference_mcc))

        # --- convergence -----------------------------------------------------
        ftol_hit = accepted & (
            jnp.abs(cost_change_fwd) <= config.function_tolerance * cost
        )
        # Ceres ParameterToleranceReached: checked on every valid trust-region
        # step, accepted or not (TrustRegionMinimizer tests the candidate x
        # before step acceptance) — at the cost rounding floor every tiny
        # step gets rejected, so gating this on acceptance would leave only
        # the dead-radius exit. Guard on delta_finite: a failed linear solve
        # zeroes delta and must not read as a zero-length step.
        x_norm = jnp.sqrt(s.q @ s.q + s.t @ s.t)
        xtol = f(config.parameter_tolerance)
        xtol_hit = delta_finite & (
            jnp.sqrt(delta @ delta) <= xtol * (x_norm + xtol)
        )
        dead_radius = radius < _MIN_TRUST_REGION_RADIUS
        done = ftol_hit | xtol_hit | dead_radius | ~jnp.isfinite(new_cost)

        trace = s.trace
        if config.trace:
            row = jnp.stack(
                [new_cost, step_quality, radius, accepted.astype(dtype)]
            )
            trace = jax.lax.dynamic_update_index_in_dim(
                trace, row, s.iteration, 0
            )

        return LMState(
            q=jnp.where(accepted, q_new, s.q),
            t=jnp.where(accepted, t_new, s.t),
            cost=new_cost,
            radius=radius,
            decrease_factor=decrease_factor,
            iteration=s.iteration + 1,
            num_successful=s.num_successful + accepted.astype(jnp.int32),
            done=done,
            minimum_cost=minimum_cost,
            reference_cost=reference_cost,
            candidate_cost=cand_cost,
            acc_reference_mcc=acc_ref,
            acc_candidate_mcc=acc_cand,
            num_nonmonotonic=num_nm,
            trace=trace,
        )

    final = jax.lax.while_loop(cond, body, init)
    return LMResult(
        q=final.q,
        t=final.t,
        initial_cost=initial_cost,
        final_cost=final.cost,
        num_iterations=final.iteration,
        num_successful_steps=final.num_successful,
        trace=final.trace,
    )
