"""Distributed pose-graph optimization over relative-pose constraints.

The reference has no multi-scan machinery — sequences are registered pair by
pair and drift accumulates unchecked (its durable outputs are per-pair only,
src/prob_point_cloud_registration_ex.cc:161-183). This module closes that gap
with a device-native global refinement: poses are nodes, odometry pairs and loop
closures are edges with relative-SE(3) measurements, and the maximum-
likelihood trajectory is found by damped Gauss-Newton.

Device-first design:
  * No sparse matrices. The Gauss-Newton system is solved matrix-free by
    conjugate gradients, with Hessian-vector products composed from one JVP
    and one VJP through the residual function — XLA fuses each matvec into a
    few kernels over the dense (E, ...) edge arrays.
  * State is a (P, 6) twist-tangent update retracted onto the base poses each
    outer iteration; gauge freedom is removed by projecting pose 0's update
    to zero inside every matvec (hard gauge, keeps CG well-posed with plain
    damping).
  * Edge residuals are fully data-parallel: shard the edge arrays over the
    ``"points"`` mesh axis and psum the CG reductions — the same collective
    layout as the registration solver (see parallel/distributed.py). A
    ``shard_map`` wrapper is provided by ``make_sharded_pose_graph_solver``.

Residual (per edge (i, j) with measurement T_ij): r = [2 * vec(q_err),
t_err] * sqrt(w), where q_err is the quaternion of T_ij^{-1} (P_i^{-1} P_j)
(small-angle: 2*vec ~ rotation vector) and t_err its translation.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.se3 import (
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_to_matrix,
    unit_quat_rotate,
)


class PoseGraphConfig(NamedTuple):
    max_iterations: int = 20
    cg_iterations: int = 50
    damping: float = 1e-6
    tolerance: float = 1e-10  # relative cost-change stop
    axis_name: Optional[str] = None  # psum axis for sharded edges
    # Block-Jacobi PCG: precondition each CG solve with the inverted 6x6
    # diagonal blocks of J^T J + damping*I (the per-pose block reduction of
    # the Gauss-Newton system). Pure convergence accelerator — any SPD
    # preconditioner leaves the solution unchanged; on a drifted loop the
    # same CG budget reaches the GN step's true solution in far fewer
    # iterations because the damped system's per-pose scale disparity
    # (odometry chains vs 10x-weighted closures) is normalized away.
    precondition: bool = True


def _exp_quat(w):
    """Rotation-vector -> quaternion (w, x, y, z); small-angle safe."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-30))
    half = 0.5 * theta
    small = theta2 < 1e-12
    sinc = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    return jnp.concatenate([jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half)), w * sinc], -1)


def _retract(base_q, base_t, delta):
    """Left-multiplicative retraction: (exp(dw), dt) applied to each pose."""
    dq = _exp_quat(delta[:, :3])
    q = jax.vmap(quat_multiply)(dq, base_q)
    t = jax.vmap(unit_quat_rotate)(dq, base_t) + delta[:, 3:]
    return q, t


def _edge_residuals(q, t, edges_i, edges_j, rel_q_inv, rel_t, sqrt_w):
    """(E, 6) weighted residuals of T_ij^{-1} (P_i^{-1} P_j)."""
    qi, ti = q[edges_i], t[edges_i]
    qj, tj = q[edges_j], t[edges_j]
    qi_inv = jax.vmap(quat_conjugate)(qi)
    # P_i^{-1} P_j
    q_ij = jax.vmap(quat_multiply)(qi_inv, qj)
    t_ij = jax.vmap(unit_quat_rotate)(qi_inv, tj - ti)
    # T_meas^{-1} * (P_i^{-1} P_j)
    q_err = jax.vmap(quat_multiply)(rel_q_inv, q_ij)
    t_err = jax.vmap(unit_quat_rotate)(rel_q_inv, t_ij) + rel_t
    # Sign-fix the double cover so the residual is continuous at identity.
    q_err = jnp.where(q_err[:, :1] < 0, -q_err, q_err)
    r = jnp.concatenate([2.0 * q_err[:, 1:], t_err], axis=-1)
    return r * sqrt_w[:, None]


def _conjugate_gradient(matvec, b, maxiter: int, rtol: float = 1e-5,
                        precond=None):
    """(Preconditioned) CG with explicit carries (scipy-style rtol stopping).

    Replaces ``jax.scipy.sparse.linalg.cg``: its ``custom_linear_solve``
    wrapper marks the solution varying under shard_map's vma analysis even
    when every operand is replicated, which would force ``check_vma=False``
    on the sharded pose-graph solver. Here the iterate/residual/direction
    carries are ordinary replicated vectors (``matvec`` psums internally),
    so the static replication proof goes through. ``precond`` applies an
    SPD M^-1 (block-Jacobi here); stopping still tests the TRUE residual
    norm so preconditioning never loosens the solution.
    """
    tol2 = (rtol * jnp.sqrt(jnp.sum(b * b))) ** 2
    apply_m = precond if precond is not None else (lambda x: x)
    z0 = apply_m(b)

    def cond(c):
        _, _, _, _, rs, i = c
        return jnp.logical_and(i < maxiter, rs > tol2)

    def body(c):
        x, r, p, rz, _, i = c
        ap = matvec(p)
        alpha = rz / jnp.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / rz) * p
        return (x, r, p, rz_new, jnp.sum(r * r), i + 1)

    x0 = jnp.zeros_like(b)
    x, *_ = jax.lax.while_loop(
        cond, body,
        (x0, b, z0, jnp.sum(b * z0), jnp.sum(b * b), jnp.int32(0)),
    )
    return x


def _block_jacobi_blocks(q, t, edges_i, edges_j, rel_q_inv, rel_t, sqrt_w,
                         n_poses: int):
    """Per-pose 6x6 diagonal blocks of J^T J, assembled edge-parallel.

    Each edge residual touches exactly poses (i, j); its (6, 12) Jacobian is
    taken per edge with ``jacfwd`` through the SAME retraction + residual
    code the solver linearizes, and the A^T A / B^T B halves scatter-add
    into the (P, 6, 6) block diagonal — the dense-array analogue of a
    sparse block reduction (no sparse matrices, XLA-fusable).
    """

    def one_edge(qi, ti, qj, tj, rqi, rtt, sw):
        bq = jnp.stack([qi, qj])
        bt = jnp.stack([ti, tj])
        ei = jnp.zeros((1,), jnp.int32)
        ej = jnp.ones((1,), jnp.int32)

        def res(d):
            q2, t2 = _retract(bq, bt, d)
            return _edge_residuals(
                q2, t2, ei, ej, rqi[None], rtt[None], sw[None]
            )[0]

        jac = jax.jacfwd(res)(jnp.zeros((2, 6), qi.dtype))  # (6, 2, 6)
        a, b_ = jac[:, 0, :], jac[:, 1, :]
        return a.T @ a, b_.T @ b_

    ha, hb = jax.vmap(one_edge)(
        q[edges_i], t[edges_i], q[edges_j], t[edges_j],
        rel_q_inv, rel_t, sqrt_w,
    )
    blocks = jnp.zeros((n_poses, 6, 6), q.dtype)
    return blocks.at[edges_i].add(ha).at[edges_j].add(hb)


@partial(jax.jit, static_argnames=("config",))
def optimize_pose_graph_qt(
    base_q,
    base_t,
    edges_i,
    edges_j,
    rel_q,
    rel_t,
    weights,
    config: PoseGraphConfig,
):
    """Gauss-Newton pose-graph solve on (P, 4)+(P, 3) pose arrays.

    Returns (q (P,4), t (P,3), final_cost). Pose 0 is gauge-fixed.
    """
    n_poses = base_q.shape[0]
    axis = config.axis_name
    rel_q_inv = jax.vmap(quat_conjugate)(jax.vmap(quat_normalize)(rel_q))
    # Precompute measurement translation term: -R_meas^{-1} t_meas.
    rel_t_term = -jax.vmap(unit_quat_rotate)(rel_q_inv, rel_t)
    sqrt_w = jnp.sqrt(weights)

    def psum(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    def gauge(delta):
        return delta.at[0].set(0.0)

    def total_cost(q, t):
        r = _edge_residuals(q, t, edges_i, edges_j, rel_q_inv, rel_t_term, sqrt_w)
        return 0.5 * psum(jnp.sum(r * r))

    def gn_step(carry):
        q, t, cost, it, done = carry

        def resid_of_delta(delta):
            dq, dt = _retract(q, t, gauge(delta))
            return _edge_residuals(
                dq, dt, edges_i, edges_j, rel_q_inv, rel_t_term, sqrt_w
            )

        delta0 = jnp.zeros((n_poses, 6), q.dtype)
        r0, jvp_lin = jax.linearize(resid_of_delta, delta0)
        _, vjp = jax.vjp(resid_of_delta, delta0)

        def hvp(v):
            jv = jvp_lin(v)
            (jtjv,) = vjp(jv)
            return psum(jtjv) + config.damping * v

        g = psum(vjp(r0)[0])  # J^T r
        precond = None
        if config.precondition:
            blocks = psum(
                _block_jacobi_blocks(
                    q, t, edges_i, edges_j, rel_q_inv, rel_t_term, sqrt_w,
                    n_poses,
                )
            ) + config.damping * jnp.eye(6, dtype=q.dtype)[None]
            m_inv = jnp.linalg.inv(blocks)  # (P, 6, 6), SPD by construction

            def precond(r):
                return jnp.einsum("pij,pj->pi", m_inv, r)

        delta = _conjugate_gradient(
            hvp, -g, config.cg_iterations, precond=precond
        )
        q_new, t_new = _retract(q, t, gauge(delta))
        q_new = jax.vmap(quat_normalize)(q_new)
        new_cost = total_cost(q_new, t_new)
        improved = new_cost < cost
        q = jnp.where(improved, q_new, q)
        t = jnp.where(improved, t_new, t)
        cost_next = jnp.where(improved, new_cost, cost)
        rel_change = jnp.abs(cost - cost_next) / jnp.maximum(cost, 1e-30)
        done = (~improved) | (rel_change < config.tolerance)
        return q, t, cost_next, it + 1, done

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_and(~done, it < config.max_iterations)

    init_cost = total_cost(base_q, base_t)
    q, t, cost, _, _ = jax.lax.while_loop(
        cond, gn_step, (base_q, base_t, init_cost, jnp.int32(0), jnp.asarray(False))
    )
    return q, t, cost


def optimize_pose_graph(
    poses: Sequence[np.ndarray],
    edges: Sequence[Tuple[int, int, np.ndarray]],
    *,
    weights: Optional[Sequence[float]] = None,
    config: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[list, float]:
    """Numpy-facing wrapper: 4x4 poses + (i, j, T_ij 4x4) edges.

    Returns (refined 4x4 poses, final cost). Pose 0 is held fixed (gauge).
    """
    from ..core.se3 import np_matrix_to_quat

    base_q = jnp.asarray(np.stack([np_matrix_to_quat(p[:3, :3]) for p in poses]))
    base_t = jnp.asarray(np.stack([p[:3, 3] for p in poses]))
    ei = jnp.asarray(np.array([e[0] for e in edges], dtype=np.int32))
    ej = jnp.asarray(np.array([e[1] for e in edges], dtype=np.int32))
    rq = jnp.asarray(np.stack([np_matrix_to_quat(e[2][:3, :3]) for e in edges]))
    rt = jnp.asarray(np.stack([e[2][:3, 3] for e in edges]))
    w = jnp.asarray(
        np.ones(len(edges)) if weights is None else np.asarray(weights, np.float64)
    ).astype(base_t.dtype)

    q, t, cost = optimize_pose_graph_qt(base_q, base_t, ei, ej, rq, rt, w, config)
    q = np.asarray(q)
    t = np.asarray(t)
    out = []
    for k in range(q.shape[0]):
        m = np.eye(4)
        m[:3, :3] = np.asarray(quat_to_matrix(jnp.asarray(q[k])))
        m[:3, 3] = t[k]
        out.append(m)
    return out, float(cost)


def odometry_edges(relative_transforms: Sequence[np.ndarray], weight: float = 1.0):
    """Chain edges (k, k+1, T_rel_k) from an odometry run
    (models/odometry.py's relative_transforms)."""
    return [
        (k, k + 1, np.asarray(t, dtype=np.float64))
        for k, t in enumerate(relative_transforms)
    ]


def make_sharded_pose_graph_solver(mesh: jax.sharding.Mesh, config: PoseGraphConfig):
    """Edge-sharded pose-graph solve under shard_map over the points axis.

    Poses replicate on every device; edge arrays shard; CG reductions psum.
    Edge count must divide the points-axis size.
    """
    from ..parallel.mesh import POINTS_AXIS
    from ..parallel.mesh import (
        supports_structural_replication as _supports_structural_replication,
    )

    P = jax.sharding.PartitionSpec
    cfg = config._replace(axis_name=POINTS_AXIS)

    def body(base_q, base_t, ei, ej, rq, rt, w):
        return optimize_pose_graph_qt(base_q, base_t, ei, ej, rq, rt, w, cfg)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(POINTS_AXIS), P(POINTS_AXIS), P(POINTS_AXIS),
                  P(POINTS_AXIS), P(POINTS_AXIS)),
        out_specs=(P(), P(), P()),
        # psum-reduced outputs are provably replicated under the vma
        # checker; parity also tested on the CPU mesh.
        check_vma=_supports_structural_replication(),
    )
    return jax.jit(sharded)
