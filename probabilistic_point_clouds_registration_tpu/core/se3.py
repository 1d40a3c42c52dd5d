"""SE(3) rigid-transform math for the registration engine.

Quaternion convention is (w, x, y, z), matching the reference's Ceres usage
(reference: include/prob_point_cloud_registration/error_term.hpp:31 uses
``ceres::QuaternionRotatePoint`` whose rotation operator normalizes a general
quaternion before rotating, and prob_point_cloud_registration_params.hpp:14
stores ``initial_rotation[4] = {1,0,0,0}`` i.e. (w,x,y,z)).

All functions are pure JAX, jit/vmap-friendly, and dtype-polymorphic (f32 on
the device, f64 under x64 for parity tests and the reference). Host-side composition helpers work
on numpy arrays in float64 so the transformation history is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SE3(NamedTuple):
    """A rigid transform ``p -> R(q) p + t``.

    Attributes:
      q: quaternion (w, x, y, z), shape (4,). Not necessarily unit norm; the
         rotation operator is scale invariant (see :func:`quat_rotate`).
      t: translation, shape (3,).
    """

    q: jnp.ndarray
    t: jnp.ndarray

    @staticmethod
    def identity(dtype=jnp.float32) -> "SE3":
        return SE3(
            q=jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype),
            t=jnp.zeros((3,), dtype=dtype),
        )


def quat_normalize(q):
    """Return q / ||q||."""
    return q / jnp.linalg.norm(q)


def unit_quat_rotate(q, v):
    """Rotate 3-vector(s) ``v`` by a *unit* quaternion ``q`` (w, x, y, z).

    Uses the 2-cross-product formula: ``v' = v + 2 w (u x v) + 2 u x (u x v)``
    with u the vector part. Broadcasts over leading dims of ``v``.
    """
    w = q[0]
    u = q[1:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_rotate(q, v):
    """Rotate by a general (possibly non-unit) quaternion.

    Scale-invariant: normalizes ``q`` first, matching the semantics of the
    rotation operator applied to the raw 4-vector parameter block in the
    reference solver (error_term.hpp:31), which never constrains the
    quaternion to the unit sphere (prob_point_cloud_registration_iteration.hpp
    adds no manifold; the quaternion is only normalized when the final
    transform is extracted, :62-63).
    """
    return unit_quat_rotate(quat_normalize(q), v)


def quat_rotate_points(q, pts):
    """Rotate an (N, 3) point array by ``q`` via one (N, 3) @ (3, 3) product.

    Mathematically identical to ``quat_rotate`` (the rotation is linear in
    the point); the product form avoids the cross-product form's shuffles
    along a 3-wide minor dimension. HIGHEST precision keeps the 3-term dots
    at f32 accuracy (a GPU may run a default-precision f32 dot in TF32,
    ~3 significant digits, which would truncate LiDAR-scale coordinates).
    Rounding differs from
    ``quat_rotate`` in the last bits; use ONE form consistently within any
    path whose outputs are compared bit-for-bit.
    """
    m_t = quat_rotate(q, jnp.eye(3, dtype=pts.dtype))  # row j = M column j
    return jax.lax.dot_general(
        pts, m_t, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def quat_multiply(a, b):
    """Hamilton product a*b, both (w, x, y, z)."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_conjugate(q):
    return jnp.stack([q[0], -q[1], -q[2], -q[3]])


def quat_to_matrix(q):
    """Unit-normalize ``q`` and return the 3x3 rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def matrix_to_quat(m):
    """Rotation matrix -> quaternion (w, x, y, z), Shepperd's branch-free form.

    Works on numpy or jax arrays of shape (3, 3); uses jnp ops so it is
    jittable. The returned quaternion has w >= 0.
    """
    m = jnp.asarray(m)
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best (largest pivot).
    qw = jnp.stack(
        [
            1.0 + tr,
            m21 - m12,
            m02 - m20,
            m10 - m01,
        ]
    )
    qx = jnp.stack(
        [
            m21 - m12,
            1.0 + m00 - m11 - m22,
            m01 + m10,
            m02 + m20,
        ]
    )
    qy = jnp.stack(
        [
            m02 - m20,
            m01 + m10,
            1.0 - m00 + m11 - m22,
            m12 + m21,
        ]
    )
    qz = jnp.stack(
        [
            m10 - m01,
            m02 + m20,
            m12 + m21,
            1.0 - m00 - m11 + m22,
        ]
    )
    pivots = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22])
    best = jnp.argmax(pivots)
    q = jnp.stack([qw, qx, qy, qz])[best]
    q = q / jnp.linalg.norm(q)
    return jnp.where(q[0] < 0, -q, q)


def se3_apply(tf: SE3, points):
    """Apply ``tf`` to points of shape (..., 3)."""
    return quat_rotate(tf.q, points) + tf.t


def se3_compose(a: SE3, b: SE3) -> SE3:
    """Return the transform equal to applying ``b`` first, then ``a``."""
    qa = quat_normalize(a.q)
    qb = quat_normalize(b.q)
    return SE3(q=quat_multiply(qa, qb), t=unit_quat_rotate(qa, b.t) + a.t)


def se3_inverse(tf: SE3) -> SE3:
    q = quat_normalize(tf.q)
    qinv = quat_conjugate(q)
    return SE3(q=qinv, t=-unit_quat_rotate(qinv, tf.t))


def se3_to_matrix(tf: SE3):
    """4x4 homogeneous matrix."""
    r = quat_to_matrix(tf.q)
    top = jnp.concatenate([r, tf.t.reshape(3, 1)], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype)
    return jnp.concatenate([top, bottom], axis=0)


def se3_from_matrix(m) -> SE3:
    m = jnp.asarray(m)
    return SE3(q=matrix_to_quat(m[:3, :3]), t=m[:3, 3])


# ---------------------------------------------------------------------------
# Host-side (numpy) variants of the hot outer-loop composition math.
#
# The outer registration loop composes 4x4 f64 transforms on the HOST between
# device chunks (models/registration.py). Calling the jitted jnp helpers there
# dispatches a tiny program to the accelerator and waits for it PER OUTER
# ITERATION — these numpy twins are semantically identical and free.
# ---------------------------------------------------------------------------


def np_matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`matrix_to_quat` (Shepperd pivot, w >= 0)."""
    m = np.asarray(m, dtype=np.float64)
    m00, m01, m02 = m[0]
    m10, m11, m12 = m[1]
    m20, m21, m22 = m[2]
    tr = m00 + m11 + m22
    pivots = np.array(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22]
    )
    cands = np.array(
        [
            [1.0 + tr, m21 - m12, m02 - m20, m10 - m01],
            [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
            [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
            [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
        ]
    )
    q = cands[int(np.argmax(pivots))]
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q


def np_quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`quat_to_matrix` for a unit quaternion (w,x,y,z)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def np_se3_matrix(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 homogeneous matrix from a (normalized) quaternion + translation."""
    out = np.eye(4)
    out[:3, :3] = np_quat_to_matrix(q)
    out[:3, 3] = np.asarray(t, dtype=np.float64)
    return out


# ---------------------------------------------------------------------------
# Euler-angle conventions (report + parameter parity with the reference)
# ---------------------------------------------------------------------------


def euler_zyx_to_quat(roll, pitch, yaw):
    """ZYX composition: q = Rz(yaw) * Ry(pitch) * Rx(roll).

    Matches the reference's ``euler2Quaternion`` (utilities.hpp:252-263),
    which composes yawAngle * pitchAngle * rollAngle about unit Z, Y, X.
    """

    def axis_angle(axis, angle):
        half = 0.5 * jnp.asarray(angle)
        s = jnp.sin(half)
        vec = jnp.array(axis, dtype=s.dtype) * s
        return jnp.concatenate([jnp.cos(half)[None], vec])

    qz = axis_angle([0.0, 0.0, 1.0], yaw)
    qy = axis_angle([0.0, 1.0, 0.0], pitch)
    qx = axis_angle([1.0, 0.0, 0.0], roll)
    return quat_multiply(quat_multiply(qz, qy), qx)


def matrix_euler_xyz(m):
    """Extract (a0, a1, a2) with R = Rx(a0) @ Ry(a1) @ Rz(a2), a0 in [0, pi].

    Reproduces the angle-range normalization Eigen's ``eulerAngles(0, 1, 2)``
    applies, since the reference's CSV report columns roll/pitch/yaw come from
    exactly that call (src/prob_point_cloud_registration.cc:123). Pure numpy
    (host-side report path).
    """
    m = np.asarray(m, dtype=np.float64)
    # R = Rx(a0) Ry(a1) Rz(a2):
    #   R[0,0] = c1 c2;  R[0,1] = -c1 s2;  R[0,2] = s1
    #   R[1,2] = -s0 c1; R[2,2] = c0 c1
    res0 = np.arctan2(m[1, 2], m[2, 2])
    c2 = np.hypot(m[0, 0], m[0, 1])
    # Eigen normalizes the first angle into [0, pi] (even-permutation branch):
    if res0 > 0:
        res0 = res0 - np.pi
        res1 = np.arctan2(-m[0, 2], -c2)
    else:
        res1 = np.arctan2(-m[0, 2], c2)
    s0, c0 = np.sin(res0), np.cos(res0)
    res2 = np.arctan2(s0 * m[2, 0] - c0 * m[1, 0], c0 * m[1, 1] - s0 * m[2, 1])
    return np.array([-res0, -res1, -res2])


# ---------------------------------------------------------------------------
# Host-side float64 transform history helpers
# ---------------------------------------------------------------------------


def compose_matrices(delta: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Left-compose: returns delta @ base (numpy float64 4x4 matrices).

    The reference accumulates ``current = iteration_transform * history.back()``
    (src/prob_point_cloud_registration.cc:101-107).
    """
    return np.asarray(delta, dtype=np.float64) @ np.asarray(base, dtype=np.float64)
