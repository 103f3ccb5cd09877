"""SE(3) Lie-group math in pure jnp.

Counterpart of the reference's ``bpvo/math_utils.h`` (``se3::exp``/``TwistToMatrix``
Rodrigues at math_utils.h:140-168, ``se3::log``/``MatrixToTwist`` at :170-199, Euler
conversions at :204-260, skew at :106-134) — but derived independently and written as
branch-free, jit-safe jnp with Taylor fallbacks near theta=0 instead of conditionals.

Twist ordering: ``p = (w1, w2, w3, v1, v2, v3)`` — rotation first, matching the
analytic photometric Jacobian in ``bpvo_tpu/vo/warp.py``.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def hat(w):
    """3-vector -> skew-symmetric matrix, hat(w) @ x == cross(w, x)."""
    w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(w1)
    return jnp.stack([
        jnp.stack([z, -w3, w2], axis=-1),
        jnp.stack([w3, z, -w1], axis=-1),
        jnp.stack([-w2, w1, z], axis=-1),
    ], axis=-2)


def _sinc_coeffs(theta_sq):
    """Branch-free Rodrigues coefficients.

    Returns (A, B, C) with
      A = sin(t)/t, B = (1-cos(t))/t^2, C = (1 - A)/t^2 = (t - sin t)/t^3,
    using 4th-order Taylor series when t^2 is tiny (below float32 noise).
    """
    t2 = theta_sq
    theta = jnp.sqrt(jnp.maximum(t2, _EPS))
    small = t2 < 1e-8
    A = jnp.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                  (1.0 - jnp.cos(theta)) / jnp.maximum(t2, _EPS))
    C = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                  (1.0 - A) / jnp.maximum(t2, _EPS))
    return A, B, C


def exp(p):
    """Twist (..., 6) -> SE(3) matrix (..., 4, 4) via closed-form Rodrigues."""
    p = jnp.asarray(p)
    w, v = p[..., :3], p[..., 3:]
    t2 = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_coeffs(t2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    # V = I + B*W + C*W^2 (left Jacobian of SO(3))
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def log(T):
    """SE(3) matrix (..., 4, 4) -> twist (..., 6).

    AD-safe at (and near) the identity: the small-angle branch derives
    theta^2 from the trace as 2(1-cos) — a smooth function — so jacfwd/jacrev
    never see the arccos gradient blowup at cos(theta)=1 (jnp.where masks
    tangents branch-wise, but only if the taken branch's own chain is finite).
    """
    T = jnp.asarray(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # smooth theta^2 surrogate for the small branch: theta^2 ~= 2(1 - cos)
    t2_small = 2.0 * (1.0 - cos_theta)
    small = t2_small < 1e-8
    theta = jnp.arccos(jnp.where(small, 0.0, cos_theta))  # exact branch only
    t2 = jnp.where(small, t2_small, theta * theta)
    # w = theta/(2 sin(theta)) * vee(R - R^T); near 0, -> 0.5 * vee(R - R^T)
    k = jnp.where(small, 0.5 + t2_small / 12.0,
                  theta / jnp.maximum(2.0 * jnp.sin(theta), _EPS))
    w = k[..., None] * jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    # V^{-1} = I - W/2 + (1/t^2)(1 - A/(2B)) W^2
    A, B, _ = _sinc_coeffs(t2)
    W = hat(w)
    W2 = W @ W
    coef = jnp.where(small, 1.0 / 12.0 + t2 / 720.0,
                     (1.0 - A / jnp.maximum(2.0 * B, _EPS)) / jnp.maximum(t2, _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([w, v], axis=-1)


def inverse(T):
    """Rigid-transform inverse without a general 4x4 solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -jnp.einsum("...ij,...j->...i", Rt, t)
    top = jnp.concatenate([Rt, ti[..., None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def orthonormalize(T):
    """Pull the rotation block of a rigid transform back onto SO(3) with one
    Newton step of the polar decomposition, R <- R (3I - R^T R) / 2.

    A pose built by composing many float32 increments gathers a rounding
    bias in its scale (~1e-7 per product); the rigid inverse (R^T) then
    stops being the inverse, and trajectories chained through keyframes
    amplify it.  One step squares the error, so calling this after each
    composition holds R orthonormal to float32 precision."""
    R = T[..., :3, :3]
    RtR = jnp.einsum("...ji,...jk->...ik", R, R)
    eye = jnp.eye(3, dtype=T.dtype)
    R = 0.5 * jnp.einsum("...ij,...jk->...ik", R, 3.0 * eye - RtR)
    return T.at[..., :3, :3].set(R)


def rotation_to_euler_deg(T):
    """Rotation matrix -> (roll, pitch, yaw)-style Euler angles in degrees.

    Used only for the keyframing rotation-magnitude test (reference vo.cc:210-216,
    math_utils.h:204-260): the exact convention matters less than the magnitude.
    """
    R = jnp.asarray(T)[..., :3, :3]
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    x = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    y = jnp.arctan2(-R[..., 2, 0], jnp.maximum(sy, _EPS))
    z = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([x, y, z], axis=-1) * (180.0 / jnp.pi)
