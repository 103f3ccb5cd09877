"""Rigid-body SE(3) warp: stereo back-projection, analytic photometric Jacobians,
Hartley normalization, and the disparity-space warp variant.

Counterpart of the reference's ``bpvo/rigid_body_warp.{h,cc}`` (``makePoint``
back-projection at rigid_body_warp.h:47-60, normalization-aware 1x6 Jacobian at
h:94-106, ``paramsToPose`` = normalization-conjugated ``se3::exp`` at h:132-138,
batch SSE ``computeJacobian`` at rigid_body_warp.cc:60-315), ``bpvo/warps.h``
(``HartlyNormalization`` at warps.cc:27-49) and ``bpvo/disparity_space_warp.h``.

Derivation (independent of the reference's MATLAB-generated code,
matlab/sym): with normalization T_n = [sI, -sc; 0, 1] the estimated increment
acts as  X(p) = T_n^{-1} exp(p) T_n X,  so at p = 0

    dX/dw = -(1/s) [s(X - c)]_x = -[(X - c)]_x        (rotation block)
    dX/dv = (1/s) I                                    (translation block)

and the image-intensity chain rule with projection u = fx X/Z + cx, v = fy Y/Z + cy
gives the 1x6 row  J = [Ix fx/Z, Iy fy/Z] . [du/dX; dv/dX] . [dX/dw | dX/dv].
The reference's hand-expanded formula (rigid_body_warp.h:94-106) is this same
expression; our tests check it against jax autodiff instead.

All functions are batched over N points as (N, ...) arrays — the reference's
six SSE column loops collapse into a handful of fused elementwise expressions.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from bpvo_tpu.core import se3


class CameraModel(NamedTuple):
    """Pinhole intrinsics + stereo baseline for one pyramid level."""
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    baseline: jnp.ndarray

    @classmethod
    def from_K(cls, K, baseline):
        K = jnp.asarray(K, jnp.float32)
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                   baseline=jnp.asarray(baseline, jnp.float32))

    def K(self):
        return jnp.array([[self.fx, 0.0, self.cx],
                          [0.0, self.fy, self.cy],
                          [0.0, 0.0, 1.0]], jnp.float32)

    def at_level(self, level: int) -> "CameraModel":
        """Per-level intrinsics: K scales by 0.5 per level while the baseline
        doubles (reference vo_frame.cc:13-29) so that Z = fx*b/d stays metric
        with full-resolution disparity values."""
        if level == 0:
            return self
        s = 1.0 / (1 << level)
        return CameraModel(fx=self.fx * s, fy=self.fy * s,
                           cx=self.cx * s, cy=self.cy * s,
                           baseline=self.baseline * (1 << level))


def make_points(cam: CameraModel, x, y, d):
    """Stereo back-projection (x, y, d) -> (N, 3) 3D points
    (reference rigid_body_warp.h:47-60): Z = fx b / d."""
    Z = cam.fx * cam.baseline / d
    X = (x - cam.cx) * Z / cam.fx
    Y = (y - cam.cy) * Z / cam.fy
    return jnp.stack([X, Y, Z], axis=-1)


def hartley_normalization(points, valid):
    """Zero-mean, sqrt(3)-mean-norm scaling of the point cloud
    (reference warps.cc:27-49), reduced over the valid mask only.

    Returns (scale s, center c) such that X' = s (X - c).
    """
    w = valid.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    c = jnp.sum(points * w[:, None], axis=0) / n
    m = jnp.sum(jnp.linalg.norm(points - c, axis=-1) * w) / n
    s = jnp.sqrt(3.0) / jnp.maximum(m, 1e-6)
    return s, c


def identity_normalization(dtype=jnp.float32):
    return jnp.asarray(1.0, dtype), jnp.zeros(3, dtype)


def normalization_matrix(s, c):
    """T_n = [sI | -sc; 0 1]."""
    T = jnp.eye(4, dtype=jnp.float32) * s
    T = T.at[3, 3].set(1.0)
    T = T.at[:3, 3].set(-s * c)
    return T


def params_to_pose(p, s, c):
    """Twist increment -> 4x4 pose: T_n^{-1} exp(p) T_n
    (reference rigid_body_warp.h:132-138 ``scalePose``)."""
    Tn = normalization_matrix(s, c)
    Tn_inv = normalization_matrix(1.0 / s, -s * c)  # [ (1/s) I | c ]
    return Tn_inv @ se3.exp(p) @ Tn


def project(cam: CameraModel, T, points):
    """Warp + pinhole projection of (N, 3) points by pose T (4, 4) -> (u, v, Z')
    (reference rigid_body_warp.h:108-122: P = K [R t], x = P X)."""
    R = T[:3, :3]
    t = T[:3, 3]
    Xw = points @ R.T + t
    Z = Xw[:, 2]
    zi = 1.0 / Z
    u = cam.fx * Xw[:, 0] * zi + cam.cx
    v = cam.fy * Xw[:, 1] * zi + cam.cy
    return u, v, Z


def jacobian(cam: CameraModel, points, gx, gy, s, c):
    """Batched analytic 1x6 photometric Jacobian at identity pose.

    ``points`` (N, 3); ``gx``/``gy`` image gradients of a descriptor channel at
    the template pixels, shape (..., N) (a leading channel axis broadcasts).
    Returns (..., N, 6) in twist order (w1 w2 w3 v1 v2 v3).

    Equivalent to the reference's hand-derived expression at
    rigid_body_warp.h:94-106 given gx' = gx*fx, gy' = gy*fy.
    """
    X, Y, Z = points[:, 0], points[:, 1], points[:, 2]
    zi = 1.0 / Z
    zi2 = zi * zi
    a = gx * cam.fx   # (..., N)
    b = gy * cam.fy
    # q = (a X + b Y)/Z^2 appears in both rotation and z-translation terms
    q = (a * X + b * Y) * zi2
    Xc, Yc, Zc = X - c[0], Y - c[1], Z - c[2]
    j_w1 = -q * Yc - b * Zc * zi
    j_w2 = q * Xc + a * Zc * zi
    j_w3 = (b * Xc - a * Yc) * zi
    inv_s = 1.0 / s
    j_v1 = a * zi * inv_s
    j_v2 = b * zi * inv_s
    j_v3 = -q * inv_s
    return jnp.stack([j_w1, j_w2, j_w3, j_v1, j_v2, j_v3], axis=-1)


# ---------------------------------------------------------------------------
# Disparity-space warp (reference bpvo/disparity_space_warp.{h,cc})
# ---------------------------------------------------------------------------

def disparity_space_G(cam: CameraModel):
    """The disparity-space <-> homogeneous-3D mapping G
    (disparity_space_warp.cc:36-46): a centered point q = (x-cx, y-cy, d, 1)
    maps to the homogeneous 3D point G^{-1} q, and rigid poses conjugate as
    H = G T G^{-1} so the warp acts directly on disparity-space coordinates."""
    fx, fy, b = cam.fx, cam.fy, cam.baseline
    z = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    return jnp.stack([
        jnp.stack([fx, z, z, z]),
        jnp.stack([z, fy, z, z]),
        jnp.stack([z, z, z, fx * b]),
        jnp.stack([z, z, one, z]),
    ])


def disparity_space_G_inv(cam: CameraModel):
    fx, fy, b = cam.fx, cam.fy, cam.baseline
    z = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    return jnp.stack([
        jnp.stack([1.0 / fx, z, z, z]),
        jnp.stack([z, 1.0 / fy, z, z]),
        jnp.stack([z, z, z, one]),
        jnp.stack([z, z, 1.0 / (fx * b), z]),
    ])


def disparity_space_make_points(cam: CameraModel, x, y, d):
    """Template 'points' for the disparity-space warp: centered pixel + disparity
    (reference disparity_space_warp.h makePoint: (x-cx, y-cy, d))."""
    return jnp.stack([x - cam.cx, y - cam.cy, d], axis=-1)


def disparity_space_project(cam: CameraModel, T, points):
    """Warp disparity-space points (N, 3) = (x-cx, y-cy, d) by RIGID pose T and
    project: pw = (G T G^{-1}) (p, 1); (u, v) = pw[:2]/pw[3] + (cx, cy)
    (disparity_space_warp.h setPose/operator()).  Returns (u, v, w) where
    w = pw[3] > 0 iff the 3D point is in front of the camera (pw[3] is the
    warped depth scaled by the point's positive homogeneous factor d/(fx b))."""
    H = disparity_space_G(cam) @ jnp.asarray(T, jnp.float32) \
        @ disparity_space_G_inv(cam)
    q = jnp.concatenate([points, jnp.ones_like(points[:, :1])], axis=-1)
    pw = q @ H.T
    wi = 1.0 / pw[:, 3]
    u = pw[:, 0] * wi + cam.cx
    v = pw[:, 1] * wi + cam.cy
    return u, v, pw[:, 3]


def disparity_space_jacobian(cam: CameraModel, points, gx, gy):
    """Batched 1x6 photometric Jacobian of the disparity-space warp at identity,
    twist order (w1 w2 w3 v1 v2 v3).  Independently derived (chain rule through
    pw = G exp(p) G^{-1} q, see disparity_space_warp.h:43-64 for the reference's
    MATLAB-generated equivalent); verified against jax autodiff in tests.

    ``points`` (N, 3) disparity-space; ``gx``/``gy`` (..., N) image gradients.
    """
    x, y, d = points[:, 0], points[:, 1], points[:, 2]
    fx, fy = cam.fx, cam.fy
    k = d / (fx * cam.baseline)
    t4 = gx * x + gy * y
    j_w1 = -gy * fy - t4 * y / fy
    j_w2 = gx * fx + t4 * x / fx
    j_w3 = gy * fy * x / fx - gx * fx * y / fy
    j_v1 = gx * fx * k
    j_v2 = gy * fy * k
    j_v3 = -t4 * k
    return jnp.stack([j_w1, j_w2, j_w3, j_v1, j_v2, j_v3], axis=-1)


def disparity_space_warp_points(cam: CameraModel, T, xyd):
    """Warp (x, y, d) disparity-space points by rigid pose T and return the new
    (x', y', d').  Mathematically identical to back-project -> T -> project, but
    parameterized in disparity space which conditions better for distant points
    (the reference's WITH_DISPARITY_SPACE_WARP compile option)."""
    x, y, d = xyd[:, 0], xyd[:, 1], xyd[:, 2]
    pts = make_points(cam, x, y, d)
    u, v, Z = project(cam, T, pts)
    d_new = cam.fx * cam.baseline / Z
    return jnp.stack([u, v, d_new], axis=-1)
