"""Keyframe template store: selected points, per-channel pixel values, and
precomputed analytic Jacobians, with photometric residual evaluation.

Counterpart of the reference's central data structure ``bpvo/template_data.{h,cc}``
(``setData`` pipeline at template_data.cc:37-146: saliency -> NMS selection ->
disparity gate -> back-projection -> Hartley normalization -> per-channel pixels
+ CD3/CD5 gradients -> batch Jacobians; ``computeResiduals`` at :174-189) and of
``bpvo/photo_error.{h,cc}`` (projection + interpolation + subtraction,
photo_error.cc:336-459).

Redesign: fixed capacity K per level with a valid mask instead of variable-N
vectors (XLA static shapes); the per-channel ``parallel_for`` loops become a
channel axis; the entire residual evaluation is one fused jitted function.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.ops import descriptors, interp, selection
from bpvo_tpu.types import GradientEstimationType, InterpolationType
from bpvo_tpu.vo import warp as warp_mod


class TemplateData(NamedTuple):
    """Immutable pytree holding one pyramid level's keyframe template."""
    points: jnp.ndarray      # (K, 3) back-projected 3D points (padding: zeros)
    pixels: jnp.ndarray      # (C, K) descriptor values at selected pixels
    jacobians: jnp.ndarray   # (C, K, 6) analytic Jacobians at identity
    valid: jnp.ndarray       # (K,) selection mask
    num_valid: jnp.ndarray   # () int32
    norm_scale: jnp.ndarray  # () Hartley normalization scale s
    norm_center: jnp.ndarray  # (3,) Hartley normalization center c
    rows: jnp.ndarray        # (K,) int32 pixel y (for point-cloud colorization)
    cols: jnp.ndarray        # (K,) int32 pixel x

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def num_channels(self) -> int:
        return self.pixels.shape[0]


def _gather_at(channels, rows, cols, dy=0, dx=0):
    """channels (C, H, W) -> (C, K) values at (rows+dy, cols+dx), clamped."""
    C, H, W = channels.shape
    y = jnp.clip(rows + dy, 0, H - 1)
    x = jnp.clip(cols + dx, 0, W - 1)
    return channels.reshape(C, H * W)[:, y * W + x]


def _channel_gradients(channels, rows, cols, method: GradientEstimationType):
    """Per-channel image gradients at the selected pixels
    (reference template_data.cc:112-131: CD3 = 0.5*(I[x+1]-I[x-1]),
    CD5 = (I[x-2] - 8 I[x-1] + 8 I[x+1] - I[x+2]) / 18)."""
    if method == GradientEstimationType.CD3:
        gx = 0.5 * (_gather_at(channels, rows, cols, 0, 1)
                    - _gather_at(channels, rows, cols, 0, -1))
        gy = 0.5 * (_gather_at(channels, rows, cols, 1, 0)
                    - _gather_at(channels, rows, cols, -1, 0))
    elif method == GradientEstimationType.CD5:
        nn = 1.0 / 18.0
        gx = nn * (_gather_at(channels, rows, cols, 0, -2)
                   - 8.0 * _gather_at(channels, rows, cols, 0, -1)
                   + 8.0 * _gather_at(channels, rows, cols, 0, 1)
                   - _gather_at(channels, rows, cols, 0, 2))
        gy = nn * (_gather_at(channels, rows, cols, -2, 0)
                   - 8.0 * _gather_at(channels, rows, cols, -1, 0)
                   + 8.0 * _gather_at(channels, rows, cols, 1, 0)
                   - _gather_at(channels, rows, cols, 2, 0))
    else:
        raise ValueError(f"unknown gradient estimation {method}")
    return gx, gy


def select_and_backproject(channels, disparity, cam: warp_mod.CameraModel,
                           p: AlgorithmParameters, capacity: int):
    """Stage 1 of template construction: pixel selection + 3D back-projection
    + Hartley normalization (reference template_data.cc:39-92).

    Cheap relative to stage 2 (O(K) math vs O(C*K) gathers + Jacobians); the
    distributed path runs it replicated on every device and shards only
    stage 2 (bpvo_tpu/parallel/sharded_vo.py), which preserves exact
    single-device selection semantics.

    Returns (sel, points (K,3), norm_scale, norm_center).
    """
    C, H, W = channels.shape
    sal = descriptors.saliency(channels)
    use_nms = H * W >= p.minNumPixelsForNonMaximaSuppression
    border = max(p.nonMaxSuppRadius, 3)
    sel = selection.select_pixels(
        sal, disparity, capacity,
        min_saliency=p.minSaliency, nms_radius=p.nonMaxSuppRadius,
        use_nms=use_nms, min_disparity=p.minValidDisparity,
        max_disparity=p.maxValidDisparity, border=border)

    d_safe = jnp.where(sel.valid, sel.disparity, 1.0)
    xf = sel.cols.astype(jnp.float32)
    yf = sel.rows.astype(jnp.float32)

    if p.warpType == "DisparitySpace":
        # disparity-space parameterization: points = (x-cx, y-cy, d), no
        # Hartley normalization (reference disparity_space_warp.h:86-89)
        points = warp_mod.disparity_space_make_points(cam, xf, yf, d_safe)
        s, c = warp_mod.identity_normalization(points.dtype)
    else:
        points = warp_mod.make_points(cam, xf, yf, d_safe)
        # padding slots get a finite dummy point at (0, 0, 1): Z must stay
        # nonzero or 1/Z pollutes the Jacobians with inf/NaN that masking
        # cannot remove
        dummy = jnp.array([0.0, 0.0, 1.0], points.dtype)
        points = jnp.where(sel.valid[:, None], points, dummy)
        if p.withNormalization:
            s, c = warp_mod.hartley_normalization(points, sel.valid)
        else:
            s, c = warp_mod.identity_normalization(points.dtype)
    return sel, points, s, c


def build_from_selection(channels, cam: warp_mod.CameraModel,
                         p: AlgorithmParameters, rows, cols, vmask, num_valid,
                         points, s, c) -> TemplateData:
    """Stage 2 of template construction: per-point descriptor gathers, CD3/CD5
    gradients, and analytic Jacobians (reference template_data.cc:102-141).
    All inputs along the point axis may be a shard of the full selection."""
    pixels = _gather_at(channels, rows, cols)
    gx, gy = _channel_gradients(channels, rows, cols, p.gradientEstimation)
    if p.warpType == "DisparitySpace":
        J = warp_mod.disparity_space_jacobian(cam, points, gx, gy)
    else:
        J = warp_mod.jacobian(cam, points, gx, gy, s, c)  # (C, K, 6)
    pixels = jnp.where(vmask[None, :], pixels, 0.0)
    J = jnp.where(vmask[None, :, None], J, 0.0)
    return TemplateData(points=points, pixels=pixels, jacobians=J,
                        valid=vmask, num_valid=num_valid,
                        norm_scale=s, norm_center=c, rows=rows, cols=cols)


def set_data(channels, disparity, cam: warp_mod.CameraModel,
             p: AlgorithmParameters, capacity: int, level: int) -> TemplateData:
    """Build a template from descriptor channels (C, H, W) and the *level-strided*
    disparity map (H, W) (full-resolution disparity values; see
    ``imgproc.disparity_at_level``). jit-compile with static (p, capacity, level).
    """
    sel, points, s, c = select_and_backproject(channels, disparity, cam, p,
                                               capacity)
    return build_from_selection(channels, cam, p, sel.rows, sel.cols,
                                sel.valid, sel.num_valid, points, s, c)


def compute_residuals(tdata: TemplateData, channels, cam: warp_mod.CameraModel,
                      T, method: InterpolationType, packed=None,
                      warp: str = "RigidBody"):
    """Photometric residuals r = I1(warp(x)) - I0(x) for all channels.

    Counterpart of ``TemplateData::computeResiduals`` + ``PhotoError::init/run``
    (template_data.cc:174-189, photo_error.cc:336-459), fused into one call:
    project all K points by T, mask out-of-view points, sample every channel at
    the warped location, subtract template pixels.

    ``packed`` (an ``interp.PackedTaps`` built from the same channels) switches
    to the one-gather sampling path — callers that evaluate many poses against
    fixed channels (the GN loop) build it once outside the loop.

    Returns (r (C, K), valid (K,)) with invalid entries zeroed.
    """
    if packed is not None:
        H, W = packed.H, packed.W
    else:
        _, H, W = channels.shape
    if warp == "DisparitySpace":
        u, v, Z = warp_mod.disparity_space_project(cam, T, tdata.points)
    else:
        u, v, Z = warp_mod.project(cam, T, tdata.points)
    ok = tdata.valid & (Z > 1e-6) & interp.valid_mask(u, v, H, W, method)
    if packed is not None:
        I1 = interp.sample_packed(packed, u, v, ok, method)
    else:
        I1 = interp.sample(channels, u, v, ok, method)
    r = (I1 - tdata.pixels) * ok[None, :]
    return r, ok
