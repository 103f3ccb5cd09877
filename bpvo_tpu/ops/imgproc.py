"""Image-processing kernels: gradients, saliency, NMS, Gaussian smoothing, pyrDown.

Counterpart of the reference's ``bpvo/imgproc.{h,cc}`` (saliency
``gradientAbsoluteMagnitude`` at imgproc.cc:33-142, ``IsLocalMax`` 3x3 NMS at
imgproc.h:93-165, Eigen ``xgradient/ygradient`` at imgproc.h:216-265, ``imsmooth``
at imgproc.cc:166-178) and of ``cv::pyrDown`` used by ``bpvo/image_pyramid.cc:43-50``.

All functions are pure jnp on float32 arrays shaped ``(..., H, W)``; channel and
batch dimensions broadcast, so the reference's per-channel ``parallel_for`` loops
become one fused XLA op over the leading axes.  Convolution-style ops run
via XLA ``conv_general_dilated``; the 2D stencils here are tiny so XLA fuses them
into neighboring elementwise work.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def xgradient(I, scale=0.5):
    """Horizontal central-difference gradient, one-sided at the borders.

    Matches reference imgproc.h:216-240 (float scale = 0.5, imgproc.h:206-210).
    """
    left = jnp.concatenate([I[..., :, :1], I[..., :, :-1]], axis=-1)
    right = jnp.concatenate([I[..., :, 1:], I[..., :, -1:]], axis=-1)
    g = scale * (right - left)
    # borders use a one-sided difference, still multiplied by scale
    # (reference imgproc.h:231-239)
    g = g.at[..., :, 0].set(scale * (I[..., :, 1] - I[..., :, 0]))
    g = g.at[..., :, -1].set(scale * (I[..., :, -1] - I[..., :, -2]))
    return g


def ygradient(I, scale=0.5):
    """Vertical central-difference gradient, one-sided at the borders
    (reference imgproc.h:242-265)."""
    up = jnp.concatenate([I[..., :1, :], I[..., :-1, :]], axis=-2)
    down = jnp.concatenate([I[..., 1:, :], I[..., -1:, :]], axis=-2)
    g = scale * (down - up)
    g = g.at[..., 0, :].set(scale * (I[..., 1, :] - I[..., 0, :]))
    g = g.at[..., -1, :].set(scale * (I[..., -1, :] - I[..., -2, :]))
    return g


def gradient_absolute_magnitude(I):
    """Saliency kernel: |I(x+1,y) - I(x-1,y)| + |I(x,y+1) - I(x,y-1)|.

    Matches the reference's SSE ``gradientAbsoluteMagnitude`` (imgproc.cc:33-142):
    no 0.5 factor, and the one-pixel image border is zeroed.
    """
    Ix = jnp.abs(I[..., 1:-1, 2:] - I[..., 1:-1, :-2])
    Iy = jnp.abs(I[..., 2:, 1:-1] - I[..., :-2, 1:-1])
    mag = Ix + Iy
    return jnp.pad(mag, [(0, 0)] * (I.ndim - 2) + [(1, 1), (1, 1)])


def gradient_absolute_magnitude_acc(channels):
    """Accumulated saliency over descriptor channels: sum_c |grad c|
    (reference dense_descriptor.cc:92-100 using gradientAbsoluteMagnitudeAcc)."""
    return jnp.sum(gradient_absolute_magnitude(channels), axis=-3)


# ---------------------------------------------------------------------------
# local maxima (non-maxima suppression)
# ---------------------------------------------------------------------------

def is_local_max(S, radius: int = 1):
    """Strict local-maximum mask within ``radius`` (reference imgproc.h:93-165).

    ``S[y,x]`` is a local max iff it is strictly greater than every neighbor in
    the (2r+1)^2 window.  radius <= 0 returns all-True (NMS disabled), matching
    the reference's behavior when the image is too small.
    """
    if radius <= 0:
        return jnp.ones_like(S, dtype=bool)
    # max-pool excluding center: shift-compare in each direction.
    neg_inf = jnp.asarray(-jnp.inf, S.dtype)
    result = jnp.ones(S.shape, dtype=bool)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = jnp.roll(S, (-dy, -dx), axis=(-2, -1))
            # out-of-bounds neighbors compare as -inf (cannot beat the center)
            if dy > 0:
                shifted = shifted.at[..., -dy:, :].set(neg_inf)
            elif dy < 0:
                shifted = shifted.at[..., :-dy, :].set(neg_inf)
            if dx > 0:
                shifted = shifted.at[..., :, -dx:].set(neg_inf)
            elif dx < 0:
                shifted = shifted.at[..., :, :-dx].set(neg_inf)
            result = result & (S > shifted)
    return result


# ---------------------------------------------------------------------------
# separable Gaussian smoothing
# ---------------------------------------------------------------------------

def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV-compatible 1D Gaussian kernel (cv2.getGaussianKernel semantics)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_pad(I, ry: int, rx: int):
    """reflect-101 border padding (cv2 default BORDER_REFLECT_101)."""
    pad = [(0, 0)] * (I.ndim - 2) + [(ry, ry), (rx, rx)]
    return jnp.pad(I, pad, mode="reflect")


def _sep_conv2d(I, ky: np.ndarray, kx: np.ndarray):
    """Separable 2D correlation with reflect-101 borders on (..., H, W).

    Implemented as shifted slice-and-accumulate rather than
    ``conv_general_dilated``: a single-channel stencil has no channel
    contraction for a matrix unit, and the slice form fuses into one
    elementwise pass per axis.
    """
    ry, rx = len(ky) // 2, len(kx) // 2
    Ip = _reflect_pad(I, ry, rx)
    H, W = I.shape[-2], I.shape[-1]
    rows = sum(jnp.asarray(ky[i], Ip.dtype) * Ip[..., i:i + H, :]
               for i in range(len(ky)))
    out = sum(jnp.asarray(kx[j], Ip.dtype) * rows[..., :, j:j + W]
              for j in range(len(kx)))
    return out


def imsmooth(I, sigma: float, ksize: int = 0):
    """Gaussian smoothing (reference imgproc.cc:166-178: cv::GaussianBlur).

    ``ksize=0`` derives the aperture from sigma like OpenCV:
    ksize = 2*ceil(3*sigma)|1 (odd), min 3.
    """
    if sigma <= 0:
        return I
    if ksize <= 0:
        ksize = max(3, int(2 * np.ceil(3.0 * sigma) + 1))
    if ksize % 2 == 0:
        ksize += 1
    k = gaussian_kernel_1d(ksize, sigma)
    return _sep_conv2d(I, k, k)


# ---------------------------------------------------------------------------
# pyramid downsampling
# ---------------------------------------------------------------------------

_PYR_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=None)
def _filter_decimate_matrix(n: int, stride: int, kernel: tuple) -> np.ndarray:
    """Banded (ceil(n/stride), n) matrix: filter (reflect-101 borders) fused
    with stride-``stride`` decimation.  Applying it per axis as a matmul runs
    the whole pyramid stage as two small dense products instead of a
    filter pass followed by a strided ``I[::2, ::2]`` slice."""
    m = -(-n // stride)
    M = np.zeros((m, n), np.float32)
    k = np.asarray(kernel, np.float64)
    r = len(k) // 2
    for i in range(m):
        c = stride * i
        for j, kv in enumerate(k):
            idx = c + j - r
            if idx < 0:
                idx = -idx                    # reflect-101
            if idx >= n:
                idx = 2 * (n - 1) - idx
            M[i, idx] += kv
    return M


def _matmul_decimate(I, stride: int, kernel: tuple):
    H, W = I.shape[-2], I.shape[-1]
    My = jnp.asarray(_filter_decimate_matrix(H, stride, kernel))
    Mx = jnp.asarray(_filter_decimate_matrix(W, stride, kernel))
    # (m_h, H) @ (..., H, W) @ (W, m_w)
    out = jnp.einsum("rh,...hw->...rw", My, I,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("...rw,cw->...rc", out, Mx,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=())
def pyr_down(I):
    """Gaussian 5-tap blur + 2x decimation, matching ``cv::pyrDown`` semantics
    (used by reference image_pyramid.cc:43-50). Output size = ceil(dim/2)."""
    return _matmul_decimate(I, 2, tuple(_PYR_KERNEL.tolist()))


def disparity_at_level(D, level: int):
    """Strided full-resolution disparity lookup for pyramid level ``level``
    (reference ``DisparityPyramidLevel``, imgproc.h:69-89): the disparity value
    at level-l pixel (x, y) is D[y << l, x << l], in full-res pixel units."""
    s = 1 << level
    if s == 1:
        return D
    return _matmul_decimate(D, s, (1.0,))
