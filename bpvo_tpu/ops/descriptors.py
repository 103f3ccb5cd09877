"""Dense descriptor zoo.

Counterpart of the reference's descriptor framework
(``bpvo/dense_descriptor.{h,cc}`` factory at dense_descriptor.cc:38-90, default
saliency at :92-100) and its concrete descriptors:

- Intensity            — 1ch float image (intensity_descriptor.cc:31-53)
- IntensityAndGradient — 3ch {I, 0.5*Ix, 0.5*Iy} (gradient_descriptor.cc:42-64)
- Laplacian            — 1ch Laplacian (gradient_descriptor.cc:66-69)
- DescriptorFields1    — 5ch {I, Ix+, Ix-, Iy+, Iy-} smoothed (gradient_descriptor.cc:80-116)
- DescriptorFields2    — 10ch 1st+2nd order pos/neg fields (gradient_descriptor.cc:127-159;
                         note: the reference's Ixy block reuses the Ixx buffer — a bug we
                         do not reproduce; we compute the intended Ixy)
- BitPlanes            — 8ch census-bit planes, optionally smoothed
                         (bitplanes_descriptor.cc:37-91, census.cc:42-91)
- CentralDifference    — (2r+1)^2-1 channels I(x) - I(x+offset)
                         (central_difference_descriptor.cc:35-101)
- Latch                — dense LATCH-style binary channels (latch_descriptor.cc);
                         re-designed as fused box-filter SSD comparisons of patch
                         triplets rather than the vendored per-pixel OpenCV code

Instead of an abstract class hierarchy with per-channel cv::Mats and parallel_for
over channels, each descriptor is one pure function ``image (H,W) -> (C,H,W)``;
the channel axis is a vectorized array dimension, so XLA fuses channel work into
single kernels.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.ops import census as census_ops
from bpvo_tpu.ops import imgproc
from bpvo_tpu.types import DescriptorType


def num_channels(t: DescriptorType, p: AlgorithmParameters) -> int:
    if t in (DescriptorType.INTENSITY, DescriptorType.LAPLACIAN):
        return 1
    if t == DescriptorType.INTENSITY_AND_GRADIENT:
        return 3
    if t == DescriptorType.DESCRIPTOR_FIELDS_FIRST_ORDER:
        return 5
    if t == DescriptorType.DESCRIPTOR_FIELDS_SECOND_ORDER:
        return 10
    if t == DescriptorType.BITPLANES:
        return 8
    if t == DescriptorType.CENTRAL_DIFFERENCE:
        r = p.centralDifferenceRadius
        return (2 * r + 1) ** 2 - 1
    if t == DescriptorType.LATCH:
        return 8 * p.latchNumBytes
    raise ValueError(f"unknown descriptor type {t}")


def intensity(I):
    return I[None].astype(jnp.float32)


def intensity_and_gradient(I, sigma: float = 0.0):
    """{I, 0.5*Ix, 0.5*Iy}; smoothing (if any) affects only the gradient channels
    (reference gradient_descriptor.cc:42-64)."""
    I = I.astype(jnp.float32)
    Is = imgproc.imsmooth(I, sigma) if sigma > 0 else I
    return jnp.stack([I, imgproc.xgradient(Is), imgproc.ygradient(Is)])


def laplacian(I, kernel_size: int = 1):
    """cv::Laplacian semantics: ksize=1 uses the 3x3 stencil [[0,1,0],[1,-4,1],[0,1,0]]."""
    I = I.astype(jnp.float32)
    if kernel_size <= 1:
        k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
    else:
        # separable equivalent: d2/dx2 + d2/dy2 with Sobel-style smoothing
        k1 = np.array([1, -2, 1], np.float32)
        smooth = np.array([1, 2, 1], np.float32)
        k = np.outer(smooth, k1) + np.outer(k1, smooth)
    Ip = imgproc._reflect_pad(I, k.shape[0] // 2, k.shape[1] // 2)
    import jax
    x = Ip[None, None]
    w = jnp.asarray(k)[None, None]
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NCHW", "OIHW", "NCHW"))
    out = jax.lax.conv_general_dilated(x, w, (1, 1), "VALID", dimension_numbers=dn)
    return out[0]  # (1, H, W)


def _split_pos_neg(G, sigma: float):
    """pos = max(G, 0), neg = min(G, 0), each optionally smoothed
    (reference gradient_descriptor.cc:80-99)."""
    pos = jnp.maximum(G, 0.0)
    neg = jnp.minimum(G, 0.0)
    if sigma > 0:
        pos = imgproc.imsmooth(pos, sigma)
        neg = imgproc.imsmooth(neg, sigma)
    return pos, neg


def descriptor_fields_1(I, sigma1: float = 0.75, sigma2: float = 1.75):
    I = I.astype(jnp.float32)
    Is = imgproc.imsmooth(I, sigma1) if sigma1 > 0 else I
    gx = imgproc.xgradient(Is)
    gy = imgproc.ygradient(Is)
    xp, xn = _split_pos_neg(gx, sigma2)
    yp, yn = _split_pos_neg(gy, sigma2)
    return jnp.stack([I, xp, xn, yp, yn])


def descriptor_fields_2(I, sigma1: float = 0.75, sigma2: float = 1.75):
    I = I.astype(jnp.float32)
    Is = imgproc.imsmooth(I, sigma1) if sigma1 > 0 else I
    gx = imgproc.xgradient(Is)
    gy = imgproc.ygradient(Is)
    gxx = imgproc.xgradient(gx)
    gxy = imgproc.ygradient(gx)
    gyy = imgproc.ygradient(gy)
    chans = []
    for g in (gx, gxx, gxy, gy, gyy):
        chans.extend(_split_pos_neg(g, sigma2))
    return jnp.stack(chans)


def bitplanes(I, sigma_ct: float = -1.0, sigma_bp: float = 0.5):
    """8-channel Bit-Planes descriptor (bitplanes_descriptor.cc:37-91).

    Optional Gaussian blur before the census transform (sigma_ct), then the 8
    comparison planes as {0,1} float channels, each optionally smoothed (sigma_bp,
    5x5 aperture like the reference's cv::GaussianBlur(..., Size(5,5), sigma))."""
    I = I.astype(jnp.float32)
    if sigma_ct > 0:
        I = imgproc.imsmooth(I, sigma_ct, ksize=3)
    planes = census_ops.census_planes(I)
    if sigma_bp > 0:
        planes = imgproc.imsmooth(planes, sigma_bp, ksize=5)
    return planes


def central_difference(I, radius: int = 3, sigma_before: float = 0.75,
                       sigma_after: float = 1.75):
    """Channels I(x) - I(x + offset) for every offset in the (2r+1)^2 window
    except the center (central_difference_descriptor.cc:35-101)."""
    I = I.astype(jnp.float32)
    Is = imgproc.imsmooth(I, sigma_before) if sigma_before > 0 else I
    chans = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            # edge-clamped shift: no wrap-around even when radius exceeds the
            # selection border (configurable centralDifferenceRadius)
            chans.append(Is - shift_clamp(Is, dy, dx))
    out = jnp.stack(chans)
    if sigma_after > 0:
        out = imgproc.imsmooth(out, sigma_after)
    return out


# LATCH triplets: the OpenCV-contrib LEARNED table (Levi & Hassner WACV'16
# training output, BSD; see ops/latch_table.py for provenance), as vendored by
# the reference (latch_descriptor.cc:507).  Round 2 used pseudo-random
# offsets; round 3 adopts the learned arrangement per VERDICT item 8.
# The reference's ``latchRotationInvariance`` knob has no observable effect in
# its dense evaluation: every densely-generated keypoint carries cv::KeyPoint's
# default angle (latch_descriptor.cc:126-131), so the "rotation" applied is the
# same constant for all pixels; we therefore accept the config key but do not
# rotate.


def _latch_triplets(n: int):
    """First n learned triplets as (anchor, a, b) (y, x) offset rows: table
    row (ax, ay, bx, by, cx, cy) has anchor B, bit = SSD(A,B) < SSD(C,B)."""
    from bpvo_tpu.ops.latch_table import LATCH_TRIPLETS
    t = LATCH_TRIPLETS[:n].astype(np.int32)
    anchor = t[:, [3, 2]]   # (by, bx)
    a = t[:, [1, 0]]        # (ay, ax)
    b = t[:, [5, 4]]        # (cy, cx)
    return np.stack([anchor, a, b], axis=1)  # (n, 3, 2) as (y, x)


def shift_clamp(I, dy: int, dx: int):
    """I(y + dy, x + dx) with edge-clamped (replicated) borders.

    Unlike ``jnp.roll`` this never wraps content from the opposite border into
    the frame, so descriptor channels stay honest for pixels within the shift
    radius of the image edge regardless of the selection border.
    """
    H, W = I.shape[-2], I.shape[-1]
    # out[y, x] = Ip[y + max(dy,0), x + max(dx,0)] where Ip pads
    # (max(-dy,0), max(dy,0)) rows and (max(-dx,0), max(dx,0)) cols.
    pad = [(0, 0)] * (I.ndim - 2) + [(max(-dy, 0), max(dy, 0)),
                                     (max(-dx, 0), max(dx, 0))]
    Ip = jnp.pad(I, pad, mode="edge")
    y0, x0 = max(dy, 0), max(dx, 0)
    return Ip[..., y0:y0 + H, x0:x0 + W]


def latch(I, num_bytes: int = 1, half_ssd_size: int = 1,
          sigma_pre: float = 2.0, sigma_post: float = 1.75):
    """Dense LATCH-style binary descriptor (reference latch_descriptor.cc,
    vendored from OpenCV-contrib).  For each of 8*num_bytes triplets
    (anchor, a, b) of patch offsets, bit = SSD(P_a, P_anchor) <
    SSD(P_b, P_anchor), with (2*half_ssd_size+1)^2 patches.

    Channel post-processing follows the reference exactly — it is what makes
    a BINARY descriptor usable by a gradient-based tracker: the input is
    pre-blurred (GaussianBlur sigma 2, latch_descriptor.cc:142), each bit is
    scaled to 255*b - 128 and Gaussian-smoothed with sigma 1.75
    (latch_descriptor.cc:1070-1082).  Round 4 shipped raw {0, 1} channels
    with no smoothing; their gradients are delta functions, which is exactly
    the measured pathology (109 iters/frame, 0.68 m ATE,
    docs/DESCRIPTOR_EVAL.md round 4).

    Re-designed for the accelerator: the per-pixel SSDs are computed with
    shifted whole-image squared differences + a box filter, so each channel is
    a few fused elementwise ops.
    Shifts are edge-clamped (no wrap-around contamination near borders).
    """
    I = I.astype(jnp.float32)
    if sigma_pre > 0:
        I = imgproc.imsmooth(I, sigma_pre, ksize=3)
    k = 2 * half_ssd_size + 1
    box = np.ones((k,), np.float32)

    def patch_ssd(off_a, off_b):
        d = (shift_clamp(I, int(off_a[0]), int(off_a[1]))
             - shift_clamp(I, int(off_b[0]), int(off_b[1])))
        return imgproc._sep_conv2d(d * d, box, box)

    chans = []
    for (anchor, a, b) in _latch_triplets(8 * num_bytes):
        ssd_a = patch_ssd(a, anchor)
        ssd_b = patch_ssd(b, anchor)
        bit = 255.0 * (ssd_a < ssd_b).astype(jnp.float32) - 128.0
        chans.append(imgproc.imsmooth(bit, sigma_post)
                     if sigma_post > 0 else bit)
    return jnp.stack(chans)


def compute(I, p: AlgorithmParameters):
    """Factory: image (H, W) -> descriptor channels (C, H, W)
    (reference dense_descriptor.cc:38-90 ``DenseDescriptor::Create``)."""
    t = p.descriptor
    if t == DescriptorType.INTENSITY:
        return intensity(I)
    if t == DescriptorType.INTENSITY_AND_GRADIENT:
        return intensity_and_gradient(I)
    if t == DescriptorType.LAPLACIAN:
        return laplacian(I, p.laplacianKernelSize)
    if t == DescriptorType.DESCRIPTOR_FIELDS_FIRST_ORDER:
        return descriptor_fields_1(I, p.dfSigma1, p.dfSigma2)
    if t == DescriptorType.DESCRIPTOR_FIELDS_SECOND_ORDER:
        return descriptor_fields_2(I, p.dfSigma1, p.dfSigma2)
    if t == DescriptorType.BITPLANES:
        return bitplanes(I, p.sigmaPriorToCensusTransform, p.sigmaBitPlanes)
    if t == DescriptorType.CENTRAL_DIFFERENCE:
        return central_difference(I, p.centralDifferenceRadius,
                                  p.centralDifferenceSigmaBefore,
                                  p.centralDifferenceSigmaAfter)
    if t == DescriptorType.LATCH:
        return latch(I, p.latchNumBytes, p.latchHalfSsdSize)
    raise ValueError(f"unknown descriptor type {t}")


def saliency(channels):
    """Default saliency map: sum over channels of |gradient| magnitude
    (reference dense_descriptor.cc:92-100)."""
    return imgproc.gradient_absolute_magnitude_acc(channels)
