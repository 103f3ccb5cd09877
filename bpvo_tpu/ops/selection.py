"""Semi-dense pixel selection: saliency threshold + non-maxima suppression +
disparity gating, into a fixed-capacity top-K bucket.

Counterpart of the reference's selection scan in ``bpvo/template_data.cc:39-89``:
  - border exclusion: border = max(nonMaxSuppRadius, 3), pixels in
    [border, rows-border-1) x [border, cols-border-1)
  - saliency >= minSaliency and strict 3x3 local max (NMS enabled only when
    rows*cols >= minNumPixelsForNonMaximaSuppression)
  - disparity in [minValidDisparity, maxValidDisparity], sampled from the
    full-resolution disparity map with stride (1 << pyr_level)
  - the reference then truncates to a multiple of 16 for SSE; XLA needs static
    shapes, so we instead select the top-``capacity`` pixels by saliency and
    carry a valid mask (padding slots are masked out of every reduction).

When more than ``capacity`` pixels pass the gates we keep the most salient ones
(the reference keeps scan-order — top-K is at least as informative); when fewer
pass, the remainder are masked padding.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpvo_tpu.ops import imgproc


class Selection(NamedTuple):
    rows: jnp.ndarray   # (K,) int32 y coordinate per selected pixel
    cols: jnp.ndarray   # (K,) int32 x coordinate
    disparity: jnp.ndarray  # (K,) float32
    valid: jnp.ndarray  # (K,) bool — False for padding slots
    num_valid: jnp.ndarray  # () int32


def capacity_for_level(p, rows: int, cols: int, level: int) -> int:
    """Static per-level point capacity: level l gets capacity >> 2l (images shrink
    4x per level), floored at pointCapacityMin and at the pixel count."""
    cap = max(p.pointCapacity >> (2 * level), p.pointCapacityMin)
    # can't select more pixels than exist inside the border
    return int(min(cap, rows * cols))


def select_pixels(saliency, disparity, capacity: int, *,
                  min_saliency: float, nms_radius: int, use_nms: bool,
                  min_disparity: float, max_disparity: float,
                  border: int) -> Selection:
    """Select up to ``capacity`` pixels. All args after saliency/disparity are
    static Python values (jit-specialized)."""
    H, W = saliency.shape

    ok = saliency >= min_saliency
    if use_nms and nms_radius > 0:
        ok &= imgproc.is_local_max(saliency, nms_radius)
    ok &= (disparity >= min_disparity) & (disparity <= max_disparity)

    # border exclusion (template_data.cc:52-57: y,x in [border, dim - border - 1))
    bm = jnp.zeros((H, W), bool)
    if H - 2 * border - 1 > 0 and W - 2 * border - 1 > 0:
        bm = bm.at[border:H - border - 1, border:W - border - 1].set(True)
    ok &= bm

    score = jnp.where(ok, saliency, -jnp.inf).reshape(-1)
    vals, idx = jax.lax.top_k(score, capacity)
    valid = vals > -jnp.inf
    # re-sort the selected pixels into raster order: the per-iteration warped
    # gathers then hit the image nearly sequentially, which coalesces far
    # better than saliency order (the reference's scan-order selection had
    # this property for free, template_data.cc:55-66).  Invalid keys map to
    # INT_MAX, so the valid points occupy slots [0, num_valid).
    order = jnp.argsort(jnp.where(valid, idx, jnp.iinfo(jnp.int32).max))
    idx = idx[order]
    valid = valid[order]
    rows = (idx // W).astype(jnp.int32)
    cols = (idx % W).astype(jnp.int32)
    d = disparity.reshape(-1)[idx]
    return Selection(rows=rows, cols=cols, disparity=d, valid=valid,
                     num_valid=jnp.sum(valid).astype(jnp.int32))
