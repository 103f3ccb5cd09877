"""Sub-pixel sampling of descriptor channels at warped image points.

Counterpart of the reference's ``bpvo/photo_error.cc`` interpolation
engine (the active scalar implementation at photo_error.cc:336-459 supporting
Linear / Cosine / Cubic / CubicHermite, coefficient formulas at :267-334) and of
``bpvo/interp_util.h``'s ``BilinearInterp``.

The irregular access ``I1(warp(x_i))`` is the one genuinely scattered read in the
whole pipeline.  Here it is expressed as flat ``jnp.take`` gathers over the
row-major image (4 gathers for linear/cosine, 16 for the cubic family), which XLA
lowers to device gather ops and fuses with the interpolation arithmetic.

Out-of-bounds points are clamped before the gather and zeroed by the valid mask,
reproducing the reference's ``valid`` semantics (photo_error.cc:344-363) — except
that our cubic border bound is actually correct where the reference reads one row
out of bounds (its ``yi < rows-1`` check with a ``yi+2`` access).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpvo_tpu.types import InterpolationType

# gather strategy for the warped sampling: "window" = one lax.gather of a
# 2x2/4x4 neighborhood per point; "flat" = 4/16 independent flat takes
# (row-major takes with one index per tap, which vectorize without strided
# window slices).  Override with BPVO_GATHER=window.
GATHER_MODE = os.environ.get("BPVO_GATHER", "flat")


def border_bounds(method: InterpolationType):
    """(lo, hi_x, hi_y): valid iff lo <= xi < W-hi_x and lo <= yi < H-hi_y
    (reference photo_error.cc:348-349 — with the cubic y-bound fixed)."""
    if method in (InterpolationType.LINEAR, InterpolationType.COSINE):
        return 0, 1, 1
    return 1, 3, 3


def valid_mask(u, v, rows: int, cols: int, method: InterpolationType):
    xi = jnp.floor(u)
    yi = jnp.floor(v)
    lo, hi_x, hi_y = border_bounds(method)
    return ((xi >= lo) & (xi < cols - hi_x) & (yi >= lo) & (yi < rows - hi_y))


def _coeffs_linear(f):
    return jnp.stack([1.0 - f, f])


def _coeffs_cosine(f):
    """(photo_error.cc:282-290)"""
    m = (1.0 - jnp.cos(f * jnp.pi)) * 0.5
    return jnp.stack([1.0 - m, m])


def _coeffs_cubic(f):
    """Catmull-Rom-style cubic with A=-0.5 (photo_error.cc:267-280)."""
    A = -0.5
    c0 = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    c2 = ((A + 2) * (1 - f) - (A + 3)) * (1 - f) * (1 - f) + 1
    c3 = 1.0 - c0 - c1 - c2
    return jnp.stack([c0, c1, c2, c3])


def _hermite_1d(y0, y1, y2, y3, mu):
    """Cubic Hermite through 4 samples, bias=0 tension=0 (photo_error.cc:292-334)."""
    mu2 = mu * mu
    mu3 = mu2 * mu
    m0 = 0.5 * (y1 - y0) + 0.5 * (y2 - y1)
    m1 = 0.5 * (y2 - y1) + 0.5 * (y3 - y2)
    a0 = 2 * mu3 - 3 * mu2 + 1.0
    a1 = mu3 - 2 * mu2 + mu
    a2 = mu3 - mu2
    a3 = -2 * mu3 + 3 * mu2
    return a0 * y1 + a1 * m0 + a2 * m1 + a3 * y2


def _gather(channels_flat, idx):
    """channels_flat (C, H*W), idx (N,) -> (C, N)."""
    return jnp.take(channels_flat, idx, axis=1)


def _gather_window(channels, yi, xi, size: int):
    """ONE gather of a (size x size) neighborhood per point.

    channels (C, H, W), yi/xi (N,) int32 top-left corners -> (N, C, size, size).
    A single windowed gather replaces the 4 (bilinear) / 16 (cubic) independent
    flat gathers, trading gather ops for a strided window read.
    """
    import jax
    starts = jnp.stack([yi, xi], axis=-1)  # (N, 2)
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2, 3), collapsed_slice_dims=(),
        start_index_map=(1, 2))
    C = channels.shape[0]
    return jax.lax.gather(channels, starts, dnums,
                          slice_sizes=(C, size, size), mode="clip")


def sample(channels, u, v, valid, method: InterpolationType = InterpolationType.LINEAR):
    """Sample ``channels`` (C, H, W) at sub-pixel points (u, v) each (N,).

    Returns (C, N) float32; entries where ``valid`` is False are 0.
    """
    C, H, W = channels.shape

    xi = jnp.floor(u).astype(jnp.int32)
    yi = jnp.floor(v).astype(jnp.int32)
    xf = (u - xi).astype(channels.dtype)
    yf = (v - yi).astype(channels.dtype)

    lo, hi_x, hi_y = border_bounds(method)
    xi = jnp.clip(xi, lo, W - 1 - hi_x)
    yi = jnp.clip(yi, lo, H - 1 - hi_y)

    if method in (InterpolationType.LINEAR, InterpolationType.COSINE):
        cx = _coeffs_linear(xf) if method == InterpolationType.LINEAR else _coeffs_cosine(xf)
        cy = _coeffs_linear(yf) if method == InterpolationType.LINEAR else _coeffs_cosine(yf)
        if GATHER_MODE == "flat":
            flat = channels.reshape(C, H * W)
            def at(dy, dx):
                return _gather(flat, (yi + dy) * W + (xi + dx))
            row0 = cx[0] * at(0, 0) + cx[1] * at(0, 1)
            row1 = cx[0] * at(1, 0) + cx[1] * at(1, 1)
            out = cy[0] * row0 + cy[1] * row1
        else:
            win = _gather_window(channels, yi, xi, 2)  # (N, C, 2, 2)
            # (N, C): rows combined by cy, columns by cx
            rows = win[..., 0, :] * cy[0][:, None, None] + \
                win[..., 1, :] * cy[1][:, None, None]
            out = (rows[..., 0] * cx[0][:, None]
                   + rows[..., 1] * cx[1][:, None]).T
    elif method == InterpolationType.CUBIC:
        cx = _coeffs_cubic(xf)  # (4, N)
        cy = _coeffs_cubic(yf)
        if GATHER_MODE == "flat":
            flat = channels.reshape(C, H * W)
            rows = []
            for j, dy in enumerate((-1, 0, 1, 2)):
                row = sum(cx[i] * _gather(flat, (yi + dy) * W + (xi + dx))
                          for i, dx in enumerate((-1, 0, 1, 2)))
                rows.append(cy[j] * row)
            out = rows[0] + rows[1] + rows[2] + rows[3]
        else:
            win = _gather_window(channels, yi - 1, xi - 1, 4)  # (N, C, 4, 4)
            cols = jnp.einsum("ncyx,xn->ncy", win, cx)
            out = jnp.einsum("ncy,yn->nc", cols, cy).T
    elif method == InterpolationType.CUBIC_HERMITE:
        if GATHER_MODE == "flat":
            flat = channels.reshape(C, H * W)
            vals = []
            for dy in (-1, 0, 1, 2):
                s = [_gather(flat, (yi + dy) * W + (xi + dx))
                     for dx in (-1, 0, 1, 2)]
                vals.append(_hermite_1d(s[0], s[1], s[2], s[3], xf))
            out = _hermite_1d(vals[0], vals[1], vals[2], vals[3], yf)
        else:
            win = _gather_window(channels, yi - 1, xi - 1, 4)  # (N, C, 4, 4)
            xfn = xf[:, None]
            vals = [_hermite_1d(win[..., j, 0], win[..., j, 1], win[..., j, 2],
                                win[..., j, 3], xfn) for j in range(4)]
            out = _hermite_1d(vals[0], vals[1], vals[2], vals[3],
                              yf[:, None]).T
    else:
        raise ValueError(f"unknown interpolation {method}")

    return jnp.where(valid[None, :], out, 0.0)


# ---------------------------------------------------------------------------
# packed-taps sampling: one gather per evaluation
# ---------------------------------------------------------------------------
#
# Inside the GN loop the channels are CONSTANT across iterations; only the
# sample coordinates change.  Pre-shifting the image once per level turns the
# per-iteration 4 (bilinear) / 16 (cubic) independent gathers into ONE
# ``jnp.take`` on a (H*W, T*C) array — each gathered row is one contiguous
# 4*T*C-byte read, and the cost scales with channel count for free (the whole
# (T*C) row costs one index).

def _tap_offsets(method: InterpolationType):
    if method in (InterpolationType.LINEAR, InterpolationType.COSINE):
        return [(dy, dx) for dy in (0, 1) for dx in (0, 1)]
    return [(dy, dx) for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)]


class PackedTaps(NamedTuple):
    """Channels pre-shifted to every tap offset: data[p, t*C+c] =
    channels[c].flat[p + dy_t*W + dx_t] (edge rows never read — the sample
    clamps keep every p + shift in range).

    With ``pair_packed`` the row holds T*C/2 f32 words, each the bitcast of
    two adjacent bf16 taps — halves the gathered row bytes while keeping an
    f32 gather layout.  Like C/H/W, the flag is consumed at trace time — close
    over a PackedTaps rather than passing it as a jit argument."""
    data: jnp.ndarray   # (H*W, T*C) — or (H*W, T*C/2) f32 when pair_packed
    C: int
    H: int
    W: int
    pair_packed: bool = False


def pack_taps(channels, method: InterpolationType, dtype=None) -> PackedTaps:
    """Build the loop-invariant packed-tap array for ``sample_packed``.

    ``dtype`` optionally stores the taps narrower than f32 (e.g. bfloat16 —
    halves the per-iteration gather bandwidth, the dominant cost for
    multi-channel descriptors); interpolation arithmetic still runs in f32
    after the gather, so the only precision loss is the value quantization.
    """
    C, H, W = channels.shape
    flat = channels.reshape(C, H * W)
    offs = _tap_offsets(method)
    shifted = jnp.stack([jnp.roll(flat, -(dy * W + dx), axis=1)
                         for dy, dx in offs], axis=0)     # (T, C, HW)
    data = shifted.reshape(len(offs) * C, H * W).T        # (HW, T*C)
    if dtype == "bf16pack":
        tc = data.shape[1]
        assert tc % 2 == 0, tc
        data = jax.lax.bitcast_convert_type(
            data.astype(jnp.bfloat16).reshape(H * W, tc // 2, 2),
            jnp.float32)                                  # (HW, T*C/2) f32
        return PackedTaps(data=data, C=C, H=H, W=W, pair_packed=True)
    if dtype is not None:
        data = data.astype(dtype)
    return PackedTaps(data=data, C=C, H=H, W=W)


def sample_packed(pt: PackedTaps, u, v, valid,
                  method: InterpolationType = InterpolationType.LINEAR):
    """Equivalent of ``sample`` reading from a ``PackedTaps`` (same clamping,
    coefficients, and valid semantics), with exactly one gather."""
    C, H, W = pt.C, pt.H, pt.W
    N = u.shape[0]
    T = len(_tap_offsets(method))

    f32 = jnp.float32
    xi = jnp.floor(u).astype(jnp.int32)
    yi = jnp.floor(v).astype(jnp.int32)
    xf = (u - xi).astype(f32)
    yf = (v - yi).astype(f32)
    lo, hi_x, hi_y = border_bounds(method)
    xi = jnp.clip(xi, lo, W - 1 - hi_x)
    yi = jnp.clip(yi, lo, H - 1 - hi_y)

    g = jnp.take(pt.data, yi * W + xi, axis=0)        # (N, T*C [/2 packed])
    if pt.pair_packed:
        g = jax.lax.bitcast_convert_type(g, jnp.bfloat16).reshape(N, T * C)
    # arithmetic in f32 regardless of the storage dtype (see pack_taps)
    g = g.T.reshape(T, C, N).astype(f32)              # row t*C+c -> (t, c)

    if method in (InterpolationType.LINEAR, InterpolationType.COSINE):
        cx = _coeffs_linear(xf) if method == InterpolationType.LINEAR \
            else _coeffs_cosine(xf)
        cy = _coeffs_linear(yf) if method == InterpolationType.LINEAR \
            else _coeffs_cosine(yf)
        row0 = cx[0] * g[0] + cx[1] * g[1]
        row1 = cx[0] * g[2] + cx[1] * g[3]
        out = cy[0] * row0 + cy[1] * row1
    elif method == InterpolationType.CUBIC:
        cx = _coeffs_cubic(xf)
        cy = _coeffs_cubic(yf)
        out = sum(cy[j] * sum(cx[i] * g[j * 4 + i] for i in range(4))
                  for j in range(4))
    elif method == InterpolationType.CUBIC_HERMITE:
        vals = [_hermite_1d(g[j * 4 + 0], g[j * 4 + 1], g[j * 4 + 2],
                            g[j * 4 + 3], xf) for j in range(4)]
        out = _hermite_1d(vals[0], vals[1], vals[2], vals[3], yf)
    else:
        raise ValueError(f"unknown interpolation {method}")

    return jnp.where(valid[None, :], out, 0.0)
