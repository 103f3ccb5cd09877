"""Census transform and bit-plane extraction.

Counterpart of the reference's ``bpvo/census.{h,cc}`` (3x3 census with
``neighbor >= center`` comparisons packed into one byte, census.cc:42-91) and the
bit-extraction half of ``bpvo/bitplanes_descriptor.cc:37-57``.

The reference processes 16 pixels per SSE instruction; here the whole image is one
vectorized compare-and-select per neighbor, fused by XLA into elementwise code — and the
"pack to u8 then unpack bits" round trip is *optional*: ``census_planes`` produces
the 8 comparison planes directly as float channels, which is what the Bit-Planes
descriptor actually consumes.  ``census`` (packed u8) is kept for parity/testing.

Bit order matches census.cc:46-57: bit b of the 8-neighborhood in row-major order
(dy,dx) = (-1,-1),(-1,0),(-1,+1),(0,-1),(0,+1),(+1,-1),(+1,0),(+1,+1).
"""
from __future__ import annotations

import jax.numpy as jnp

# (dy, dx) offsets for bits 0..7 (reference census.cc:46-57)
NEIGHBOR_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _shifted(I, dy: int, dx: int):
    """I(y+dy, x+dx) with zero border (border pixels are zeroed anyway)."""
    return jnp.roll(I, (-dy, -dx), axis=(-2, -1))


def census_planes(I):
    """8 comparison planes of the 3x3 census transform as float {0,1} channels.

    Input ``(..., H, W)`` float or uint8 image; output ``(..., 8, H, W)`` float32.
    The one-pixel border is zeroed, matching census.cc:70-89 where border rows and
    columns of the packed transform are memset to 0.
    """
    I = jnp.asarray(I)
    planes = []
    for (dy, dx) in NEIGHBOR_OFFSETS:
        planes.append((_shifted(I, dy, dx) >= I))
    out = jnp.stack(planes, axis=-3).astype(jnp.float32)
    # zero the 1px border
    mask = jnp.zeros(I.shape[-2:], jnp.float32).at[1:-1, 1:-1].set(1.0)
    return out * mask


def census(I):
    """Packed 8-bit census transform (reference census.cc:59-91).

    Input ``(..., H, W)``; output ``(..., H, W)`` uint8 with bit b set when
    neighbor b >= center.  Border pixels are 0.
    """
    planes = census_planes(I).astype(jnp.uint8)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(planes * weights[..., :, None, None], axis=-3, dtype=jnp.uint8)


def extract_bitplanes(C):
    """Unpack a packed census image into 8 float {0,1} channels
    (reference bitplanes_descriptor.cc:39-57 ``ExtractChannel``)."""
    C = jnp.asarray(C)
    bits = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], C.dtype)
    return ((C[..., None, :, :] & bits[:, None, None]) > 0).astype(jnp.float32)
