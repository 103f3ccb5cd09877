"""Robust M-estimation: IRLS weight functions and automatic scale estimation.

Counterpart of the reference's ``bpvo/mestimator.{h,cc}`` (Huber k=1.345 / Tukey
t=4.685 weight ops at mestimator.cc:35-61, SSE kernels at :242-385,
``AutoScaleEstimator`` at :417-490), ``bpvo/robust_loss.h`` (the wider weight-
functor zoo at robust_loss.h:80-115) and ``bpvo/approximate_median.h`` +
``bpvo/histogram.h`` (scatter-free histogram median).

The scale is a *robust standard deviation* of the residuals,
  sigma = 1.4826 (1 + 5/(n-6)) median(|r_valid|),
clamped to 1 when degenerate (mestimator.cc:438-490).  Two medians are provided:
an exact masked-sort median and the reference's histogram approximation
(approximate_median.h:33-57), which avoids a data-dependent sort and is the
default inside the jitted GN loop.
"""
from __future__ import annotations

import jax.numpy as jnp

from bpvo_tpu.types import LossFunctionType

HUBER_K = 1.345
TUKEY_T = 4.685


# ---------------------------------------------------------------------------
# weight functions.  All take normalized residuals u = r / sigma and return the
# IRLS weight w(u) = psi(u)/u for the corresponding loss.
# ---------------------------------------------------------------------------

def huber_weight(u, k: float = HUBER_K):
    au = jnp.abs(u)
    return jnp.where(au < k, 1.0, k / jnp.maximum(au, 1e-20))


def tukey_weight(u, t: float = TUKEY_T):
    x = u / t
    w = (1.0 - x * x)
    return jnp.where(jnp.abs(u) < t, w * w, 0.0)


def l2_weight(u):
    return jnp.ones_like(u)


# the rest of the reference's robust_loss.h zoo (robust_loss.h:80-115)
def cauchy_weight(u, c: float = 2.3849):
    x = u / c
    return 1.0 / (1.0 + x * x)


def fair_weight(u, c: float = 1.3998):
    return 1.0 / (1.0 + jnp.abs(u) / c)


def andrews_weight(u, c: float = 1.339):
    x = u / c
    return jnp.where(jnp.abs(u) < c * jnp.pi,
                     jnp.sinc(x),  # sin(pi x)/(pi x) == sin(u/c)/(u/c)
                     0.0)


def geman_mcclure_weight(u):
    d = 1.0 + u * u
    return 1.0 / (d * d)


def welsch_weight(u, c: float = 2.9846):
    x = u / c
    return jnp.exp(-x * x)


_WEIGHT_FNS = {
    LossFunctionType.HUBER: huber_weight,
    LossFunctionType.TUKEY: tukey_weight,
    LossFunctionType.L2: l2_weight,
}


def compute_weights(loss: LossFunctionType, residuals, valid, sigma):
    """IRLS weights (reference MEstimator::ComputeWeights, mestimator.cc:390-416).

    ``residuals`` (..., N), ``valid`` broadcastable bool, ``sigma`` scalar.
    Invalid entries get weight 0.
    """
    fn = _WEIGHT_FNS[loss]
    u = residuals / sigma
    return valid.astype(residuals.dtype) * fn(u)


# ---------------------------------------------------------------------------
# robust scale
# ---------------------------------------------------------------------------

def masked_median_sort(x, valid):
    """Exact median of x[valid] via full sort (data-dependent but static-shape).

    Matches the reference's median semantics (utils.h:225-237): element n//2 of
    the sorted data for odd n, average of the two middles for even n.
    """
    big = jnp.asarray(jnp.inf, x.dtype)
    xs = jnp.sort(jnp.where(valid, x, big))
    n = jnp.sum(valid).astype(jnp.int32)
    mid = n // 2
    lo = xs[jnp.maximum(mid - 1, 0)]
    hi = xs[jnp.maximum(mid, 0)]
    med = jnp.where((n % 2 == 1) | (n < 3), hi, 0.5 * (lo + hi))
    return jnp.where(n > 0, med, jnp.zeros_like(med))


def histogram_counts(x, valid, hi, bins: int):
    """Cumulative histogram by broadcast comparison instead of scatter-add.

    Scatter-adds with colliding indices serialize; the (bins, N) comparison
    matrix is plain elementwise work plus a reduction (and it psums across
    devices the same way the bincounts would).  Returns csum (bins,) where
    csum[b] = count of valid x_i <= edge_b, edges at
    (b+1) * hi / bins."""
    edges = (jnp.arange(bins, dtype=x.dtype) + 1.0) * hi / bins
    xm = jnp.where(valid, x, hi * 2.0 + 1.0)  # invalid lands beyond all edges
    return jnp.sum(xm[None, :] <= edges[:, None], axis=1)


def masked_median_histogram(x, valid, lo: float = 0.0, hi=None,
                            bins: int = 1024):
    """Histogram approximate median (reference approximate_median.h:33-57,
    histogram.h) as a compare-and-count reduction.

    The reference uses a fixed [0, 255] range with 0.05 resolution (raw
    intensity units).  Descriptors like Bit-Planes produce residuals orders of
    magnitude smaller, so by default we adapt the range to max(|x| valid) —
    keeping the relative resolution constant across descriptor scales."""
    x = x - lo
    if hi is None:
        hi = jnp.maximum(jnp.max(jnp.where(valid, x, 0.0)), 1e-12)
    csum = histogram_counts(x, valid, hi, bins)
    n = jnp.sum(valid)
    target = (n + 1) // 2
    bin_idx = jnp.argmax(csum >= target)
    # lower bin edge, so an all-zero residual vector yields exactly 0
    # (the degenerate case that must map to sigma = 1, mestimator.cc:458-459)
    edge = lo + bin_idx.astype(x.dtype) * hi / bins
    return jnp.where(n > 0, edge, jnp.zeros_like(edge))


def estimate_scale(residuals, valid, use_histogram: bool = True):
    """sigma = 1.4826 (1 + 5/(n-6)) median(|r|), >= 1e-6 -> else 1.0
    (reference mestimator.cc:438-465)."""
    r = jnp.abs(residuals.reshape(-1))
    v = valid.reshape(-1)
    med = (masked_median_histogram(r, v) if use_histogram
           else masked_median_sort(r, v))
    n = jnp.sum(v).astype(residuals.dtype)
    scale = 1.4826 * (1.0 + 5.0 / jnp.maximum(n - 6.0, 1.0)) * med
    return jnp.where(scale < 1e-6, 1.0, scale)
