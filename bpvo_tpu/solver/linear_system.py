"""Weighted Gauss-Newton normal equations: H = J^T W J, g = J^T W r.

Counterpart of the reference's ``bpvo/linear_system_builder.{h,cc}`` +
``linear_system_builder_reduction.h``: the TBB ``parallel_reduce`` with SSE
rank-updates of a packed upper-triangular H (linear_system_builder.cc:91-237,
the DVO-SLAM-derived layout at :140-205) becomes a single einsum/matmul pair,
plus a ``psum`` across devices in the sharded path
(bpvo_tpu/parallel) — mathematically identical to the TBB join at
linear_system_builder.cc:96-101.

Returns the weighted residual norm f = sqrt(sum v w r^2) exactly like
``LinearSystemBuilder::Run`` (linear_system_builder.cc:334-350).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def build(J, r, w):
    """Accumulate the 6x6 system.

    J: (..., N, 6) Jacobians, r: (..., N) residuals, w: (..., N) weights
    (already zero for invalid entries). Leading axes (channels) are reduced.

    Returns (H (6,6), g (6,), f_sq scalar = sum w r^2).
    """
    Jf = J.reshape(-1, 6)
    rf = r.reshape(-1)
    wf = w.reshape(-1)
    Jw = Jf * wf[:, None]
    # (6, M) @ (M, 6) contractions.  Precision.HIGHEST keeps them in full
    # float32: a reduced-precision product (TF32 on the GPU keeps ~3 decimal
    # digits of each operand) leaves ~1e-3-relative noise in H/g, which keeps
    # the GN convergence tests from ever firing.
    H = jnp.dot(Jw.T, Jf, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    g = jnp.dot(Jw.T, rf, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    f_sq = jnp.sum(wf * rf * rf)
    return H, g, f_sq


def cholesky_solve_6x6(H, g):
    """Fully unrolled 6x6 Cholesky solve.

    ``jnp.linalg.solve`` lowers to a generic LU loop nest that XLA cannot fuse
    into the surrounding GN while-loop body; an unrolled LL^T factorization is
    ~60 scalar FLOPs that fuse completely.  The reference's equivalent is
    Eigen's fixed-size LDLT (pose_estimator_base.h:67-151).
    """
    L = [[None] * 6 for _ in range(6)]
    tiny = jnp.asarray(1e-20, H.dtype)
    for i in range(6):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, tiny))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = g
    y = [None] * 6
    for i in range(6):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def solve(H, g, eps: float = 1e-3):
    """Solve H dp = g with a Levenberg-augmented fallback.

    The reference solves float LDLT, then retries in double with
    ``diag += 0.001 * max(diag)`` when the residual check fails
    (pose_estimator_base.h:90-148).  We compute both candidates branch-free and
    select: XLA has no cheap dynamic branch, and the 6x6 solves are trivial.
    Hartley normalization (withNormalization) keeps H well-conditioned in f32 —
    that is its whole purpose (template_data.cc:91-92).
    """
    # a single Cholesky on a minutely-regularized H replaces the reference's
    # try-exact-then-retry dance: the relative jitter (1e-6 of the largest
    # diagonal) perturbs well-conditioned steps below f32 noise while making
    # the degenerate case solvable — one solve per GN iteration instead of two
    H_aug = H + (1e-6 * jnp.max(jnp.diag(H)) + 1e-12) * jnp.eye(6, dtype=H.dtype)
    dp = cholesky_solve_6x6(H_aug, g)
    finite = jnp.all(jnp.isfinite(dp))
    dp = jnp.where(finite, dp, jnp.zeros_like(dp))
    ok = finite & (jnp.max(jnp.abs(H @ dp - g))
                   <= 1e-3 * (1.0 + jnp.max(jnp.abs(g))))
    return dp, ok
