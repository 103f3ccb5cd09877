"""IRLS Gauss-Newton pose refinement on one pyramid level, as a jitted
``lax.while_loop``.

Counterpart of the reference's CRTP optimizer framework
(``bpvo/pose_estimator_base.h``: main loop at :324-407, the three convergence
tests at :258-282; ``bpvo/pose_estimator_gn.h``: linearize =
residuals -> scale -> weights -> J^T W J at :70-81) and of its per-level
parameter relaxation (``bpvo/pose_estimator_params.cc:36-47``).

Flow per iteration (inverse compositional — template Jacobians fixed):
  r, valid = photometric residuals at T
  sigma    = robust scale (skipped once stable, mestimator.cc:467-490)
  w        = M-estimator weights
  H, g, f  = J^T W J, J^T W r, sqrt(sum w r^2)
  dp       = solve(H, g)    (Levenberg-augmented fallback)
  T       <- T * Tn^{-1} exp(-dp) Tn     (pose_estimator_base.h:371-390)

The LM trust-region variant is in ``bpvo_tpu/solver/levenberg_marquardt.py``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.core import se3
from bpvo_tpu.solver import linear_system, mestimator
from bpvo_tpu.types import (InterpolationType, LossFunctionType,
                            PoseEstimationStatus)
from bpvo_tpu.vo import template_data as td_mod
from bpvo_tpu.vo import warp as warp_mod

_SQRT_EPS = 3.452669831e-4  # sqrt(float32 machine eps), pose_estimator_base.h:262

# integer status codes used inside jit (mapped back to PoseEstimationStatus)
STATUS_MAX_ITERATIONS = 0
STATUS_PARAMETER_TOL = 1
STATUS_FUNCTION_TOL = 2
STATUS_GRADIENT_TOL = 3
STATUS_SOLVER_ERROR = 4

STATUS_ENUMS = {
    STATUS_MAX_ITERATIONS: PoseEstimationStatus.MAX_ITERATIONS,
    STATUS_PARAMETER_TOL: PoseEstimationStatus.PARAMETER_TOL_REACHED,
    STATUS_FUNCTION_TOL: PoseEstimationStatus.FUNCTION_TOL_REACHED,
    STATUS_GRADIENT_TOL: PoseEstimationStatus.GRADIENT_TOL_REACHED,
    STATUS_SOLVER_ERROR: PoseEstimationStatus.SOLVER_ERROR,
}


@dataclasses.dataclass(frozen=True)
class GNOptions:
    """Static (hashable) per-level optimizer configuration."""
    max_iterations: int = 50
    function_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-7
    gradient_tolerance: float = 1e-8
    loss: LossFunctionType = LossFunctionType.TUKEY
    interp: InterpolationType = InterpolationType.LINEAR
    scale_tolerance: float = 1e-6   # AutoScaleEstimator tol (mestimator.h:63)
    # RELATIVE sigma-stability tolerance: re-estimation stops once the last
    # sigma step was below ``scale_tolerance_rel * sigma`` (in addition to
    # the reference's absolute test above).  The reference's 1e-6 absolute
    # tolerance is effectively "never stable" for unit-scale descriptors
    # (BitPlanes sigma ~0.05-0.3), so sigma keeps drifting with the pose,
    # the cost stays non-stationary, and the function-tolerance test cannot
    # fire — measured grind: 28-46 GN iters/frame on BitPlanes (vs ~17 for
    # intensity) with zero accuracy benefit.  Measured A/B (KITTI-shape
    # value-noise scene, 12 frames): BitPlanes 30.3 iters/err 0.0025 at 0 ->
    # 21.0/0.0023 at 0.01 -> 19.2/0.0022 at 0.05; intensity 17.6/2e-5 ->
    # 16.9/2e-5 at 0.01.  Default 0.01; 0 restores reference semantics.
    # BPVO_SCALE_TOL_REL overrides — resolved per CONSTRUCTION (default
    # factory), not at import, so setting the env var after importing
    # bpvo_tpu still takes effect.
    scale_tolerance_rel: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("BPVO_SCALE_TOL_REL", "0.01")))
    use_histogram_median: bool = True
    # per-iteration table like the reference's kIteration verbosity
    # (pose_estimator_base.h:231-247), printed from inside the jitted loop
    verbose: bool = False
    # warp parameterization: "RigidBody" | "DisparitySpace" (config warpType)
    warp: str = "RigidBody"
    # storage of the pre-shifted interpolation taps ("f32" | "bf16" |
    # "bf16pack", see interp.pack_taps); "auto" is f32.  bf16-valued taps
    # halve the bytes each warped gather reads and are accuracy-neutral on
    # the census-bit descriptor; whether that pays on the GPU is open.
    taps_dtype: str = os.environ.get("BPVO_TAPS_DTYPE", "auto")

    @classmethod
    def from_params(cls, p: AlgorithmParameters, coarse: bool) -> "GNOptions":
        """Coarse levels get relaxed tolerances and the smoother Huber loss
        (reference pose_estimator_params.cc:36-47)."""
        from bpvo_tpu.types import VerbosityType
        verbose = p.verbosity in (VerbosityType.ITERATION, VerbosityType.DEBUG)
        # sigma-stability tolerance: an explicit BPVO_SCALE_TOL_REL applies
        # to every level; otherwise coarse levels relax to 0.05 — the
        # round-4 sweep measured 0.05 at 19.2 iters / err 0.0022 vs 0.01 at
        # 21.0 / 0.0023 on BitPlanes (equal-or-better accuracy, fewer
        # sigma-driven iterations), so the relaxation belongs with the other
        # coarse-level relaxed tolerances (the finest level, which sets the
        # final pose, stays at 0.01).
        env_rel = os.environ.get("BPVO_SCALE_TOL_REL")
        if not coarse or not p.relaxTolerancesForCoarseLevels:
            rel = float(env_rel) if env_rel is not None else 0.01
            return cls(max_iterations=p.maxIterations,
                       function_tolerance=p.functionTolerance,
                       parameter_tolerance=p.parameterTolerance,
                       gradient_tolerance=p.gradientTolerance,
                       loss=p.lossFunction, interp=p.interp, verbose=verbose,
                       warp=p.warpType,
                       scale_tolerance_rel=rel)
        s = p.coarseToleranceScale
        loss = (p.lossFunction if p.lossFunction == LossFunctionType.L2
                else LossFunctionType.HUBER)
        rel = float(env_rel) if env_rel is not None else 0.05
        return cls(max_iterations=min(p.maxIterations, p.coarseMaxIterations),
                   function_tolerance=p.functionTolerance * s,
                   parameter_tolerance=p.parameterTolerance * s,
                   gradient_tolerance=p.gradientTolerance * s,
                   loss=loss, interp=p.interp, verbose=verbose,
                   warp=p.warpType,
                   scale_tolerance_rel=rel)


class GNState(NamedTuple):
    T: jnp.ndarray            # (4, 4) current pose
    dp: jnp.ndarray           # (6,) last update
    f_norm: jnp.ndarray       # weighted residual norm at last linearize
    f_norm_prev: jnp.ndarray
    dp_norm_prev: jnp.ndarray
    g: jnp.ndarray            # (6,) gradient at last linearize
    g_tol: jnp.ndarray
    scale: jnp.ndarray        # robust sigma
    delta_scale: jnp.ndarray
    weights: jnp.ndarray      # (C, K) last IRLS weights
    H: jnp.ndarray            # (6, 6) last Hessian
    num_iters: jnp.ndarray    # int32
    status: jnp.ndarray       # int32
    converged: jnp.ndarray    # bool
    solver_ok: jnp.ndarray    # bool
    # best-iterate fallback: the lowest evaluated cost and its pose.  GN under
    # IRLS is not monotone; on rare frames the coarse level walks AWAY from
    # the basin (measured: corridor f83 CentralDifference, cost 450 -> 4220
    # over 34 iterations, a 1 m single-frame pose error the reference escapes
    # only by selection luck).  ``run`` returns the best evaluated iterate
    # when the loop ends unconverged with a worse cost.
    T_best: jnp.ndarray       # (4, 4)
    f_best: jnp.ndarray       # cost at T_best


def _sigma_unstable(delta_scale, scale, opts: "GNOptions"):
    """Stable-skip test for sigma re-estimation: absolute (reference
    mestimator.cc:467-490) OR relative (scale_tolerance_rel) threshold."""
    return delta_scale > jnp.maximum(
        jnp.asarray(opts.scale_tolerance, jnp.float32),
        opts.scale_tolerance_rel * scale)


def _linearize(tdata, channels, cam, T, scale, delta_scale, opts: GNOptions,
               packed=None):
    r, valid = td_mod.compute_residuals(tdata, channels, cam, T, opts.interp,
                                        packed=packed, warp=opts.warp)
    # scale re-estimation is skipped once stable (mestimator.cc:467-490) — via
    # lax.cond so the median work is actually not executed when stable.
    # Like the reference's getValidResiduals (linear_system_builder.cc:302-315)
    # we estimate sigma from the first channel only — other channels look alike.
    do_est = _sigma_unstable(delta_scale, scale, opts)
    new_sigma = jax.lax.cond(
        do_est,
        lambda op: mestimator.estimate_scale(op[0], op[1],
                                             opts.use_histogram_median),
        lambda op: scale, (r[0], valid))
    sigma = new_sigma
    new_delta = jnp.where(do_est, jnp.abs(new_sigma - scale), delta_scale)
    w = mestimator.compute_weights(opts.loss, r, valid[None, :], sigma)
    H, g, f_sq = linear_system.build(tdata.jacobians, r, w)
    return H, g, jnp.sqrt(f_sq), sigma, new_delta, w


def _test_convergence(dp_norm, dp_norm_prev, g_norm, f_norm, f_norm_prev,
                      g_tol, opts: GNOptions):
    """The three convergence tests (pose_estimator_base.h:258-282)."""
    p_tol = (dp_norm < opts.parameter_tolerance) | (
        dp_norm < opts.parameter_tolerance * (_SQRT_EPS + dp_norm_prev))
    # the reference's |f - f_prev| < tol test is absolute (pose_estimator_base.h
    # :269-272); with f ~ 1e2-1e3 that is below float32 rounding, so a
    # RELATIVE decrease test is added — without it every level runs to
    # maxIterations on device
    f_tol = ((f_norm < opts.function_tolerance)
             | (f_norm < opts.function_tolerance * (_SQRT_EPS + f_norm_prev))
             | (jnp.abs(f_norm - f_norm_prev) < opts.function_tolerance)
             | (jnp.abs(f_norm - f_norm_prev)
                < opts.function_tolerance * jnp.maximum(f_norm_prev, 1.0)))
    g_ok = g_norm < g_tol
    status = jnp.where(
        p_tol, STATUS_PARAMETER_TOL,
        jnp.where(f_tol, STATUS_FUNCTION_TOL,
                  jnp.where(g_ok, STATUS_GRADIENT_TOL, STATUS_MAX_ITERATIONS)))
    return p_tol | f_tol | g_ok, status.astype(jnp.int32)


def run(tdata, channels, cam: warp_mod.CameraModel, T_init,
        opts: GNOptions, linearize_fn=None) -> GNState:
    """Run GN to convergence from T_init; returns the full final state.

    Pure function of its inputs — jit with static ``opts``.

    The loop body holds exactly ONE linearization (the reference's structure at
    pose_estimator_base.h:324-407 linearizes both before and inside the loop —
    traced naively that doubles the XLA program and its compile time).
    Iteration i linearizes at T_i, tests convergence against iteration i-1's
    values, then solves and updates.

    ``linearize_fn(T, scale, delta_scale) -> (H, g, f, sigma, dscale, w)``
    may be overridden — the distributed path injects a psum-reducing variant
    (bpvo_tpu/parallel/sharded.py).
    """
    f32 = jnp.float32
    T0 = jnp.asarray(T_init, f32)
    s, c = tdata.norm_scale, tdata.norm_center
    if linearize_fn is None:
        # channels are constant across iterations: pre-shift them once so each
        # iteration's warped sampling is a single gather (interp.pack_taps)
        from bpvo_tpu.ops import interp as interp_mod
        td_ = "f32" if opts.taps_dtype == "auto" else opts.taps_dtype
        packed = interp_mod.pack_taps(
            channels, opts.interp,
            dtype={"bf16": jnp.bfloat16, "bf16pack": "bf16pack"}.get(td_))

        def linearize_fn(T, scale, dscale):
            return _linearize(tdata, channels, cam, T, scale, dscale, opts,
                              packed=packed)

    C, K = tdata.pixels.shape
    init = GNState(
        T=T0, dp=jnp.zeros(6, f32), f_norm=jnp.asarray(0.0, f32),
        f_norm_prev=jnp.asarray(0.0, f32),
        dp_norm_prev=jnp.asarray(0.0, f32), g=jnp.zeros(6, f32),
        g_tol=jnp.asarray(0.0, f32), scale=jnp.asarray(1.0, f32),
        delta_scale=jnp.asarray(1e10, f32),
        weights=jnp.zeros((C, K), f32), H=jnp.eye(6, dtype=f32),
        num_iters=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(STATUS_MAX_ITERATIONS, jnp.int32),
        converged=jnp.asarray(False), solver_ok=jnp.asarray(True),
        T_best=T0, f_best=jnp.asarray(jnp.inf, f32))

    def cond(st: GNState):
        return (~st.converged) & st.solver_ok & (
            st.num_iters < opts.max_iterations)

    def body(st: GNState):
        first = st.num_iters == 0
        H, g, f_new, sigma, dscale, w = linearize_fn(
            st.T, st.scale, st.delta_scale)
        g_norm = jnp.max(jnp.abs(g))
        # first-order-optimality threshold fixed from the first gradient
        # (pose_estimator_base.h:341-343)
        g_tol = jnp.where(
            first, opts.gradient_tolerance * jnp.maximum(g_norm, _SQRT_EPS),
            st.g_tol)

        dp_norm = jnp.linalg.norm(st.dp)
        conv, status = _test_convergence(
            dp_norm, st.dp_norm_prev, g_norm, f_new, st.f_norm, g_tol, opts)
        # on the first iteration only the gradient test applies
        # (pose_estimator_base.h:346-360)
        g_conv = g_norm < g_tol
        conv = jnp.where(first, g_conv, conv)
        status = jnp.where(
            first, jnp.where(g_conv, STATUS_GRADIENT_TOL,
                             STATUS_MAX_ITERATIONS),
            status).astype(jnp.int32)

        dp, ok = linear_system.solve(H, g)
        do_update = (~conv) & ok
        if opts.verbose:
            jax.debug.print(
                "  it {it}  |F|={f:.6g}  |G|={g:.4g}  |dp|={dp:.4g}  "
                "sigma={s:.4g}", it=st.num_iters, f=f_new, g=g_norm,
                dp=jnp.linalg.norm(dp), s=sigma)
        T = jnp.where(do_update, se3.orthonormalize(
            st.T @ warp_mod.params_to_pose(-dp, s, c)), st.T)
        better = f_new < st.f_best
        return GNState(
            T=T, dp=jnp.where(do_update, dp, st.dp), f_norm=f_new,
            f_norm_prev=st.f_norm, dp_norm_prev=dp_norm, g=g, g_tol=g_tol,
            scale=sigma, delta_scale=dscale, weights=w, H=H,
            num_iters=st.num_iters + 1,
            status=jnp.where(ok, status, STATUS_SOLVER_ERROR).astype(jnp.int32),
            converged=conv, solver_ok=ok,
            T_best=jnp.where(better, st.T, st.T_best),
            f_best=jnp.where(better, f_new, st.f_best))

    st = jax.lax.while_loop(cond, body, init)
    # Unconverged exits (max iterations / solver error) whose final evaluated
    # cost exceeds the best seen fall back to the best evaluated iterate —
    # f_new in the loop is the cost of the ENTERING pose, so on convergence
    # st.T is the evaluated pose and is kept as-is.
    use_best = (~st.converged) & (st.f_best < st.f_norm)
    return st._replace(T=jnp.where(use_best, st.T_best, st.T))


def fraction_of_good_points(weights, num_channels, num_valid, threshold):
    """count(w > thresh) / (C * N) (reference vo_pose_estimator.cc:101-107);
    N is the true (unpadded) template point count."""
    n_good = jnp.sum(weights > threshold)
    denom = jnp.maximum(num_channels * num_valid, 1)
    return n_good.astype(jnp.float32) / denom.astype(jnp.float32)
