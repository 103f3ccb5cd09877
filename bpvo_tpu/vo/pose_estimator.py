"""Coarse-to-fine multi-level pose estimation driver.

Counterpart of the reference's ``bpvo/vo_pose_estimator.{h,cc}``
(``estimatePose`` loop from coarsest level down to maxTestLevel at
vo_pose_estimator.cc:63-93; relaxed parameters for coarse levels;
``getFractionOfGoodPoints`` at :101-107).

Design: the whole coarse-to-fine chain is ONE jitted XLA program — the
Python level loop is unrolled at trace time (levels have static shapes), so a
frame's pose estimate is a single device dispatch with no host round-trips
between levels.  Per-level statistics come back as small stacked arrays and are
materialized lazily.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.solver import gauss_newton as gn
from bpvo_tpu.types import OptimizerStatistics
from bpvo_tpu.vo import warp as warp_mod
from bpvo_tpu.vo.template_data import TemplateData


# fewer valid points than this cannot constrain the 6-DoF solve; levels below
# it are skipped (branchless).  Deliberately NOT minNumPixelsToWork — the
# reference parses that key but never consults it (see _estimate_all docstring).
_MIN_POINTS_PER_LEVEL = 8


@partial(jax.jit, static_argnames=("opts",))
def _run_level(tdata, channels, cam, T, opts):
    """Single-level GN (kept for tests/tools; production uses _estimate_all)."""
    return gn.run(tdata, channels, cam, T, opts)


@partial(jax.jit, static_argnames=("opts_per_level", "max_test_level",
                                   "good_threshold", "min_points", "solver",
                                   "start_level", "multistart_px"))
def _estimate_all(templates: Tuple[TemplateData, ...],
                  channels: Tuple[jnp.ndarray, ...],
                  cams: Tuple[warp_mod.CameraModel, ...],
                  T_init,
                  opts_per_level: Tuple[gn.GNOptions, ...],
                  max_test_level: int,
                  good_threshold: float,
                  min_points: int = 0,
                  solver: str = "GaussNewton",
                  start_level: int = -1,
                  alt_init=None,
                  multistart_px: float = 0.0):
    """Full coarse-to-fine estimation as one XLA program.

    Levels with fewer than ``min_points`` valid template points leave the pose
    untouched — a branchless select, so degenerate levels cost compute but not
    correctness.  NOTE: the reference parses minNumPixelsToWork but never uses
    it (types.cc:101 is its only non-print reference) and runs every level
    regardless of point count (vo_pose_estimator.cc:76-90); we therefore gate
    only truly degenerate levels (fewer points than needed to constrain the
    6-DoF solve), not on minNumPixelsToWork.

    Returns (T, iters (L,), f_norm (L,), g_norm (L,), status (L,), frac_good,
    H (6,6), finest_weights).
    """
    n_levels = len(channels)
    if start_level < 0:
        start_level = n_levels - 1
    T = jnp.asarray(T_init, jnp.float32)
    if alt_init is not None:
        # acceptance-gated warm start (same probe as device_vo
        # _gated_warm_start): take alt_init only when its photometric cost
        # at the start level does not exceed T_init's
        from bpvo_tpu.vo import template_data as td_mod
        Ta = jnp.asarray(alt_init, jnp.float32)
        o = opts_per_level[start_level]

        def probe(Tp):
            r, valid = td_mod.compute_residuals(
                templates[start_level], channels[start_level],
                cams[start_level], Tp, o.interp, warp=o.warp)
            n = jnp.maximum(jnp.sum(valid), 1).astype(jnp.float32)
            return jnp.sum(jnp.where(valid[None, :], r, 0.0) ** 2) / n

        T = jnp.where(probe(Ta) <= probe(T), Ta, T)
    if multistart_px > 0:
        # alias-recovery multi-start (config coarseInitOffsetPx): probe the
        # ROBUST cost (mean |r|, resistant to the outlier tails that make a
        # squared cost prefer aliased locks) at the warm init and at
        # +-multistart_px full-res-pixel camera shifts in x/y, metricized
        # through the median template depth; start from the cheapest.
        from bpvo_tpu.solver import mestimator
        from bpvo_tpu.vo import template_data as td_mod
        # probe at a level where one texture period is still resolvable:
        # midway between the coarsest level and the finest (the coarsest
        # sees the period below Nyquist and cannot separate the basins —
        # measured: probing at L2 of a 3-level pyramid never fires on the
        # aliased plane).  BPVO_MS_PROBE_LEVEL overrides for experiments.
        import os as _os
        pl = int(_os.environ.get(
            "BPVO_MS_PROBE_LEVEL", (start_level + max_test_level) // 2))
        pl = min(max(pl, max_test_level), start_level)
        td_s = templates[pl]
        zmed = mestimator.masked_median_sort(td_s.points[:, 2], td_s.valid)
        step = multistart_px * zmed / cams[0].fx
        o = opts_per_level[pl]

        def robust_cost(Tp):
            r, valid = td_mod.compute_residuals(
                templates[pl], channels[pl],
                cams[pl], Tp, o.interp, warp=o.warp)
            n = jnp.maximum(jnp.sum(valid), 1).astype(jnp.float32)
            return jnp.sum(jnp.abs(jnp.where(valid[None, :], r, 0.0))) / n

        def shifted(dx, dy):
            return T.at[0, 3].add(dx).at[1, 3].add(dy)

        cands = jnp.stack([T, shifted(step, 0.0), shifted(-step, 0.0),
                           shifted(0.0, step), shifted(0.0, -step)])
        costs = jax.vmap(robust_cost)(cands)
        # strict preference for the centered init: a shifted candidate must
        # beat it by a margin, not tie it on noise
        best = jnp.argmin(jnp.where(jnp.arange(5) == 0, costs * 0.999,
                                    costs))
        T = cands[best]
    iters = [jnp.asarray(0, jnp.int32)] * n_levels
    fs = [jnp.asarray(0.0, jnp.float32)] * n_levels
    gs = [jnp.asarray(0.0, jnp.float32)] * n_levels
    status = [jnp.asarray(gn.STATUS_MAX_ITERATIONS, jnp.int32)] * n_levels

    if solver == "LevenbergMarquardt":
        from bpvo_tpu.solver import levenberg_marquardt as lm
        run_level = lm.run
    else:
        run_level = gn.run

    finest = None
    for level in range(start_level, max_test_level - 1, -1):
        st = run_level(templates[level], channels[level], cams[level], T,
                       opts_per_level[level])
        enough = templates[level].num_valid >= min_points
        st = st._replace(T=jnp.where(enough, st.T, T),
                         num_iters=jnp.where(enough, st.num_iters, 0))
        T = st.T
        iters[level] = st.num_iters
        fs[level] = st.f_norm
        gs[level] = jnp.max(jnp.abs(st.g))
        status[level] = st.status
        finest = st

    td = templates[max_test_level]
    frac = gn.fraction_of_good_points(
        finest.weights, td.num_channels, td.num_valid, good_threshold)
    return (T, jnp.stack(iters), jnp.stack(fs), jnp.stack(gs),
            jnp.stack(status), frac, finest.H, finest.weights)


class PoseEstimator:
    def __init__(self, p: AlgorithmParameters):
        self._p = p
        self._fine_opts = gn.GNOptions.from_params(p, coarse=False)
        self._coarse_opts = gn.GNOptions.from_params(p, coarse=True)
        self._last_weights = None
        self._last_H = None
        self._last_frac: float = 1.0

    def _opts_for(self, n_levels: int) -> Tuple[gn.GNOptions, ...]:
        return tuple(self._fine_opts if lvl == self._p.maxTestLevel
                     else self._coarse_opts for lvl in range(n_levels))

    def estimate(self, templates: Sequence[TemplateData],
                 channels_pyr: Sequence[jnp.ndarray],
                 cams: Sequence[warp_mod.CameraModel],
                 T_init, start_level: int = -1, alt_init=None,
                 multistart_px: float = 0.0) -> tuple:
        """One-dispatch coarse-to-fine estimate.

        ``start_level`` >= 0 starts the chain below the coarsest level;
        ``alt_init`` is an acceptance-gated alternative initialization (the
        keyframe re-estimate's measured candidate->current motion).

        Returns (T_est (4,4) np.float32, per-level OptimizerStatistics list).
        """
        p = self._p
        n_levels = len(channels_pyr)
        (T, iters, fs, gs, status, frac, H, w) = _estimate_all(
            tuple(templates), tuple(channels_pyr), tuple(cams),
            jnp.asarray(T_init, jnp.float32), self._opts_for(n_levels),
            p.maxTestLevel, p.goodPointThreshold, _MIN_POINTS_PER_LEVEL,
            p.poseEstimator, start_level,
            None if alt_init is None else jnp.asarray(alt_init, jnp.float32),
            multistart_px)

        self._last_weights = w
        self._last_H = H
        # one host sync materializes everything below
        T_np = np.asarray(T)
        self._last_frac = float(frac)
        iters_np, fs_np, gs_np, st_np = (np.asarray(iters), np.asarray(fs),
                                         np.asarray(gs), np.asarray(status))
        stats: List[OptimizerStatistics] = []
        for level in range(p.maxTestLevel, n_levels):
            stats.append(OptimizerStatistics(
                num_iterations=int(iters_np[level]),
                final_error=float(fs_np[level]),
                first_order_optimality=float(gs_np[level]),
                status=gn.STATUS_ENUMS[int(st_np[level])]))
        return T_np, stats

    # ---- queries about the most recent run (finest level) ----

    def fraction_of_good_points(self, threshold: float) -> float:
        """(reference vo_pose_estimator.cc:101-107) — computed on-device during
        estimate(); the threshold there is the one from AlgorithmParameters."""
        return self._last_frac

    def last_weights(self):
        return self._last_weights

    def last_covariance(self) -> np.ndarray:
        """6x6 covariance = inverse of the final GN Hessian
        (reference Result.covariance, types.h:503)."""
        if self._last_H is None:
            return np.eye(6)
        H = np.asarray(self._last_H, np.float64)
        try:
            return np.linalg.inv(H)
        except np.linalg.LinAlgError:
            return np.linalg.pinv(H)
