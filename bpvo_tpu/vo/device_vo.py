"""Device-resident visual odometry: the full per-frame step — descriptors,
coarse-to-fine IRLS GN, keyframe decision, template rebuild, trajectory
accumulation — as ONE pure jittable function with all state in device arrays.

This is the device-resident redesign of the reference's stateful host
pipeline (``bpvo/vo.cc`` Impl::addFrame, vo.cc:125-224): where the reference swaps
unique_ptr frames and rebuilds templates on the host thread, here the keyframe
machinery is ``lax.cond`` branches over a ``VOState`` pytree, so a frame costs
zero host round-trips and whole sequences can run under ``lax.scan`` in a
single device dispatch (``run_chunk``).  The host wrapper (``DeviceVO``)
fetches results in batches.

Keyframe semantics follow vo.cc exactly:
  - not a keyframe: current frame becomes the *candidate* (prev), motion
    initialization accumulates (vo.cc:148-153)
  - keyframe with no candidate: current frame becomes the keyframe
    (vo.cc:166-177)
  - keyframe with candidate: the candidate becomes the keyframe and the pose
    is re-estimated against it, because the estimate that triggered keyframing
    is suspect (vo.cc:178-188)
"""
from __future__ import annotations


from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.core import se3
from bpvo_tpu.ops import descriptors, imgproc, pyramid, selection
from bpvo_tpu.solver import gauss_newton as gn
from bpvo_tpu.types import KeyFramingReason
from bpvo_tpu.vo import template_data as td_mod
from bpvo_tpu.vo import warp as warp_mod

# device-side keyframing reason codes (mirror types.KeyFramingReason)
KF_NONE = 0
KF_TRANSLATION = 1
KF_ROTATION = 2
KF_FRAC_POINTS = 3

KF_REASON_ENUMS = {
    KF_NONE: KeyFramingReason.NO_KEYFRAMING,
    KF_TRANSLATION: KeyFramingReason.LARGE_TRANSLATION,
    KF_ROTATION: KeyFramingReason.LARGE_ROTATION,
    KF_FRAC_POINTS: KeyFramingReason.SMALL_FRAC_OF_GOOD_POINTS,
}


class VOState(NamedTuple):
    templates: Tuple[td_mod.TemplateData, ...]
    prev_channels: Tuple[jnp.ndarray, ...]   # keyframe-candidate descriptor pyramid
    prev_disparity: jnp.ndarray              # candidate full-res disparity
                                             # (or the (2,H,W) gray stereo
                                             # pair in stereo_fn mode)
    has_prev: jnp.ndarray                    # () bool
    T_kf: jnp.ndarray                        # (4,4) initialization accumulator
    pose_world: jnp.ndarray                  # (4,4) camera-to-world trajectory
    T_delta: jnp.ndarray                     # (4,4) last inter-frame motion
                                             # (constant-velocity warm start)
    last_weights: jnp.ndarray                # (C, K) finest-level IRLS weights
                                             # of the latest estimate, aligned
                                             # with templates[maxTestLevel] —
                                             # feeds minPointWeight PLY
                                             # filtering (vo.cc:260-281)


class VOStepOutput(NamedTuple):
    pose: jnp.ndarray         # (4,4) relative motion wrt previous frame
    pose_world: jnp.ndarray   # (4,4) accumulated camera-to-world pose
    is_keyframe: jnp.ndarray  # () bool
    reason: jnp.ndarray       # () int32
    iters: jnp.ndarray        # (L,) int32 per-level GN iterations
    f_norm: jnp.ndarray       # (L,)
    frac_good: jnp.ndarray    # ()
    H: jnp.ndarray            # (6,6) finest-level Hessian


def _rigid_inverse(T):
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    Ti = Ti.at[:3, 3].set(-R.T @ t)
    return Ti


def _compute_channels_pyr(image, p: AlgorithmParameters, n_levels: int):
    out = []
    img = image
    for level in range(n_levels):
        out.append(descriptors.compute(img, p))
        if level + 1 < n_levels:
            img = imgproc.pyr_down(img)
    return tuple(out)


def _build_templates(channels_pyr, disparity, cams, p, capacities):
    out = []
    for level, ch in enumerate(channels_pyr):
        d_level = imgproc.disparity_at_level(disparity, level)
        d_level = d_level[:ch.shape[1], :ch.shape[2]]
        out.append(td_mod.set_data(ch, d_level, cams[level], p,
                                   capacities[level], level))
    return tuple(out)


def _estimate(templates, channels_pyr, cams, T_init, opts_per_level,
              max_test_level, good_threshold, min_points: int = 0,
              solver: str = "GaussNewton", linearize_factory=None,
              count_reduce=None, start_level=None):
    """``linearize_factory(level, tdata, channels, cam, opts)`` may return a
    custom linearize_fn (the distributed path injects a psum-reducing one);
    ``count_reduce`` reduces scalar counts across shards (default identity).
    ``start_level`` (static) starts the coarse-to-fine chain below the
    coarsest level — the keyframe re-estimate's single-frame motion does not
    need the full pyramid (keyframeReestimateStartLevel)."""
    n_levels = len(channels_pyr)
    if start_level is None:
        start_level = n_levels - 1
    T = T_init
    iters = [jnp.asarray(0, jnp.int32)] * n_levels
    fs = [jnp.asarray(0.0, jnp.float32)] * n_levels
    if solver == "LevenbergMarquardt":
        from bpvo_tpu.solver import levenberg_marquardt as lm
        run_level = lm.run
    else:
        run_level = gn.run
    finest = None
    for level in range(start_level, max_test_level - 1, -1):
        lin = (linearize_factory(level, templates[level], channels_pyr[level],
                                 cams[level], opts_per_level[level])
               if linearize_factory is not None else None)
        st = run_level(templates[level], channels_pyr[level], cams[level], T,
                       opts_per_level[level],
                       **({"linearize_fn": lin} if lin is not None else {}))
        # minNumPixelsToWork guard (branchless; reference types.h:352-357)
        enough = templates[level].num_valid >= min_points
        st = st._replace(T=jnp.where(enough, st.T, T),
                         num_iters=jnp.where(enough, st.num_iters, 0))
        T = st.T
        iters[level] = st.num_iters
        fs[level] = st.f_norm
        finest = st
    td = templates[max_test_level]
    n_good = jnp.sum(finest.weights > good_threshold)
    if count_reduce is not None:
        n_good = count_reduce(n_good)
    denom = jnp.maximum(td.num_channels * td.num_valid, 1)
    frac = n_good.astype(jnp.float32) / denom.astype(jnp.float32)
    return (T, jnp.stack(iters), jnp.stack(fs), frac, finest.H,
            finest.weights)


def _coarse_cost(templates, channels_pyr, cams, T, opts, level=None):
    """Mean squared residual over valid points at a COARSE level (default:
    coarsest): the cheap probe for the warm-start acceptance gate (few
    hundred points, one residual pass, no sigma/weights)."""
    lvl = len(channels_pyr) - 1 if level is None else level
    r, valid = td_mod.compute_residuals(templates[lvl], channels_pyr[lvl],
                                        cams[lvl], T, opts.interp,
                                        warp=opts.warp)
    n = jnp.maximum(jnp.sum(valid), 1).astype(jnp.float32)
    return jnp.sum(jnp.where(valid[None, :], r, 0.0) ** 2) / n


def _gated_warm_start(templates, channels_pyr, cams, T_warm, T_cold, opts,
                      level=None):
    """Warm start with an acceptance gate: take the warm prediction only
    when its photometric cost at the probe level does not exceed the cold
    start's.  Guards against a bad prediction extrapolating into a
    self-consistent alias lock (round-3 bench pathology,
    docs/PERFORMANCE.md): a real-motion warm start wins the probe, an
    aliased one costs more than the cold start and is rejected."""
    c_warm = _coarse_cost(templates, channels_pyr, cams, T_warm, opts, level)
    c_cold = _coarse_cost(templates, channels_pyr, cams, T_cold, opts, level)
    return jnp.where(c_warm <= c_cold, T_warm, T_cold)


def _keyframe_reason(T_est, frac_good, p: AlgorithmParameters):
    """Device version of shouldKeyFrame (vo.cc:199-224)."""
    t_sq = jnp.sum(T_est[:3, 3] ** 2)
    R = T_est[:3, :3]
    sy = jnp.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    euler = jnp.stack([
        jnp.arctan2(R[2, 1], R[2, 2]),
        jnp.arctan2(-R[2, 0], jnp.maximum(sy, 1e-12)),
        jnp.arctan2(R[1, 0], R[0, 0])])
    if p.rotationKeyframeInDegrees:   # see config.py — ablation knob
        euler = euler * (180.0 / jnp.pi)
    r_sq = jnp.sum(euler ** 2)
    reason = jnp.where(
        t_sq > p.minTranslationMagToKeyFrame ** 2, KF_TRANSLATION,
        jnp.where(r_sq > p.minRotationMagToKeyFrame ** 2, KF_ROTATION,
                  jnp.where(frac_good < p.maxFractionOfGoodPointsToKeyFrame,
                            KF_FRAC_POINTS, KF_NONE)))
    return reason.astype(jnp.int32)


def make_vo_step(p: AlgorithmParameters, cams, capacities,
                 opts_per_level: Tuple[gn.GNOptions, ...],
                 linearize_factory=None, build_templates_fn=None,
                 count_reduce=None, stereo_fn=None):
    """Build the pure step function (state, image, aux) -> (state, out).

    ``aux`` is the precomputed float disparity map by default; with
    ``stereo_fn`` (a jittable ``(left, right) -> disparity``) it is the RIGHT
    grayscale image and disparity is computed ON DEVICE **at keyframe rate**:
    the matcher runs inside the keyframe ``lax.cond`` branch, on the frame
    that actually becomes the keyframe (the candidate or the current one), so
    non-keyframe frames pay zero stereo cost.  The reference's StereoDataset
    runs its matcher on the host for EVERY frame (utils/dataset.cc:103-135)
    but the disparity is only ever consumed by setTemplate — computing it
    lazily at template rate produces bit-identical templates at ~1/4 the
    stereo work (measured: docs/SGM_CALIBRATION.md stereo-in-the-loop).

    All configuration is closed over statically; the returned function is
    jit/scan/shard_map-compatible.  The three optional hooks let the
    distributed layer (bpvo_tpu/parallel/sharded_vo.py) run this exact step
    under shard_map with the point axis sharded: ``linearize_factory``
    injects the psum-reducing GN linearization, ``build_templates_fn``
    replaces the template build with the shard-sliced variant, and
    ``count_reduce`` makes the good-point fraction global.
    """
    n_levels = p.numPyramidLevels
    cams = tuple(cams)
    capacities = tuple(capacities)
    if build_templates_fn is None:
        def build_templates_fn(channels_pyr, disparity):
            return _build_templates(channels_pyr, disparity, cams, p,
                                    capacities)

    def step(state: VOState, image, aux):
        channels = _compute_channels_pyr(image.astype(jnp.float32), p, n_levels)
        if stereo_fn is None:
            # aux IS the disparity; the carried candidate store holds it
            disparity = aux.astype(jnp.float32)
        else:
            # aux is the right image; carry the (2, H, W) gray pair so the
            # keyframe branch can run the matcher on the candidate frame
            disparity = jnp.stack([image.astype(jnp.float32),
                                   aux.astype(jnp.float32)])

        # constant-velocity warm start: predict this frame at
        # T_delta_prev @ T_kf (X_cur = T_delta X_prev = T_delta T_kf X_kf);
        # the GN optimum is unchanged, only the iteration count drops.  The
        # prediction must pass the coarse-cost acceptance gate.
        T_init = (_gated_warm_start(state.templates, channels, cams,
                                    state.T_delta @ state.T_kf, state.T_kf,
                                    opts_per_level[n_levels - 1])
                  if p.withMotionModel else state.T_kf)
        T_est, iters, fs, frac, H, w_fine = _estimate(
            state.templates, channels, cams, T_init, opts_per_level,
            p.maxTestLevel, p.goodPointThreshold, p.minNumPixelsToWork,
            p.poseEstimator, linearize_factory, count_reduce)

        reason = _keyframe_reason(T_est, frac, p)
        is_kf = reason != KF_NONE

        def no_keyframe(op):
            state, channels, disparity, T_est = op
            pose = T_est @ _rigid_inverse(state.T_kf)
            new_state = VOState(
                templates=state.templates,
                prev_channels=channels, prev_disparity=disparity,
                has_prev=jnp.asarray(True),
                T_kf=T_est, pose_world=state.pose_world, T_delta=pose,
                last_weights=w_fine)
            return new_state, pose, iters, fs

        def keyframe(op):
            state, channels, disparity, T_est = op
            has_prev = state.has_prev
            # keyframe source: the candidate frame when one exists
            # (vo.cc:178-188), else the current frame (vo.cc:166-177).
            # Selecting the source first keeps ONE template build + ONE
            # re-estimate in the trace instead of two of each.
            src_channels = jax.tree.map(
                lambda a, b: jnp.where(has_prev, a, b),
                state.prev_channels, channels)
            src_store = jnp.where(has_prev, state.prev_disparity, disparity)
            # stereo-in-the-loop: the matcher runs HERE, only on keyframe
            # events, on the pair of the frame becoming the keyframe
            src_disparity = (stereo_fn(src_store[0], src_store[1])
                             if stereo_fn is not None else src_store)
            templates = build_templates_fn(src_channels, src_disparity)
            # re-estimation against the new keyframe; when the keyframe IS the
            # current frame this converges to ~identity in one iteration and
            # its result is unused.  The candidate is the previous frame, so
            # this pass only ever solves SINGLE-frame motion: with
            # keyframeReestimateStartLevel >= 0 it skips the coarse levels
            # (which exist for the large keyframe->current motion) and
            # warm-starts from the measured candidate->current motion
            # T_est @ inv(T_kf) behind the coarse-cost acceptance gate
            # (identity fallback = the reference's init, vo.cc:185).
            if p.keyframeReestimateStartLevel >= 0:
                start2 = min(max(p.keyframeReestimateStartLevel,
                                 p.maxTestLevel), n_levels - 1)
                T2_warm = T_est @ _rigid_inverse(state.T_kf)
                T2_init = _gated_warm_start(
                    templates, channels, cams, T2_warm,
                    jnp.eye(4, dtype=jnp.float32), opts_per_level[start2],
                    level=start2)
            else:
                start2 = n_levels - 1
                # the motion model's prediction for candidate->current is
                # T_delta (constant velocity)
                T2_init = (_gated_warm_start(templates, channels, cams,
                                             state.T_delta,
                                             jnp.eye(4, dtype=jnp.float32),
                                             opts_per_level[n_levels - 1])
                           if p.withMotionModel
                           else jnp.eye(4, dtype=jnp.float32))
            T2, it2, fs2, _frac2, _H2, w2_fine = _estimate(
                templates, channels, cams, T2_init,
                opts_per_level, p.maxTestLevel, p.goodPointThreshold,
                p.minNumPixelsToWork, p.poseEstimator, linearize_factory,
                count_reduce, start_level=start2)
            pose = jnp.where(has_prev, T2,
                             T_est @ _rigid_inverse(state.T_kf))
            T_kf_new = jnp.where(has_prev, T2, jnp.eye(4, dtype=jnp.float32))
            it_out = jnp.where(has_prev, it2, iters)
            fs_out = jnp.where(has_prev, fs2, fs)
            new_state = VOState(
                templates=templates,
                prev_channels=channels, prev_disparity=disparity,
                has_prev=jnp.asarray(False),
                T_kf=T_kf_new, pose_world=state.pose_world, T_delta=pose,
                last_weights=w2_fine)
            return new_state, pose, it_out, fs_out

        new_state, pose, it_out, fs_out = jax.lax.cond(
            is_kf, keyframe, no_keyframe, (state, channels, disparity, T_est))

        pose_world = se3.orthonormalize(
            new_state.pose_world @ _rigid_inverse(pose))
        new_state = new_state._replace(pose_world=pose_world)
        out = VOStepOutput(pose=pose, pose_world=pose_world,
                           is_keyframe=is_kf, reason=reason,
                           iters=it_out, f_norm=fs_out, frac_good=frac, H=H)
        return new_state, out

    return step


class DeviceVO:
    """Host wrapper around the device-resident step.

    ``add_frames(images, disparities)`` runs a whole chunk under ``lax.scan``
    in one dispatch and returns stacked outputs; ``init`` consumes the first
    frame (reference FirstFrameResult, vo.cc:123-139).
    """

    def __init__(self, K, baseline: float, image_size,
                 params: AlgorithmParameters = None, stereo_fn=None):
        """``stereo_fn``: optional jittable ``(left, right) -> disparity``;
        when given, the second argument of ``add_frame(s)`` is the RIGHT
        grayscale image and disparity is computed on device at keyframe rate
        (see make_vo_step)."""
        p = params or AlgorithmParameters()
        rows, cols = image_size
        if p.numPyramidLevels <= 0:
            p = p.replace(numPyramidLevels=p.num_pyramid_levels_for(rows, cols))
        self._p = p
        base_cam = warp_mod.CameraModel.from_K(K, baseline)
        self._cams = tuple(base_cam.at_level(l)
                           for l in range(p.numPyramidLevels))
        shapes = pyramid.level_shapes(rows, cols, p.numPyramidLevels)
        self._capacities = tuple(
            selection.capacity_for_level(p, r, c, l)
            for l, (r, c) in enumerate(shapes))
        fine = gn.GNOptions.from_params(p, coarse=False)
        coarse = gn.GNOptions.from_params(p, coarse=True)
        self._opts = tuple(fine if l == p.maxTestLevel else coarse
                           for l in range(p.numPyramidLevels))
        self._stereo_fn = stereo_fn
        self._step = make_vo_step(p, self._cams, self._capacities, self._opts,
                                  stereo_fn=stereo_fn)
        # donate the state pytree: templates/prev_channels are several MB and
        # pass through unchanged on non-keyframe steps — donation lets XLA
        # alias them instead of copying every frame
        self._step_jit = jax.jit(self._step, donate_argnums=0)
        self._scan_jit = jax.jit(self._run_chunk, donate_argnums=0)
        self._init_jit = jax.jit(self._init_state)
        self.state: VOState = None

    # -- jitted helpers -------------------------------------------------
    def _init_state(self, image, aux):
        p = self._p
        channels = _compute_channels_pyr(
            jnp.asarray(image, jnp.float32), p, p.numPyramidLevels)
        if self._stereo_fn is None:
            disparity = jnp.asarray(aux, jnp.float32)
            store = disparity
        else:
            store = jnp.stack([jnp.asarray(image, jnp.float32),
                               jnp.asarray(aux, jnp.float32)])
            disparity = self._stereo_fn(store[0], store[1])
        templates = _build_templates(channels, disparity, self._cams, p,
                                     self._capacities)
        td0 = templates[p.maxTestLevel]
        return VOState(
            templates=templates, prev_channels=channels,
            prev_disparity=store, has_prev=jnp.asarray(False),
            T_kf=jnp.eye(4, dtype=jnp.float32),
            pose_world=jnp.eye(4, dtype=jnp.float32),
            T_delta=jnp.eye(4, dtype=jnp.float32),
            last_weights=jnp.ones_like(td0.pixels))

    def _run_chunk(self, state, images, disparities):
        return jax.lax.scan(
            lambda s, xs: self._step(s, xs[0], xs[1]), state,
            (images, disparities))

    # -- public API ----------------------------------------------------
    def init(self, image, disparity):
        self.state = self._init_jit(image, disparity)

    def add_frame(self, image, disparity) -> VOStepOutput:
        """Single online step; returns device-resident outputs (fetch lazily)."""
        if self.state is None:
            self.init(image, disparity)
            return None
        self.state, out = self._step_jit(
            self.state, jnp.asarray(image), jnp.asarray(disparity))
        return out

    def point_cloud(self):
        """Point cloud of the CURRENT keyframe template (finest level), in
        keyframe coordinates (cf. reference vo.cc:260-281; the host
        VisualOdometry attaches clouds per keyframe result — here they are
        pulled on demand to keep the device loop sync-free)."""
        from bpvo_tpu.vo.point_cloud import PointCloud
        if self.state is None:
            return None
        td = self.state.templates[self._p.maxTestLevel]
        valid = np.asarray(td.valid)
        pts = np.asarray(td.points)[valid].astype(np.float32)
        inten = np.clip(np.asarray(td.pixels)[0][valid], 0, 255).astype(np.uint8)
        colors = np.stack([inten, inten, inten,
                           np.full_like(inten, 255)], axis=1)
        # real finest-level IRLS weights carried in VOState (vo.cc:260-281
        # semantics; round 3 returned all-ones, breaking minPointWeight
        # filtering on the device path — VERDICT item 8)
        weights = np.asarray(self.state.last_weights)[0][valid]
        return PointCloud(points=pts, colors=colors,
                          weights=weights.astype(np.float32))

    def add_frames(self, images: np.ndarray, disparities: np.ndarray
                   ) -> VOStepOutput:
        """Chunk mode: (N,H,W) arrays -> stacked VOStepOutput, one dispatch."""
        if self.state is None:
            self.init(images[0], disparities[0])
            images, disparities = images[1:], disparities[1:]
        self.state, outs = self._scan_jit(
            self.state, jnp.asarray(images, jnp.float32),
            jnp.asarray(disparities, jnp.float32))
        return outs
