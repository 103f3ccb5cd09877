"""The FULL device VO step under a point-sharded device mesh.

Extends bpvo_tpu/parallel/sharded.py (which shards only the GN inner loop) to
the whole per-frame pipeline of ``vo/device_vo.make_vo_step`` — descriptors,
coarse-to-fine GN, keyframe decision, template rebuild — inside one
``shard_map``.  No reference analogue (halismai/bpvo is single-process,
SURVEY.md §2.4); this is the "sharded keyframes" capability from BASELINE.md.

Sharding story (per VERDICT.md round-1 item 5):
  - dense image work (descriptor pyramid, saliency, selection top-K,
    back-projection, Hartley normalization) is REPLICATED on every device —
    it is O(H*W) convolutions + O(K) scalar math, cheap relative to the
    per-point stage, and replicating it preserves exact single-device
    selection semantics (no per-shard top-K divergence);
  - per-point template build (descriptor gathers, CD3/CD5 gradients, analytic
    Jacobians — O(C*K) gathers, the expensive part of a keyframe) runs on
    each device's slice of the selected points;
  - the GN loop reduces (histogram, H, g, f_sq) with one fused psum per
    iteration (sharded._linearize_sharded);
  - keyframe scalars (pose, reason) are computed identically on every device
    from psum'd quantities, so control flow never diverges across shards.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.ops import imgproc, pyramid
from bpvo_tpu.parallel import sharded
from bpvo_tpu.parallel.sharded import POINT_AXIS, template_spec
from bpvo_tpu.solver import gauss_newton as gn
from bpvo_tpu.vo import device_vo
from bpvo_tpu.vo import template_data as td_mod
from bpvo_tpu.vo import warp as warp_mod
from bpvo_tpu.vo.device_vo import VOState, VOStepOutput


def _shard_slice(x, axis, n_shards: int, mesh_axis: str = POINT_AXIS):
    """This device's contiguous slice of ``x`` along ``axis``."""
    k = x.shape[axis] // n_shards
    idx = jax.lax.axis_index(mesh_axis)
    starts = [0] * x.ndim
    starts[axis] = idx * k
    sizes = list(x.shape)
    sizes[axis] = k
    return jax.lax.dynamic_slice(x, starts, sizes)


def _build_templates_sharded(channels_pyr, disparity, cams,
                             p: AlgorithmParameters, capacities, n_shards):
    """Replicated selection + shard-sliced per-point build, per level.

    ``num_valid`` stays the GLOBAL count (frac-of-good-points denominator and
    the minNumPixelsToWork guard have global semantics)."""
    out = []
    for level, ch in enumerate(channels_pyr):
        d_level = imgproc.disparity_at_level(disparity, level)
        d_level = d_level[:ch.shape[1], :ch.shape[2]]
        sel, points, s, c = td_mod.select_and_backproject(
            ch, d_level, cams[level], p, capacities[level])
        rows = _shard_slice(sel.rows, 0, n_shards)
        cols = _shard_slice(sel.cols, 0, n_shards)
        valid = _shard_slice(sel.valid, 0, n_shards)
        pts = _shard_slice(points, 0, n_shards)
        out.append(td_mod.build_from_selection(
            ch, cams[level], p, rows, cols, valid, sel.num_valid, pts, s, c))
    return tuple(out)


def _round_capacities(capacities, n_shards):
    """Round each level's capacity DOWN to a multiple of the mesh size (up
    would overflow jax.lax.top_k when capacity is pinned at rows*cols on tiny
    coarse levels).  For production shapes capacities are powers of two, so
    this is a no-op and the sharded selection matches single-device exactly."""
    return tuple(max(cap // n_shards, 1) * n_shards for cap in capacities)


def make_sharded_vo(mesh: Mesh, K, baseline: float, image_size,
                    p: AlgorithmParameters):
    """Build the distributed VO: (init_fn, step_fn, scan_fn), all jitted over
    ``mesh``.

      init_fn(image, disparity) -> VOState          (templates point-sharded)
      step_fn(state, image, disparity) -> (VOState, VOStepOutput)
      scan_fn(state, images, disparities) -> (VOState, stacked VOStepOutput)

    Images/disparities are replicated; only per-point state is sharded.
    Restricted to the GaussNewton pose estimator (the sharded linearization
    hooks gn.run; LM is a single-device option).
    """
    n = mesh.devices.size
    rows, cols = image_size
    if p.numPyramidLevels <= 0:
        p = p.replace(numPyramidLevels=p.num_pyramid_levels_for(rows, cols))
    if p.poseEstimator != "GaussNewton":
        raise ValueError("sharded VO supports poseEstimator=GaussNewton only")
    from bpvo_tpu.ops import selection as selection_mod
    base_cam = warp_mod.CameraModel.from_K(K, baseline)
    cams = tuple(base_cam.at_level(l) for l in range(p.numPyramidLevels))
    shapes = pyramid.level_shapes(rows, cols, p.numPyramidLevels)
    capacities = _round_capacities(
        tuple(selection_mod.capacity_for_level(p, r, c, l)
              for l, (r, c) in enumerate(shapes)), n)
    fine = gn.GNOptions.from_params(p, coarse=False)
    coarse = gn.GNOptions.from_params(p, coarse=True)
    opts = tuple(fine if l == p.maxTestLevel else coarse
                 for l in range(p.numPyramidLevels))

    def linearize_factory(level, tdata, channels, cam, lv_opts):
        def linearize_fn(T, scale, dscale):
            return sharded._linearize_sharded(tdata, channels, cam, T, scale,
                                              dscale, lv_opts)
        return linearize_fn

    def build_templates_fn(channels_pyr, disparity):
        return _build_templates_sharded(channels_pyr, disparity, cams, p,
                                        capacities, n)

    step = device_vo.make_vo_step(
        p, cams, capacities, opts,
        linearize_factory=linearize_factory,
        build_templates_fn=build_templates_fn,
        count_reduce=partial(jax.lax.psum, axis_name=POINT_AXIS))

    state_spec = VOState(
        templates=tuple(template_spec() for _ in range(p.numPyramidLevels)),
        prev_channels=tuple(P() for _ in range(p.numPyramidLevels)),
        prev_disparity=P(), has_prev=P(), T_kf=P(), pose_world=P(),
        T_delta=P(), last_weights=P(None, POINT_AXIS))
    out_spec = VOStepOutput(pose=P(), pose_world=P(), is_keyframe=P(),
                            reason=P(), iters=P(), f_norm=P(), frac_good=P(),
                            H=P())

    def init_body(image, disparity):
        channels = device_vo._compute_channels_pyr(
            jnp.asarray(image, jnp.float32), p, p.numPyramidLevels)
        disparity = jnp.asarray(disparity, jnp.float32)
        templates = build_templates_fn(channels, disparity)
        return VOState(
            templates=templates, prev_channels=channels,
            prev_disparity=disparity, has_prev=jnp.asarray(False),
            T_kf=jnp.eye(4, dtype=jnp.float32),
            pose_world=jnp.eye(4, dtype=jnp.float32),
            T_delta=jnp.eye(4, dtype=jnp.float32),
            last_weights=jnp.ones_like(templates[p.maxTestLevel].pixels))

    def scan_body(state, images, disparities):
        return jax.lax.scan(lambda s, xs: step(s, xs[0], xs[1]), state,
                            (images, disparities))

    init_fn = jax.jit(jax.shard_map(
        init_body, mesh=mesh, in_specs=(P(), P()), out_specs=state_spec,
        check_vma=False))
    step_fn = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(state_spec, P(), P()),
        out_specs=(state_spec, out_spec), check_vma=False))
    scan_fn = jax.jit(jax.shard_map(
        scan_body, mesh=mesh, in_specs=(state_spec, P(), P()),
        out_specs=(state_spec, out_spec), check_vma=False))
    return init_fn, step_fn, scan_fn
