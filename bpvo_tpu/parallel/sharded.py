"""Distributed IRLS Gauss-Newton: template points sharded across a device mesh.

This layer has NO reference analogue — halismai/bpvo is single-process
(SURVEY.md §2.4).  Its TBB ``parallel_reduce`` join over the H/G accumulation
(reference linear_system_builder.cc:91-131) is mathematically an all-reduce;
here the same reduction runs across devices as ``jax.lax.psum`` inside
``jax.shard_map`` over a 1-D ``points`` mesh axis:

  - template points / pixels / Jacobians: sharded along the point axis
  - current-frame descriptor channels: replicated (each shard gathers its own
    warped samples locally — no halo exchange needed because the gather is
    random-access into the whole image)
  - per-iteration collectives: one fused psum of (histogram, H, g, f_sq,
    n_good) — a few KB per step
  - the 6x6 solve and pose update are tiny and replicated on every device

The robust scale (median of |r|) is the one globally-coupled statistic; it uses
the histogram median (bpvo_tpu/solver/mestimator.py) whose bincounts psum
exactly, so the distributed sigma equals the single-device sigma bit-for-bit
up to float addition order.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bpvo_tpu.solver import gauss_newton as gn
from bpvo_tpu.solver import linear_system, mestimator
from bpvo_tpu.vo import template_data as td_mod
from bpvo_tpu.vo.template_data import TemplateData

POINT_AXIS = "points"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), (POINT_AXIS,), devices=devs[:n])


def template_spec() -> TemplateData:
    """PartitionSpec pytree for TemplateData: point-axis sharded, scalars
    replicated."""
    return TemplateData(
        points=P(POINT_AXIS), pixels=P(None, POINT_AXIS),
        jacobians=P(None, POINT_AXIS), valid=P(POINT_AXIS),
        num_valid=P(), norm_scale=P(), norm_center=P(),
        rows=P(POINT_AXIS), cols=P(POINT_AXIS))


def shard_template(tdata: TemplateData, mesh: Mesh) -> TemplateData:
    """Place a template on the mesh with the point axis sharded.  The capacity
    is padded up to a multiple of the mesh size (padding slots are invalid)."""
    n = mesh.devices.size
    K = tdata.capacity
    pad = (-K) % n
    if pad:
        def pad_pts(x, axis):
            widths = [(0, 0)] * x.ndim
            widths[axis] = (0, pad)
            return jnp.pad(x, widths)
        tdata = TemplateData(
            points=pad_pts(tdata.points, 0).at[K:, 2].set(1.0),
            pixels=pad_pts(tdata.pixels, 1),
            jacobians=pad_pts(tdata.jacobians, 1),
            valid=pad_pts(tdata.valid, 0),
            num_valid=tdata.num_valid,
            norm_scale=tdata.norm_scale, norm_center=tdata.norm_center,
            rows=pad_pts(tdata.rows, 0), cols=pad_pts(tdata.cols, 0))
    specs = template_spec()
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tdata, specs)


def _linearize_sharded(tdata, channels, cam, T, scale, delta_scale,
                       opts: gn.GNOptions):
    """Per-shard linearization + one fused global reduction.

    Executes inside shard_map: ``tdata`` holds this device's point shard,
    ``channels`` the full (replicated) image.
    """
    r, valid = td_mod.compute_residuals(tdata, channels, cam, T, opts.interp)

    # --- global robust scale via psum'd histogram counts --------------------
    r0 = jnp.abs(r[0])
    local_max = jnp.max(jnp.where(valid, r0, 0.0))
    hi = jnp.maximum(jax.lax.pmax(local_max, POINT_AXIS), 1e-12)
    bins = 1024
    csum = mestimator.histogram_counts(r0, valid, hi, bins)
    csum = jax.lax.psum(csum, POINT_AXIS)
    n = csum[-1]
    med = hi * jnp.argmax(csum >= (n + 1) // 2).astype(r0.dtype) / bins
    med = jnp.where(n > 0, med, 0.0)
    nf = n.astype(r0.dtype)
    new_sigma = 1.4826 * (1.0 + 5.0 / jnp.maximum(nf - 6.0, 1.0)) * med
    new_sigma = jnp.where(new_sigma < 1e-6, 1.0, new_sigma)

    do_est = delta_scale > opts.scale_tolerance
    sigma = jnp.where(do_est, new_sigma, scale)
    new_delta = jnp.where(do_est, jnp.abs(new_sigma - scale), delta_scale)

    w = mestimator.compute_weights(opts.loss, r, valid[None, :], sigma)
    H, g, f_sq = linear_system.build(tdata.jacobians, r, w)
    H, g, f_sq = jax.lax.psum((H, g, f_sq), POINT_AXIS)
    return H, g, jnp.sqrt(f_sq), sigma, new_delta, w


def _gn_sharded_body(tdata, channels, cam, T_init, opts: gn.GNOptions):
    """The full GN while-loop, executed per-shard: gauss_newton.run with the
    psum-reducing linearization injected."""
    def linearize_fn(T, scale, dscale):
        return _linearize_sharded(tdata, channels, cam, T, scale, dscale, opts)

    return gn.run(tdata, channels, cam, T_init, opts, linearize_fn=linearize_fn)


def make_sharded_gn(mesh: Mesh, opts: gn.GNOptions):
    """Build the jitted distributed GN runner for a given mesh + options.

    Returns run(tdata_sharded, channels, cam, T_init) -> GNState with weights
    left sharded along the point axis and everything else replicated.
    """
    out_state_spec = gn.GNState(
        T=P(), dp=P(), f_norm=P(), f_norm_prev=P(), dp_norm_prev=P(),
        g=P(), g_tol=P(), scale=P(), delta_scale=P(),
        weights=P(None, POINT_AXIS), H=P(),
        num_iters=P(), status=P(), converged=P(), solver_ok=P(),
        T_best=P(), f_best=P())

    fn = jax.shard_map(
        partial(_gn_sharded_body, opts=opts),
        mesh=mesh,
        in_specs=(template_spec(), P(), P(), P()),
        out_specs=out_state_spec,
        check_vma=False)
    return jax.jit(fn)
