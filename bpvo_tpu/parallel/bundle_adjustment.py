"""Windowed photometric bundle adjustment over a keyframe window, with the
residual/block reductions shardable across a device mesh.

No reference analogue: halismai/bpvo tracks frame-to-keyframe only and
accumulates a trajectory (vo.cc:191, trajectory.cc:42-50).  This module adds
joint refinement of the last M keyframe poses — the capability BASELINE.json
names as the distributed extension — using the same semi-dense machinery:

  - each keyframe i carries its finest-level template (points X_i, pixel values
    I_i, precomputed inverse-compositional Jacobians J_i in its own normalized
    tangent frame — template_data.py);
  - for each co-visibility edge (i, j), the photometric residual
        r_ij = I_j( pi( T_j T_i^{-1} X_i ) ) - I_i(X_i)
    has, to first order in the per-keyframe right-increments
    T_k <- T_k exp(d_k), the Jacobian  J_i . A_i (d_j - d_i)  where
    A_i = Ad_{Tn_i T_i} maps global increments into keyframe i's normalized
    template tangent — so BA reuses the per-keyframe precomputed Jacobians
    with ONE 6x6 transform per edge (cf. the proxy-template idea in
    PAPERS.md: "Proxy Templates for Inverse Compositional Photometric BA");
  - normal equations assemble into an (M,6)x(M,6) block system (pose-only:
    stereo depths stay fixed, so there is no landmark block to Schur-eliminate;
    the point dimension is the one that shards);
  - gauge freedom is fixed by a strong prior on keyframe 0.

Distribution: template points shard across the mesh point axis exactly like
the frame-to-frame solver (bpvo_tpu/parallel/sharded.py); every device
processes all edges over its point shard and one ``psum`` of the (M,M,6,6)
block Hessian + (M,6) gradient + scale histogram per iteration crosses the mesh.
"""
from __future__ import annotations


from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from bpvo_tpu.core import se3
from bpvo_tpu.solver import mestimator
from bpvo_tpu.types import InterpolationType, LossFunctionType
from bpvo_tpu.vo import template_data as td_mod
from bpvo_tpu.vo import warp as warp_mod
from bpvo_tpu.vo.template_data import TemplateData


class BAOptions(NamedTuple):
    max_iterations: int = 10
    loss: str = "Tukey"
    interp: InterpolationType = InterpolationType.LINEAR
    gauge_prior: float = 1e6     # prior weight pinning keyframe 0
    damping: float = 1e-4        # Levenberg damping on the block diagonal
    edge_radius: int = 1         # connect keyframes within this window distance
    refine_depth: bool = False   # joint pose + inverse-depth with Schur elim.
    # depth regularization, both relative to the mean photometric depth
    # information: damping on the step + an absolute prior anchored to the
    # stereo-measured inverse depth (tiny inter-keyframe baselines make raw
    # photometric depth weakly observable)
    depth_damping: float = 0.1
    depth_prior: float = 0.3


def window_edges(n_keyframes: int, radius: int) -> Tuple[Tuple[int, int], ...]:
    """Static co-visibility edges: ordered pairs (i, j), 0 < |i-j| <= radius."""
    edges = []
    for i in range(n_keyframes):
        for j in range(n_keyframes):
            if i != j and abs(i - j) <= radius:
                edges.append((i, j))
    return tuple(edges)


def adjoint_similarity(G, scale):
    """6x6 adjoint of the similarity G = [s R | t; 0 1] on twists (w, v):
    Ad = [[R, 0], [[t]x R, s R]], so that G exp(xi) G^{-1} = exp(Ad xi)."""
    R = G[:3, :3] / scale
    t = G[:3, 3]
    tx = se3.hat(t)
    top = jnp.concatenate([R, jnp.zeros((3, 3), G.dtype)], axis=1)
    bot = jnp.concatenate([tx @ R, scale * R], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _assemble(templates: TemplateData, channels, cam, poses,
              edges, opts: BAOptions, axis_name=None):
    """Assemble the block system over all edges with ONE residual evaluation
    per edge: residuals are computed first, the global robust sigma derived
    from them (psum'd histogram when sharded), then the same residuals are
    weighted and reduced into the blocks.

    ``templates``: TemplateData with a leading window axis (M, ...).
    ``channels``: (M, C, H, W).  ``poses``: (M, 4, 4).
    Returns (H (M,6,M,6), g (M,6), f_sq).
    """
    M = poses.shape[0]
    loss = (LossFunctionType.TUKEY if opts.loss == "Tukey"
            else LossFunctionType.HUBER)

    # pass 1: residuals for every edge
    edge_data = []
    for (i, j) in edges:
        td_i = jax.tree.map(lambda x: x[i], templates)
        T_rel = poses[j] @ se3.inverse(poses[i])
        r, valid = td_mod.compute_residuals(td_i, channels[j], cam, T_rel,
                                            opts.interp)
        edge_data.append((td_i, r, valid))

    sigma = _global_sigma(
        jnp.concatenate([jnp.abs(r[0]) for (_, r, _) in edge_data]),
        jnp.concatenate([v for (_, _, v) in edge_data]), axis_name)

    # pass 2: weight + reduce (cheap einsums over the cached residuals)
    H = jnp.zeros((M, 6, M, 6), jnp.float32)
    g = jnp.zeros((M, 6), jnp.float32)
    f_sq = jnp.asarray(0.0, jnp.float32)
    for (i, j), (td_i, r, valid) in zip(edges, edge_data):
        w = mestimator.compute_weights(loss, r, valid[None, :], sigma)
        Jf = td_i.jacobians.reshape(-1, 6)
        rf = r.reshape(-1)
        wf = w.reshape(-1)
        Jw = Jf * wf[:, None]
        S = jnp.dot(Jw.T, Jf, preferred_element_type=jnp.float32)
        b = jnp.dot(Jw.T, rf, preferred_element_type=jnp.float32)
        G = warp_mod.normalization_matrix(td_i.norm_scale,
                                          td_i.norm_center) @ poses[i]
        A = adjoint_similarity(G, td_i.norm_scale)
        B = A.T @ S @ A          # block in global-increment space
        be = A.T @ b
        H = H.at[j, :, j, :].add(B)
        H = H.at[i, :, i, :].add(B)
        H = H.at[i, :, j, :].add(-B)
        H = H.at[j, :, i, :].add(-B)
        g = g.at[j].add(be)
        g = g.at[i].add(-be)
        f_sq = f_sq + jnp.sum(wf * rf * rf)

    if axis_name is not None:
        H, g, f_sq = jax.lax.psum((H, g, f_sq), axis_name)
    return H, g, f_sq


def _global_sigma(abs_r, valid, axis_name=None, bins: int = 1024):
    """Robust sigma from |r| samples; psum'd histogram counts when sharded."""
    local_max = jnp.max(jnp.where(valid, abs_r, 0.0))
    if axis_name is not None:
        hi = jnp.maximum(jax.lax.pmax(local_max, axis_name), 1e-12)
    else:
        hi = jnp.maximum(local_max, 1e-12)
    csum = mestimator.histogram_counts(abs_r, valid, hi, bins)
    if axis_name is not None:
        csum = jax.lax.psum(csum, axis_name)
    n = csum[-1]
    med = hi * jnp.argmax(csum >= (n + 1) // 2).astype(jnp.float32) / bins
    nf = n.astype(jnp.float32)
    sigma = 1.4826 * (1.0 + 5.0 / jnp.maximum(nf - 6.0, 1.0)) * med
    return jnp.where(sigma < 1e-6, 1.0, sigma)


def _solve_pose_system(H, g, opts: BAOptions):
    """Gauge-fixed, damped solve of the (M,6)x(M,6) pose block system."""
    M = g.shape[0]
    eye6 = jnp.eye(6, dtype=jnp.float32)
    H = H.at[0, :, 0, :].add(opts.gauge_prior * eye6)
    Hm = H.reshape(M * 6, M * 6)
    Hm = Hm + opts.damping * jnp.diag(jnp.diag(Hm)) + 1e-6 * jnp.eye(
        M * 6, dtype=jnp.float32)
    delta = -jnp.linalg.solve(Hm, g.reshape(M * 6)).reshape(M, 6)
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
    return delta.at[0].set(0.0)  # hard gauge fix on keyframe 0


def ba_solve(templates: TemplateData, channels, cam: warp_mod.CameraModel,
             poses_init, opts: BAOptions, axis_name=None):
    """Run windowed BA; returns (poses (M,4,4), final weighted cost).

    ``templates`` stacked with leading window axis M (vmap-style); pass the
    point axis pre-sharded and ``axis_name`` set when running under shard_map.
    With ``opts.refine_depth`` the structure map is delegated to
    ``ba_solve_with_depth`` (full Schur complement over inverse depths).
    """
    if opts.refine_depth:
        poses, templates_out, cost = ba_solve_with_depth(
            templates, channels, cam, poses_init, opts, axis_name)
        return poses, cost

    M = poses_init.shape[0]
    edges = window_edges(M, opts.edge_radius)

    def iteration(carry, _):
        poses, _prev_cost = carry
        H, g, f_sq = _assemble(templates, channels, cam, poses, edges, opts,
                               axis_name)
        delta = _solve_pose_system(H, g, opts)
        new_poses = jnp.einsum("mij,mjk->mik", poses, se3.exp(delta))
        return (new_poses, f_sq), f_sq

    (poses, cost), _ = jax.lax.scan(
        iteration, (jnp.asarray(poses_init, jnp.float32),
                    jnp.asarray(jnp.inf, jnp.float32)),
        None, length=opts.max_iterations)
    return poses, cost


def ba_solve_with_depth(templates: TemplateData, channels,
                        cam: warp_mod.CameraModel, poses_init,
                        opts: BAOptions, axis_name=None):
    """Joint pose + inverse-depth windowed BA with per-point Schur elimination.

    The landmark block is diagonal (one inverse depth per template point, the
    stereo prior fixing the initial value), so the Schur complement
        Hpp' = Hpp - Hpd Hdd^{-1} Hpd^T
    reduces to per-keyframe einsums over the (sharded) point axis — the
    structure MegBA/Distributed-BA exploit at scale (PAPERS.md), here in its
    photometric inverse-compositional form:

      dr/drho_ik = -s_i Z_ik * (J_i^{v} . X_ik)      (IC chain rule; J_i^{v}
                    is the translation block of the precomputed Jacobian)

    Returns (poses (M,4,4), refined templates, final cost).
    """
    M = poses_init.shape[0]
    edges = window_edges(M, opts.edge_radius)
    loss = (LossFunctionType.TUKEY if opts.loss == "Tukey"
            else LossFunctionType.HUBER)
    K = templates.points.shape[-2]

    # neighbor sets: for keyframe i, the pose blocks its depths couple to
    neighbors = [[j for (ii, j) in edges if ii == i] for i in range(M)]

    def iteration(carry, _):
        poses, points, _prev = carry
        tds = templates._replace(points=points)

        # ---- pass 1: residuals per edge ---------------------------------
        edge_data = []
        for (i, j) in edges:
            td_i = jax.tree.map(lambda x: x[i], tds)
            T_rel = poses[j] @ se3.inverse(poses[i])
            r, valid = td_mod.compute_residuals(td_i, channels[j], cam, T_rel,
                                                opts.interp)
            edge_data.append((td_i, r, valid))
        sigma = _global_sigma(
            jnp.concatenate([jnp.abs(r[0]) for (_, r, _) in edge_data]),
            jnp.concatenate([v for (_, _, v) in edge_data]), axis_name)

        Z = tds.points[..., 2]                           # (M, K)

        # ---- pass 2: assemble blocks ------------------------------------
        Hpp = jnp.zeros((M, 6, M, 6), jnp.float32)
        gp = jnp.zeros((M, 6), jnp.float32)
        Hdd = jnp.zeros((M, K), jnp.float32)
        gd = jnp.zeros((M, K), jnp.float32)
        # m[i][j] (K, 6): coupling of keyframe i's depths to pose block j
        m_rows = [{} for _ in range(M)]
        f_sq = jnp.asarray(0.0, jnp.float32)

        A_cache = []
        for i in range(M):
            td_i = jax.tree.map(lambda x: x[i], tds)
            G = warp_mod.normalization_matrix(td_i.norm_scale,
                                              td_i.norm_center) @ poses[i]
            A_cache.append(adjoint_similarity(G, td_i.norm_scale))

        for (i, j), (td_i, r, valid) in zip(edges, edge_data):
            w = mestimator.compute_weights(loss, r, valid[None, :], sigma)
            A = A_cache[i]
            JA = jnp.einsum("ckp,pq->ckq", td_i.jacobians, A)  # (C,K,6)
            # ---- depth derivative THROUGH the edge's relative pose -------
            # Scaling a point along its viewing ray leaves its identity-pose
            # projection fixed; depth is observable only via the edge's
            # translation (parallax):
            #   u'(rho) = pi(R dir + rho t)  =>
            #   dr/drho = [a (t_x Xz' - Xx' t_z) + b (t_y Xz' - Xy' t_z)]
            #             * Z / Xz'^2
            # with a = gx fx, b = gy fy recovered from the stored Jacobian's
            # translation block (J_v = (a/Z, b/Z, .)/s).
            T_rel = poses[j] @ se3.inverse(poses[i])
            Xp = td_i.points @ T_rel[:3, :3].T + T_rel[:3, 3]   # (K, 3)
            t = T_rel[:3, 3]
            s_i = td_i.norm_scale
            Zi = td_i.points[:, 2]
            a = td_i.jacobians[..., 3] * s_i * Zi[None, :]      # (C, K)
            b = td_i.jacobians[..., 4] * s_i * Zi[None, :]
            Xpz = jnp.maximum(Xp[:, 2], 1e-6)
            num = (a * (t[0] * Xp[:, 2] - Xp[:, 0] * t[2])[None, :]
                   + b * (t[1] * Xp[:, 2] - Xp[:, 1] * t[2])[None, :])
            d = num * (Zi / (Xpz * Xpz))[None, :]               # (C, K)
            # pose blocks
            S = jnp.einsum("ckp,ck,ckq->pq", JA, w, JA)
            b = jnp.einsum("ckp,ck,ck->p", JA, w, r)
            Hpp = Hpp.at[j, :, j, :].add(S).at[i, :, i, :].add(S)
            Hpp = Hpp.at[i, :, j, :].add(-S).at[j, :, i, :].add(-S)
            gp = gp.at[j].add(b).at[i].add(-b)
            # depth couplings
            m = jnp.einsum("ckp,ck,ck->kp", JA, w, d)           # (K, 6)
            m_rows[i][j] = m_rows[i].get(j, 0.0) + m
            m_rows[i][i] = m_rows[i].get(i, 0.0) - m
            Hdd = Hdd.at[i].add(jnp.einsum("ck,ck->k", w, d * d))
            gd = gd.at[i].add(jnp.einsum("ck,ck,ck->k", w, r, d))
            f_sq = f_sq + jnp.sum(w * r * r)

        if axis_name is not None:
            Hpp, gp, f_sq = jax.lax.psum((Hpp, gp, f_sq), axis_name)
        # NOTE: Hdd/gd/m stay sharded along K — the Schur reduction below
        # psums the (6,6)/(6,) contractions, never the per-point arrays.

        # stereo prior + relative damping on the depth diagonal
        vmask = templates.valid.astype(jnp.float32)            # (M, K)
        n_val = jnp.sum(vmask)
        h_sum = jnp.sum(Hdd * vmask)
        if axis_name is not None:
            n_val, h_sum = jax.lax.psum((n_val, h_sum), axis_name)
        h_mean = h_sum / jnp.maximum(n_val, 1.0)
        wp = opts.depth_prior * h_mean
        rho = 1.0 / jnp.maximum(Z, 1e-6)
        rho0 = 1.0 / jnp.maximum(templates.points[..., 2], 1e-6)
        gd = gd + wp * (rho - rho0)
        Hdd = Hdd + wp + opts.depth_damping * h_mean

        # ---- Schur complement over depths -------------------------------
        inv_h = 1.0 / jnp.maximum(Hdd, 1e-12)                   # (M, K)
        for i in range(M):
            blocks = list(m_rows[i].keys())
            for a in blocks:
                Ra = m_rows[i][a]
                corr_g = jnp.einsum("kp,k->p", Ra, inv_h[i] * gd[i])
                if axis_name is not None:
                    corr_g = jax.lax.psum(corr_g, axis_name)
                gp = gp.at[a].add(-corr_g)
                for bkey in blocks:
                    Rb = m_rows[i][bkey]
                    corr = jnp.einsum("kp,k,kq->pq", Ra, inv_h[i], Rb)
                    if axis_name is not None:
                        corr = jax.lax.psum(corr, axis_name)
                    Hpp = Hpp.at[a, :, bkey, :].add(-corr)

        delta = _solve_pose_system(Hpp, gp, opts)

        # ---- depth back-substitution ------------------------------------
        new_points = points
        for i in range(M):
            coupling = jnp.zeros((K,), jnp.float32)
            for a, Ra in m_rows[i].items():
                coupling = coupling + Ra @ delta[a]
            drho = -inv_h[i] * (gd[i] + coupling)
            # X <- X / (1 + Z * drho), clamped to prevent depth sign flips
            scale = jnp.clip(1.0 + Z[i] * drho, 0.8, 1.25)
            new_points = new_points.at[i].set(
                points[i] / scale[:, None])

        new_poses = jnp.einsum("mij,mjk->mik", poses, se3.exp(delta))
        return (new_poses, new_points, f_sq), f_sq

    (poses, points, cost), _ = jax.lax.scan(
        iteration,
        (jnp.asarray(poses_init, jnp.float32), templates.points,
         jnp.asarray(jnp.inf, jnp.float32)),
        None, length=opts.max_iterations)
    return poses, templates._replace(points=points), cost


def make_sharded_ba(mesh, opts: BAOptions, m_keyframes: int):
    """Distributed BA runner: window templates sharded along the point axis,
    channels/poses replicated, block system psum'd each iteration."""
    from bpvo_tpu.parallel import sharded

    tmpl_spec = jax.tree.map(
        lambda s: P(*((None,) + tuple(s))), sharded.template_spec())

    def body(templates, channels, cam, poses):
        return ba_solve(templates, channels, cam, poses, opts,
                        axis_name=sharded.POINT_AXIS)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(tmpl_spec, P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    return jax.jit(fn)


def _assemble_kf_sharded(templates_loc: TemplateData, channels, cam, poses,
                         opts: BAOptions, m_global: int,
                         kf_axis: str, point_axis: str):
    """Edge assembly with the keyframe window axis sharded across ``kf_axis``.

    ``templates_loc`` holds this shard's (M/kf, ...) keyframes (points also
    sharded along ``point_axis``); ``channels``/``poses`` are replicated.
    Each shard processes the outgoing edges of ITS keyframes — the neighbor
    index j is dynamic (depends on the shard's position), so channel frames
    are fetched with a dynamic index and out-of-window edges are masked
    rather than skipped.  One psum over BOTH axes makes H/g/σ global.
    """
    m_loc = templates_loc.points.shape[0]
    loss = (LossFunctionType.TUKEY if opts.loss == "Tukey"
            else LossFunctionType.HUBER)
    kf_idx = jax.lax.axis_index(kf_axis)
    axes = (kf_axis, point_axis)

    # pass 1: residuals for every (local i, offset) edge
    edge_data = []
    for i_loc in range(m_loc):
        i_glob = kf_idx * m_loc + i_loc
        td_i = jax.tree.map(lambda x: x[i_loc], templates_loc)
        pose_i = jax.lax.dynamic_index_in_dim(poses, i_glob, 0,
                                              keepdims=False)
        for off in range(-opts.edge_radius, opts.edge_radius + 1):
            if off == 0:
                continue
            j = i_glob + off
            edge_ok = (j >= 0) & (j < m_global)
            jc = jnp.clip(j, 0, m_global - 1)
            pose_j = jax.lax.dynamic_index_in_dim(poses, jc, 0,
                                                  keepdims=False)
            ch_j = jax.lax.dynamic_index_in_dim(channels, jc, 0,
                                                keepdims=False)
            T_rel = pose_j @ se3.inverse(pose_i)
            r, valid = td_mod.compute_residuals(td_i, ch_j, cam, T_rel,
                                                opts.interp)
            valid = valid & edge_ok
            r = r * valid[None, :]
            edge_data.append((i_glob, jc, td_i, pose_i, r, valid))

    sigma = _global_sigma(
        jnp.concatenate([jnp.abs(r[0]) for (*_, r, _) in edge_data]),
        jnp.concatenate([v for (*_, v) in edge_data]), axes)

    # pass 2: weight + reduce into dynamically-indexed blocks
    H = jnp.zeros((m_global, 6, m_global, 6), jnp.float32)
    g = jnp.zeros((m_global, 6), jnp.float32)
    f_sq = jnp.asarray(0.0, jnp.float32)
    for (i_glob, jc, td_i, pose_i, r, valid) in edge_data:
        w = mestimator.compute_weights(loss, r, valid[None, :], sigma)
        Jf = td_i.jacobians.reshape(-1, 6)
        rf = r.reshape(-1)
        wf = w.reshape(-1)
        Jw = Jf * wf[:, None]
        S = jnp.dot(Jw.T, Jf, preferred_element_type=jnp.float32)
        b = jnp.dot(Jw.T, rf, preferred_element_type=jnp.float32)
        G = warp_mod.normalization_matrix(td_i.norm_scale,
                                          td_i.norm_center) @ pose_i
        A = adjoint_similarity(G, td_i.norm_scale)
        B = A.T @ S @ A
        be = A.T @ b
        # dynamic scatter-add into the block system (i_glob/jc are traced)
        H = H.at[jc, :, jc, :].add(B)
        H = H.at[i_glob, :, i_glob, :].add(B)
        H = H.at[i_glob, :, jc, :].add(-B)
        H = H.at[jc, :, i_glob, :].add(-B)
        g = g.at[jc].add(be)
        g = g.at[i_glob].add(-be)
        f_sq = f_sq + jnp.sum(wf * rf * rf)

    H, g, f_sq = jax.lax.psum((H, g, f_sq), axes)
    return H, g, f_sq


def make_sharded_ba_2d(mesh, opts: BAOptions, m_keyframes: int):
    """Distributed BA on a 2-D (kf, points) mesh: the keyframe-window axis is
    a REAL mesh axis (multihost.global_mesh's cross-host placement), templates
    sharded (kf, points), channels/poses replicated, block system psum'd over
    both axes each iteration.  Matches ``ba_solve`` (pose-only) numerically.
    """
    from bpvo_tpu.parallel import sharded
    from bpvo_tpu.parallel.multihost import KEYFRAME_AXIS

    kf_size = mesh.shape[KEYFRAME_AXIS]
    assert m_keyframes % kf_size == 0, (m_keyframes, kf_size)
    tmpl_spec = jax.tree.map(
        lambda s: P(*((KEYFRAME_AXIS,) + tuple(s))), sharded.template_spec())

    def body(templates_loc, channels, cam, poses):
        def iteration(carry, _):
            poses, _prev = carry
            H, g, f_sq = _assemble_kf_sharded(
                templates_loc, channels, cam, poses, opts, m_keyframes,
                KEYFRAME_AXIS, sharded.POINT_AXIS)
            delta = _solve_pose_system(H, g, opts)
            new_poses = jnp.einsum("mij,mjk->mik", poses, se3.exp(delta))
            return (new_poses, f_sq), f_sq

        (poses, cost), _ = jax.lax.scan(
            iteration, (jnp.asarray(poses, jnp.float32),
                        jnp.asarray(jnp.inf, jnp.float32)),
            None, length=opts.max_iterations)
        return poses, cost

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(tmpl_spec, P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    return jax.jit(fn)


def stack_templates(templates: Sequence[TemplateData]) -> TemplateData:
    """Stack per-keyframe templates (equal capacity) along a window axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *templates)


class KeyframeWindow:
    """Host-side sliding window of keyframes feeding the BA solver
    (the "sharded keyframe store" of BASELINE.json).

    Collects (template, channels, pose) at each keyframe; when full, slides.
    ``optimize()`` runs windowed BA and returns the refined world poses.
    """

    def __init__(self, max_keyframes: int, cam: warp_mod.CameraModel,
                 opts: BAOptions = BAOptions(), mesh=None):
        self._max = max_keyframes
        self._cam = cam
        self._opts = opts
        self._mesh = mesh
        self._templates = []
        self._channels = []
        self._poses = []
        self._runner = None
        self._runner_m = -1

    def __len__(self):
        return len(self._templates)

    def push(self, template: TemplateData, channels, pose_world: np.ndarray):
        """pose_world: camera-from-world warp pose T_i (X_i = T_i X_w)."""
        self._templates.append(template)
        self._channels.append(jnp.asarray(channels))
        self._poses.append(np.asarray(pose_world, np.float32))
        if len(self._templates) > self._max:
            self._templates.pop(0)
            self._channels.pop(0)
            self._poses.pop(0)

    def optimize(self):
        """Run BA over the current window; returns refined (M,4,4) poses."""
        M = len(self._templates)
        if M < 2:
            return np.asarray(self._poses)
        templates = stack_templates(self._templates)
        channels = jnp.stack(self._channels)
        poses = jnp.asarray(np.stack(self._poses))
        if self._mesh is not None:
            from bpvo_tpu.parallel import sharded
            templates = jax.tree.map(
                lambda x, s: jax.device_put(
                    x, jax.sharding.NamedSharding(
                        self._mesh, P(*((None,) + tuple(s))))),
                templates, sharded.template_spec())
            if self._runner is None or self._runner_m != M:
                self._runner = make_sharded_ba(self._mesh, self._opts, M)
                self._runner_m = M
            new_poses, cost = self._runner(templates, channels, self._cam,
                                           poses)
        else:
            if self._runner is None or self._runner_m != M:
                cam = self._cam
                self._runner = jax.jit(
                    lambda t, c, p: ba_solve(t, c, cam, p, self._opts)[:2])
                self._runner_m = M
            new_poses, cost = self._runner(templates, channels, poses)
        new_np = np.asarray(new_poses)
        self._poses = [new_np[i] for i in range(M)]
        return new_np
