"""Run the visual-odometry main path once on the GPU and check what it returns.

    python chip_smoke.py               # one GPU: phases 1-7 below
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

Single card, all in this one process (the CPU reference runs here too, on
``jax.devices("cpu")[0]``):

  1. device     the GPU, its nvidia-smi name and power limit, JAX set-up
  2. compile    DeviceVO's scan step at 376x1241, Intensity and BitPlanes:
                compile seconds and ``memory_analysis()``
  3. scan       init + 2 chunks of 20 frames of the synthetic KITTI-shape
                sequence, against the exact ground truth and the CPU run
  4. online     ``DeviceVO.add_frame`` over 10 frames equals scan mode
  5. host api   ``VisualOdometry.add_frame`` (the README quick start) over
                10 frames agrees with phase 3
  6. stereo     DeviceVO with the SGM matcher inside the keyframe branch;
                SGM disparity against the CPU ``_sgm`` on the same pair
  7. layers     one L0 Gauss-Newton level and the SGM 4-direction
                aggregation, timed on the card

``--four-cards`` runs the point-sharded VO over a 4-GPU mesh against
single-device DeviceVO, and the point-sharded windowed BA against
single-device BA, and nothing else.

Each phase prints one line of findings.  A failing phase raises, so the
script exits non-zero and prints no result; otherwise the last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The phase functions take the device to run on, so the tests run them on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

ROWS, COLS = 376, 1241
CHUNK, N_CHUNKS = 20, 2
N_ONLINE = 10
DESCRIPTORS = ("Intensity", "BitPlanes")
# per-frame translation error against the exact ground truth (m), and the
# largest |pose_world| entry difference from the CPU run of the same frames.
# TF32 would keep ~3 digits; these bounds sit well below what it does to the
# trajectory and well above the float32 reassociation seen between backends.
TOL = {"Intensity": {"gt_trans": 5e-4, "vs_cpu": 1e-3},
       "BitPlanes": {"gt_trans": 1e-2, "vs_cpu": 5e-3}}
KF_SLACK = 1            # keyframe count, GPU vs CPU
ITER_RTOL = 0.2         # mean GN iterations per frame, GPU vs CPU
# online vs scan pose_world: the same step compiled twice (alone and inside
# lax.scan), so only rounding differs; BitPlanes' flatter optimum (its
# per-frame error against the truth is ~4e-3 m) lets that rounding move the
# converged pose by a few 1e-4 (2.5e-4 measured on the CPU)
ONLINE_TOL = {"Intensity": 1e-4, "BitPlanes": 1e-3}
SGM_D = 128
SGM_MEDIAN_TOL = 0.05   # px, median |GPU - CPU| SGM disparity
SHARDED_TOL = 1e-3      # sharded vs single-device pose_world / BA poses


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cpu_device():
    return jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_sequence(n_frames: int, rows: int = ROWS, cols: int = COLS):
    """(K, baseline, images (N,H,W), disparities (N,H,W)) of the bench's
    synthetic KITTI-shape sequence; frame i is seen from true_step()**i."""
    import bench
    K, baseline, frames = bench.synthesize_sequence(n_frames, rows, cols)
    images = np.stack([f[0] for f in frames]).astype(np.float32)
    disps = np.stack([f[1] for f in frames]).astype(np.float32)
    return K, baseline, images, disps


def params_for(desc: str, **overrides):
    import bench
    p = bench._make_params(desc)
    return p.replace(**overrides) if overrides else p


def true_step():
    import bench
    return bench.true_step()


# ---------------------------------------------------------------------------
# the VO runs (each on a given device)
# ---------------------------------------------------------------------------

def run_scan(desc, K, baseline, images, disps, device, chunk=CHUNK,
             params=None):
    """DeviceVO in scan mode on ``device``: init on frame 0, then chunks of
    ``chunk`` frames.  Returns numpy per-step outputs."""
    from bpvo_tpu.vo.device_vo import DeviceVO
    p = params or params_for(desc)
    with jax.default_device(device):
        vo = DeviceVO(K, baseline, images.shape[1:], p)
        vo.init(images[0], disps[0])
        outs = [vo.add_frames(images[lo:lo + chunk], disps[lo:lo + chunk])
                for lo in range(1, len(images), chunk)]
        outs = jax.device_get(outs)
    return {k: np.concatenate([np.asarray(getattr(o, k)) for o in outs])
            for k in ("pose", "pose_world", "is_keyframe", "iters")}


def run_online(desc, K, baseline, images, disps, device, n=N_ONLINE):
    """DeviceVO.add_frame, one dispatch per frame, over frames 1..n."""
    from bpvo_tpu.vo.device_vo import DeviceVO
    with jax.default_device(device):
        vo = DeviceVO(K, baseline, images.shape[1:], params_for(desc))
        vo.add_frame(images[0], disps[0])
        poses = [vo.add_frame(images[i], disps[i]).pose_world
                 for i in range(1, n + 1)]
        return np.stack(jax.device_get(poses))


def run_host(desc, K, baseline, images, disps, device, n=N_ONLINE):
    """The README quick start: VisualOdometry.add_frame over frames 0..n;
    returns the relative poses of frames 1..n and their keyframe flags."""
    from bpvo_tpu import VisualOdometry
    with jax.default_device(device):
        vo = VisualOdometry(K, baseline, images.shape[1:], params_for(desc))
        results = [vo.add_frame(images[i], disps[i]) for i in range(n + 1)]
    return (np.stack([np.asarray(r.pose, np.float64) for r in results[1:]]),
            np.asarray([r.is_keyframe for r in results[1:]]))


def translation_errors(poses):
    """Per-frame |t - t_true| of relative poses against the exact step."""
    step = true_step()
    return np.linalg.norm(np.asarray(poses, np.float64)[:, :3, 3]
                          - step[:3, 3], axis=1)


def mean_iters(run) -> float:
    return float(np.mean(np.sum(run["iters"], axis=1)))


def check_ground_truth(desc, poses, what="scan"):
    err = translation_errors(poses)
    bound = TOL[desc]["gt_trans"]
    if not np.all(np.isfinite(poses)) or err.max() > bound:
        raise AssertionError(f"{desc} {what}: translation error "
                             f"{err.max():.3g} m > {bound:g} m")
    return float(err.max())


def differences(run, ref):
    """A run against the reference run of the same frames: largest
    pose_world entry difference, keyframe counts, mean GN iterations."""
    return {"pose_world_vs_ref": float(np.abs(run["pose_world"]
                                              - ref["pose_world"]).max()),
            "keyframes": int(run["is_keyframe"].sum()),
            "keyframes_ref": int(ref["is_keyframe"].sum()),
            "gn_iters_per_frame": mean_iters(run),
            "gn_iters_per_frame_ref": mean_iters(ref)}


def check_differences(desc, diff):
    if diff["pose_world_vs_ref"] > TOL[desc]["vs_cpu"]:
        raise AssertionError(f"{desc}: pose_world differs from the CPU run "
                             f"by {diff['pose_world_vs_ref']:.3g}")
    if abs(diff["keyframes"] - diff["keyframes_ref"]) > KF_SLACK:
        raise AssertionError(f"{desc}: {diff['keyframes']} keyframes vs "
                             f"{diff['keyframes_ref']} on CPU")
    it, it_ref = diff["gn_iters_per_frame"], diff["gn_iters_per_frame_ref"]
    if abs(it - it_ref) > ITER_RTOL * it_ref:
        raise AssertionError(f"{desc}: {it:.2f} GN iterations/frame vs "
                             f"{it_ref:.2f} on CPU")


def check_online(desc, online_pw, scan):
    n = len(online_pw)
    d = float(np.abs(online_pw - scan["pose_world"][:n]).max())
    if d > ONLINE_TOL[desc]:
        raise AssertionError(f"{desc}: online pose_world differs from scan "
                             f"mode by {d:.3g}")
    return d


def check_host(desc, host_poses, scan):
    """Host API relative poses vs ground truth and vs DeviceVO's."""
    gt = check_ground_truth(desc, host_poses, "host api")
    n = len(host_poses)
    d = float(np.abs(host_poses - scan["pose"][:n]).max())
    if d > TOL[desc]["vs_cpu"]:
        raise AssertionError(f"{desc}: host API poses differ from DeviceVO's "
                             f"by {d:.3g}")
    return gt, d


# ---------------------------------------------------------------------------
# stereo in the loop
# ---------------------------------------------------------------------------

def stereo_pairs(n_frames, rows=ROWS, cols=COLS):
    """Exact left/right pairs of the KITTI-shape value-noise plane scene, as
    SyntheticStereoPlaneDataset renders them before its matcher runs."""
    import bench
    from bpvo_tpu.data.synthetic import SyntheticPlaneDataset
    ds = SyntheticPlaneDataset(
        rows=rows, cols=cols, n_frames=n_frames, fx=bench.FX,
        baseline=bench.STEREO_BASELINE, twist_per_frame=bench.STEP_TWIST,
        texture="noise")
    left = np.stack([ds.get_frame(i).image for i in range(n_frames)])
    right = np.stack([ds.right_image(i) for i in range(n_frames)])
    return ds.calibration.K, bench.STEREO_BASELINE, left, right


def run_stereo(device, ref_device, n_frames=7, num_disparities=SGM_D,
               rows=ROWS, cols=COLS):
    """DeviceVO(stereo_fn=DeviceSGM.as_fn()) over ``n_frames`` pairs, timed
    per step; SGM on frame 0 against ``ref_device``'s run of ``_sgm``."""
    from bpvo_tpu.data.stereo import DeviceSGM
    from bpvo_tpu.vo.device_vo import DeviceVO
    K, baseline, left, right = stereo_pairs(n_frames, rows, cols)
    sgm = DeviceSGM(num_disparities=num_disparities)
    with jax.default_device(ref_device):
        d_ref = sgm.run(left[0], right[0])
    with jax.default_device(device):
        d_dev = sgm.run(left[0], right[0])
        vo = DeviceVO(K, baseline, (rows, cols), params_for("Intensity"),
                      stereo_fn=sgm.as_fn())
        times, kf, poses = [], [], []
        for rep in range(2):     # pass 0 compiles, pass 1 is timed
            vo.init(left[0], right[0])
            for i in range(1, n_frames):
                t0 = time.perf_counter()
                out = jax.block_until_ready(vo.add_frame(left[i], right[i]))
                if rep:
                    times.append((time.perf_counter() - t0) * 1e3)
                    kf.append(bool(out.is_keyframe))
                    poses.append(np.asarray(out.pose))
    med = float(np.median(np.abs(d_dev - d_ref)))
    if med > SGM_MEDIAN_TOL:
        raise AssertionError(f"SGM disparity differs from the reference "
                             f"device's by a median {med:.3g} px")
    if not any(kf):
        raise AssertionError("stereo run crossed no keyframe")
    err = translation_errors(np.stack(poses))
    if not np.all(np.isfinite(err)):
        raise AssertionError("stereo run returned a non-finite pose")
    kf_ms = [t for t, k in zip(times, kf) if k]
    nkf_ms = [t for t, k in zip(times, kf) if not k]
    return {"sgm_median_abs_diff_px": f"{med:.3g}",
            "keyframes": int(sum(kf)), "frames": len(kf),
            "kf_step_ms": f"{np.median(kf_ms):.3f}",
            "non_kf_step_ms": (f"{np.median(nkf_ms):.3f}" if nkf_ms
                               else "none"),
            "max_translation_err_m": f"{err.max():.3g}"}


# ---------------------------------------------------------------------------
# several devices
# ---------------------------------------------------------------------------

def collective_stats(compiled_text: str):
    """Count XLA collectives and their payload bytes in a compiled HLO dump
    (synchronous ops, or the ``-start`` half of asynchronous ones)."""
    dtype_bytes = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "s32": 4,
                   "u32": 4, "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8}
    op_pat = re.compile(
        r"=\s*(.*?)\s(all-reduce|all-gather|reduce-scatter|"
        r"collective-permute|all-to-all)(?:-start)?\(")
    stats = {}
    for line in compiled_text.splitlines():
        m = op_pat.search(line)
        if not m:
            continue
        nbytes = 0
        for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1)):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * dtype_bytes.get(dt, 4)
        ent = stats.setdefault(m.group(2), [0, 0])
        ent[0] += 1
        ent[1] += nbytes
    return {op: {"count": c, "bytes": b} for op, (c, b) in stats.items()}


def sharded_vo_vs_single(n_devices, n_frames=21, chunk=10, params=None,
                         rows=ROWS, cols=COLS):
    """make_sharded_vo over an n-device mesh against single-device DeviceVO
    on the same frames (2+ scan chunks, at least one keyframe).  Returns
    findings, with the collectives of one compiled step and each device's
    bytes in use while the sharded state is alive."""
    from bpvo_tpu.parallel import sharded
    from bpvo_tpu.parallel.sharded_vo import make_sharded_vo
    from bpvo_tpu.vo.device_vo import DeviceVO
    K, baseline, images, disps = make_sequence(n_frames, rows, cols)
    p = params or params_for("Intensity",
                             minTranslationMagToKeyFrame=0.05)
    mesh = sharded.make_mesh(n_devices)
    init_fn, step_fn, scan_fn = make_sharded_vo(mesh, K, baseline,
                                                (rows, cols), p)
    state = init_fn(images[0], disps[0])
    outs = []
    for lo in range(1, n_frames, chunk):
        state, out = scan_fn(state, images[lo:lo + chunk],
                             disps[lo:lo + chunk])
        outs.append(out)
    poses_sh = np.concatenate([np.asarray(o.pose_world) for o in outs])
    kf = int(sum(np.asarray(o.is_keyframe).sum() for o in outs))
    in_use = [(d.memory_stats() or {}).get("bytes_in_use")
              for d in mesh.devices.flat]
    coll = collective_stats(
        step_fn.lower(state, images[0], disps[0]).compile().as_text())
    del state

    vo = DeviceVO(K, baseline, (rows, cols), p)
    vo.init(images[0], disps[0])
    poses_1 = np.concatenate([
        np.asarray(vo.add_frames(images[lo:lo + chunk],
                                 disps[lo:lo + chunk]).pose_world)
        for lo in range(1, n_frames, chunk)])
    err = float(np.abs(poses_sh - poses_1).max())
    if not np.all(np.isfinite(poses_sh)) or err > SHARDED_TOL:
        raise AssertionError(f"sharded VO differs from single-device by "
                             f"{err:.3g}")
    if kf < 1:
        raise AssertionError("sharded run crossed no keyframe")
    return {"frames": n_frames - 1, "chunks": len(outs), "keyframes": kf,
            "pose_vs_single": f"{err:.3g}", "bytes_in_use": in_use,
            "collectives_per_step": coll}


def sharded_ba_vs_single(n_devices, m_keyframes=8, stride=2, capacity=16384,
                         iterations=10, perturbation=1e-3, rows=ROWS,
                         cols=COLS, seed=1):
    """make_sharded_ba over an n-device mesh on a window of ``m_keyframes``
    L0 templates (every ``stride``-th frame), from ground-truth poses
    perturbed by twists of std ``perturbation`` (1e-3 rad moves a KITTI
    pixel by ~0.7 px: inside the single-level basin), against single-device
    ba_solve."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bpvo_tpu.core import se3
    from bpvo_tpu.ops import descriptors
    from bpvo_tpu.parallel import bundle_adjustment as ba
    from bpvo_tpu.parallel import sharded
    from bpvo_tpu.vo import template_data as td_mod
    from bpvo_tpu.vo import warp as warp_mod
    K, baseline, images, disps = make_sequence(
        stride * (m_keyframes - 1) + 1, rows, cols)
    p = params_for("Intensity")
    cam = warp_mod.CameraModel.from_K(K, baseline)
    idx = range(0, len(images), stride)
    chans = [descriptors.compute(jnp.asarray(images[i]), p) for i in idx]
    tds = [td_mod.set_data(ch, jnp.asarray(disps[i]), cam, p, capacity, 0)
           for ch, i in zip(chans, idx)]
    step = true_step()
    gt = [np.linalg.matrix_power(step, i).astype(np.float32) for i in idx]
    r = np.random.default_rng(seed)
    poses0 = [gt[0]] + [
        (np.asarray(se3.exp(jnp.asarray(
            (perturbation * r.standard_normal(6)).astype(np.float32)))) @ T)
        .astype(np.float32) for T in gt[1:]]
    poses0 = jnp.asarray(np.stack(poses0))
    templates = ba.stack_templates(tds)
    channels = jnp.stack(chans)
    opts = ba.BAOptions(max_iterations=iterations)

    mesh = sharded.make_mesh(n_devices)
    t_sh = jax.tree.map(
        lambda x, s: jax.device_put(
            x, NamedSharding(mesh, P(*((None,) + tuple(s))))),
        templates, sharded.template_spec())
    poses_sh, cost_sh = ba.make_sharded_ba(mesh, opts, m_keyframes)(
        t_sh, channels, cam, poses0)
    poses_1, cost_1 = jax.jit(partial(ba.ba_solve, opts=opts))(
        templates, channels, cam, poses0)
    poses_sh, poses_1 = np.asarray(poses_sh), np.asarray(poses_1)

    def err(poses):
        return max(float(np.abs(np.asarray(se3.log(jnp.asarray(
            a @ np.linalg.inv(b), jnp.float32)))).max())
            for a, b in zip(poses, gt))

    d = float(np.abs(poses_sh - poses_1).max())
    e0, e1 = err(np.asarray(poses0)), err(poses_sh)
    if not np.all(np.isfinite(poses_sh)) or d > SHARDED_TOL:
        raise AssertionError(f"sharded BA differs from single-device by "
                             f"{d:.3g}")
    if not e1 < e0:
        raise AssertionError(f"BA did not reduce the pose error "
                             f"({e0:.3g} -> {e1:.3g})")
    return {"keyframes": m_keyframes, "points_per_keyframe": capacity,
            "pose_vs_single": f"{d:.3g}", "pose_err_before": f"{e0:.3g}",
            "pose_err_after": f"{e1:.3g}", "cost": f"{float(cost_sh):.6g}"}


# ---------------------------------------------------------------------------
# card-only phases
# ---------------------------------------------------------------------------

def phase_device(n_needed: int, cache_dir: str):
    from bpvo_tpu.utils import device as devmod
    devmod.require_gpu()
    rec = devmod.device_record()
    if rec["count"] < n_needed:
        raise RuntimeError(f"need {n_needed} GPUs, JAX finds {rec['count']}")
    card = devmod.card_name_and_power_limit()
    log("device", kind=repr(rec["kind"]), count=rec["count"],
        jax=jax.__version__,
        matmul_precision=jax.config.jax_default_matmul_precision,
        compile_cache=cache_dir)
    print(card, flush=True)
    return rec, card


def phase_compile(desc, K, baseline, images, disps):
    from bpvo_tpu.vo.device_vo import DeviceVO
    vo = DeviceVO(K, baseline, images.shape[1:], params_for(desc))
    vo.init(images[0], disps[0])
    xs = (jnp.asarray(images[1:CHUNK + 1]), jnp.asarray(disps[1:CHUNK + 1]))
    t0 = time.perf_counter()
    compiled = vo._scan_jit.lower(vo.state, *xs).compile()
    dt = time.perf_counter() - t0
    m = compiled.memory_analysis()
    log("compile", descriptor=desc, scan_chunk=CHUNK,
        compile_s=f"{dt:.2f}",
        argument_bytes=m.argument_size_in_bytes,
        output_bytes=m.output_size_in_bytes,
        temp_bytes=m.temp_size_in_bytes)
    jax.block_until_ready(vo.state)


def _time_ms(fn, *args, reps=10):
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), out


def phase_layers(K, baseline, images, disps, card):
    """Plain-XLA layer timings that a hand-written kernel would have to
    beat: one L0 GN level (K = pointCapacity) and the SGM aggregation."""
    from bpvo_tpu.data.stereo import _aggregate_4dir_scan
    from bpvo_tpu.ops import descriptors
    from bpvo_tpu.solver import gauss_newton as gn
    from bpvo_tpu.vo import template_data as td_mod
    from bpvo_tpu.vo import warp as warp_mod
    cam = warp_mod.CameraModel.from_K(K, baseline)
    for desc in DESCRIPTORS:
        p = params_for(desc)
        ch0 = descriptors.compute(jnp.asarray(images[0]), p)
        ch1 = descriptors.compute(jnp.asarray(images[1]), p)
        td = td_mod.set_data(ch0, jnp.asarray(disps[0]), cam, p,
                             p.pointCapacity, 0)
        opts = gn.GNOptions.from_params(p, coarse=False)
        run = jax.jit(partial(gn.run, opts=opts))
        ms, st = _time_ms(run, td, ch1, cam, jnp.eye(4, dtype=jnp.float32))
        it = int(st.num_iters)
        log("layers", layer="gn_level_L0", descriptor=desc,
            K=p.pointCapacity, valid_points=int(td.num_valid),
            iterations=it, ms_per_call=f"{ms:.3f}",
            ms_per_iteration=f"{ms / max(it, 1):.4f}", card=repr(card))
    cost = 8.0 * jax.random.uniform(jax.random.key(0), (ROWS, COLS, SGM_D))
    agg = jax.jit(partial(_aggregate_4dir_scan, p1=2.0, p2=8.0))
    ms, _ = _time_ms(agg, cost, reps=5)
    log("layers", layer="sgm_aggregate_4dir_scan",
        shape=f"{ROWS}x{COLS}x{SGM_D}", ms=f"{ms:.3f}", card=repr(card))


def run_one_card(card):
    n_frames = 1 + N_CHUNKS * CHUNK
    K, baseline, images, disps = make_sequence(n_frames)
    for desc in DESCRIPTORS:
        phase_compile(desc, K, baseline, images, disps)
    gpu, cpu = jax.devices()[0], cpu_device()
    scans = {}
    for desc in DESCRIPTORS:
        t0 = time.perf_counter()
        scan = run_scan(desc, K, baseline, images, disps, gpu)
        wall = time.perf_counter() - t0
        ref = run_scan(desc, K, baseline, images, disps, cpu)
        err = translation_errors(scan["pose"])
        diff = differences(scan, ref)
        log("scan", descriptor=desc, frames=n_frames - 1,
            max_translation_err_m=f"{err.max():.3g}",
            worst_frame=int(np.argmax(err)) + 1,
            cpu_max_translation_err_m=
            f"{translation_errors(ref['pose']).max():.3g}",
            wall_s_incl_compile=f"{wall:.2f}",
            **{k: (f"{v:.3g}" if isinstance(v, float) else v)
               for k, v in diff.items()})
        check_ground_truth(desc, scan["pose"])
        check_differences(desc, diff)
        scans[desc] = scan
    for desc in DESCRIPTORS:
        d = check_online(desc, run_online(desc, K, baseline, images, disps,
                                          gpu), scans[desc])
        log("online", descriptor=desc, frames=N_ONLINE,
            pose_world_vs_scan=f"{d:.3g}")
    for desc in DESCRIPTORS:
        poses, _ = run_host(desc, K, baseline, images, disps, gpu)
        gt, d = check_host(desc, poses, scans[desc])
        log("host_api", descriptor=desc, frames=N_ONLINE,
            max_translation_err_m=f"{gt:.3g}", pose_vs_device_vo=f"{d:.3g}")
    log("stereo", num_disparities=SGM_D, **run_stereo(gpu, cpu))
    phase_layers(K, baseline, images, disps, card)


def run_four_cards():
    log("four_cards", **sharded_vo_vs_single(4))
    log("four_cards_ba", **sharded_ba_vs_single(4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path and its comparison")
    args = ap.parse_args(argv)
    from bpvo_tpu.utils.device import enable_compile_cache
    cache_dir = enable_compile_cache()
    rec, card = phase_device(4 if args.four_cards else 1, cache_dir)
    if args.four_cards:
        run_four_cards()
    else:
        run_one_card(card)
    print(json.dumps({"ok": True, "device": rec}))


if __name__ == "__main__":
    main()
