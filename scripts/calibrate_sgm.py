"""Calibrate DeviceSGM's census-hamming penalties (p1, p2) against exact synthetic
ground truth, with cv2 SGBM as the established-implementation oracle on the
same pairs (VERDICT round-2 item 7; reference penalty scaling at
/root/reference/utils/stereo_algorithm.cc:50-55 is in census-weighted units and
does not transfer to hamming units).

Stereo pairs with EXACT disparity: the synthetic plane/occluder renderers
produce the right view as a one-step dataset whose per-frame twist is a pure
-baseline x-translation; ground truth is the left frame's analytic disparity.

Writes docs/SGM_CALIBRATION.md and prints the best (p1, p2).
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from bpvo_tpu.data.synthetic import (SyntheticOccluderDataset,  # noqa: E402
                                     SyntheticPlaneDataset)
from bpvo_tpu.data import stereo  # noqa: E402

BASELINE = 0.12
D_MAX = 32


def make_pair(kind: str):
    """(left, right, gt_disparity) with exact geometry."""
    twist = (0.0, 0.0, 0.0, -BASELINE, 0.0, 0.0)   # right camera at +b x
    if kind == "plane":
        ds = SyntheticPlaneDataset(rows=240, cols=320, n_frames=2, z0=4.0,
                                   texture="noise", baseline=BASELINE,
                                   twist_per_frame=twist)
    else:
        ds = SyntheticOccluderDataset(rows=240, cols=320, n_frames=2,
                                      z_occ=2.2, occ_vel=(0, 0, 0),
                                      baseline=BASELINE,
                                      twist_per_frame=twist, z0=4.0)
    f0, f1 = ds.get_frame(0), ds.get_frame(1)
    clip = lambda I: np.clip(I, 0, 255).astype(np.uint8).astype(np.float32)
    return clip(f0.image), clip(f1.image), f0.disparity


def errors(disp, gt):
    """(MAE px, %bad>1px, coverage) over pixels with in-range GT and output."""
    ok = (gt > 1.0) & (gt < D_MAX - 2) & (disp > 0)
    gt_in = (gt > 1.0) & (gt < D_MAX - 2)
    err = np.abs(disp - gt)[ok]
    if err.size == 0:
        return np.inf, 1.0, 0.0
    return (float(err.mean()), float((err > 1.0).mean()),
            float(ok.sum() / max(gt_in.sum(), 1)))


def run_sgbm(L, R):
    import cv2
    m = cv2.StereoSGBM_create(minDisparity=0, numDisparities=D_MAX,
                              blockSize=5, P1=8 * 25, P2=32 * 25,
                              uniquenessRatio=10)
    d = m.compute(L.astype(np.uint8), R.astype(np.uint8))
    return d.astype(np.float32) / 16.0


def main():
    pairs = {k: make_pair(k) for k in ("plane", "occluder")}

    lines = ["# DeviceSGM penalty calibration (round 3)", "",
             "Exact-GT synthetic stereo pairs (`scripts/calibrate_sgm.py`), "
             "cv2 SGBM as oracle on the same pixels.  Error = mean |d - gt| "
             "over pixels with valid output and in-range GT; bad = fraction "
             "with error > 1 px.", ""]

    for name, (L, R, gt) in pairs.items():
        d_sgbm = run_sgbm(L, R)
        mae, bad, cov = errors(d_sgbm, gt)
        lines += [f"## {name}", "",
                  f"cv2 SGBM oracle: MAE {mae:.3f} px, bad>1px {100*bad:.1f}%, "
                  f"coverage {100*cov:.1f}%", "",
                  "| p1 | p2 | MAE (px) | bad>1px | coverage |",
                  "|---|---|---|---|---|"]
        print(f"[{name}] SGBM: mae={mae:.3f} bad={bad:.3f} cov={cov:.3f}",
              flush=True)

    results = {}
    for p1 in (0.25, 0.5, 1.0, 2.0):
        for p2 in (2.0, 4.0, 8.0, 16.0, 32.0):
            if p2 <= p1:
                continue
            tot = 0.0
            for name, (L, R, gt) in pairs.items():
                alg = stereo.DeviceSGM(num_disparities=D_MAX, p1=p1, p2=p2)
                d = alg.run(L, R)
                mae, bad, cov = errors(d, gt)
                results[(p1, p2, name)] = (mae, bad, cov)
                tot += mae + bad          # combined objective
                print(f"p1={p1} p2={p2} {name}: mae={mae:.3f} "
                      f"bad={bad:.3f} cov={cov:.3f}", flush=True)
            results[(p1, p2, "_score")] = tot

    best = min(((k[0], k[1]) for k in results if k[2] == "_score"),
               key=lambda pp: results[(pp[0], pp[1], "_score")])
    print(f"BEST: p1={best[0]} p2={best[1]}")

    # emit per-scene tables
    for name in pairs:
        idx = lines.index(f"## {name}")
        insert_at = idx + 6
        rows = []
        for (p1, p2, nm), val in sorted(results.items()):
            if nm != name:
                continue
            mae, bad, cov = val
            mark = " **<-**" if (p1, p2) == best else ""
            rows.append(f"| {p1} | {p2} | {mae:.3f} | {100*bad:.1f}% | "
                        f"{100*cov:.1f}% |{mark}")
        lines[insert_at:insert_at] = rows
    lines += ["",
              f"**Chosen defaults: p1 = {best[0]}, p2 = {best[1]}** "
              "(minimum summed MAE + bad-fraction across scenes; wired into "
              "`data/stereo.DeviceSGM` and asserted by "
              "`tests/test_data.py::test_sgm_calibrated_against_oracle`).",
              ""]
    md = Path(__file__).resolve().parents[1] / "docs" / "SGM_CALIBRATION.md"
    md.write_text("\n".join(lines))
    print(f"wrote {md}")


if __name__ == "__main__":
    main()
