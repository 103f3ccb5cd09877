"""Stereo INSIDE the VO loop (VERDICT r4 item 2): the reference's primary
KITTI operational mode is StereoDataset -> matcher -> VO (reference
utils/dataset.cc:103-135, apps/eval_kitti.cc:17-40).  These tests drive that
chain end-to-end on synthetic stereo pairs with a real matcher (DeviceBM on
small frames), through BOTH surfaces:

  * config -> create_dataset -> VisualOdometry (the host app path)
  * DeviceVO(stereo_fn=...) with on-device keyframe-rate disparity
"""
import numpy as np
import pytest

import jax.numpy as jnp

from bpvo_tpu import AlgorithmParameters, VisualOdometry
from bpvo_tpu.core import se3
from bpvo_tpu.data.dataset import create_dataset
from bpvo_tpu.data.stereo import DeviceBlockMatching
from bpvo_tpu.data.synthetic import SyntheticStereoPlaneDataset


TWIST = (0.0, 0.0, 0.0, 0.01, 0.0, 0.02)


def make_stereo_config(tmp_path, n_frames=6):
    cfg = tmp_path / "synth_stereo.cfg"
    cfg.write_text(
        # conf/tsukuba_stereo.cfg-style: dataset + matcher + VO params in one
        "Dataset = synthetic_stereo\n"
        "SyntheticRows = 120\nSyntheticCols = 160\n"
        f"SyntheticNumFrames = {n_frames}\n"
        "SyntheticBaseline = 0.5\n"
        "StereoAlgorithm = DeviceBlockMatching\n"
        "numberOfDisparities = 48\n"
        "SADWindowSize = 9\n"
        "uniquenessRatio = 10\n"
        "Descriptor = Intensity\n"
        "numPyramidLevels = 3\nminSaliency = 2.0\n"
        "functionTolerance = 1e-4\nparameterTolerance = 1e-6\n"
        "maxIterations = 50\n"
        "minValidDisparity = 1\nmaxValidDisparity = 48\n"
        "lossFunction = Huber\n")
    return str(cfg)


class TestStereoDatasets:
    def test_matcher_disparity_close_to_gt(self):
        """The synthetic stereo pair is exact; DeviceBM must recover the GT
        disparity to sub-pixel on most of the (textured) plane."""
        ds = SyntheticStereoPlaneDataset(rows=120, cols=160, n_frames=2,
                                         baseline=0.5,
                                         twist_per_frame=TWIST)
        f = ds.get_frame(0)
        gt = ds.gt_disparity(0)
        valid = f.disparity > 0
        assert valid.mean() > 0.5, "matcher should validate most of the plane"
        err = np.abs(f.disparity - gt)[valid]
        assert np.median(err) < 0.5, float(np.median(err))

    def test_file_stereo_dataset(self, tmp_path):
        """Generic ``Dataset = stereo`` branch: left/right PNGs on disk run
        through the config-selected matcher (reference dataset.cc:103-135)."""
        import cv2
        ds0 = SyntheticStereoPlaneDataset(rows=120, cols=160, n_frames=3,
                                          baseline=0.5,
                                          twist_per_frame=TWIST)
        (tmp_path / "left").mkdir()
        (tmp_path / "right").mkdir()
        for i in range(3):
            L = np.clip(np.round(ds0.get_frame(i).image), 0, 255)
            R = np.clip(np.round(ds0.right_image(i)), 0, 255)
            cv2.imwrite(str(tmp_path / "left" / f"{i:06d}.png"),
                        L.astype(np.uint8))
            cv2.imwrite(str(tmp_path / "right" / f"{i:06d}.png"),
                        R.astype(np.uint8))
        K = ds0.calibration.K
        cfg = tmp_path / "stereo.cfg"
        cfg.write_text(
            "Dataset = stereo\n"
            f"DataSetRootDirectory = {tmp_path}\n"
            "LeftImageFormat = left/%06d.png\n"
            "RightImageFormat = right/%06d.png\n"
            "StereoAlgorithm = DeviceBlockMatching\n"
            "numberOfDisparities = 48\nSADWindowSize = 9\n"
            f"fx = {K[0, 0]}\nfy = {K[1, 1]}\ncx = {K[0, 2]}\n"
            f"cy = {K[1, 2]}\nbaseline = {ds0.calibration.baseline}\n")
        ds = create_dataset(str(cfg))
        f = ds.get_frame(0)
        assert f is not None and ds.get_frame(3) is None
        gt = ds0.gt_disparity(0)
        valid = f.disparity > 0
        assert valid.mean() > 0.5
        # uint8 quantization adds noise on top of the exact-pair test above
        assert np.median(np.abs(f.disparity - gt)[valid]) < 0.75


class TestStereoConfigs:
    def test_shipped_stereo_configs_build_matchers(self):
        """conf/{tsukuba,kitti}_stereo.cfg select real matchers through the
        factory (the data they point at does not exist in this container;
        matcher construction + VO-param parse is the exercisable half)."""
        import os
        from bpvo_tpu.config import ConfigFile
        from bpvo_tpu.data.stereo import create_stereo_algorithm
        root = os.path.join(os.path.dirname(__file__), "..", "conf")
        for name in ("tsukuba_stereo.cfg", "kitti_stereo.cfg"):
            cf = ConfigFile(os.path.join(root, name))
            alg = create_stereo_algorithm(cf)
            assert hasattr(alg, "run")
            p = AlgorithmParameters.from_config_file(
                os.path.join(root, name))
            assert p.numPyramidLevels >= 1


class TestStereoVoLoop:
    def test_config_to_vo_end_to_end(self, tmp_path):
        """conf/tsukuba_stereo.cfg-style config -> dataset(+matcher) -> VO:
        recovered per-frame motion must match the GT step despite the
        disparity coming from the matcher, not GT."""
        cfg = make_stereo_config(tmp_path)
        from bpvo_tpu.config import ConfigFile
        cf = ConfigFile(cfg)
        ds = create_dataset(cf)
        p = AlgorithmParameters.from_config_file(cfg)
        calib = ds.calibration
        vo = VisualOdometry(calib.K, calib.baseline, ds.image_size, p)
        T_step = np.asarray(se3.exp(jnp.asarray(TWIST, jnp.float32)))
        ds._step = np.asarray(T_step, np.float64)  # set GT motion
        errs = []
        for i, frame in enumerate(ds):
            r = vo.add_frame(frame.image, frame.disparity)
            if i == 0:
                continue
            err = np.asarray(se3.log(jnp.asarray(
                np.asarray(r.pose) @ np.linalg.inv(T_step), jnp.float32)))
            errs.append(np.abs(err).max())
        # matcher sub-pixel quantization bounds accuracy, not the solver
        assert len(errs) == 5
        assert max(errs) < 2e-3, errs

    def test_device_vo_stereo_fn_matches_precomputed(self):
        """DeviceVO(stereo_fn=...) fed (left, right) must produce the SAME
        trajectory as DeviceVO fed the same matcher's precomputed disparity:
        keyframe-rate on-device stereo is a scheduling change, not an
        algorithmic one."""
        from bpvo_tpu.vo.device_vo import DeviceVO

        ds = SyntheticStereoPlaneDataset(rows=120, cols=160, n_frames=7,
                                         baseline=0.5,
                                         twist_per_frame=TWIST)
        p = AlgorithmParameters(minSaliency=2.0, numPyramidLevels=3,
                                functionTolerance=1e-4,
                                parameterTolerance=1e-6, maxIterations=50,
                                minValidDisparity=1, maxValidDisparity=48)
        calib = ds.calibration
        bm = DeviceBlockMatching(num_disparities=48, sad_window=9)

        vo_a = DeviceVO(calib.K, calib.baseline, ds.image_size, p,
                        stereo_fn=bm.as_fn())
        vo_b = DeviceVO(calib.K, calib.baseline, ds.image_size, p)
        poses_a, poses_b = [], []
        for i in range(7):
            frame = ds.get_frame(i)  # frame.disparity = matcher output
            L = frame.image
            R = ds.right_image(i)
            out_a = vo_a.add_frame(L, R)
            out_b = vo_b.add_frame(L, frame.disparity)
            if out_a is not None:
                poses_a.append(np.asarray(out_a.pose))
                poses_b.append(np.asarray(out_b.pose))
        assert len(poses_a) == 6
        np.testing.assert_allclose(np.stack(poses_a), np.stack(poses_b),
                                   atol=1e-5)
