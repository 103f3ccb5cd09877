import os

import numpy as np
import pytest

from bpvo_tpu.config import ConfigFile
from bpvo_tpu.data.dataset import (DatasetFrame, FileSequence,
                                   StereoCalibration, create_dataset)
from bpvo_tpu.data.loader import DatasetLoaderThread
from bpvo_tpu.data.stereo import (CvBlockMatching, DeviceBlockMatching, DeviceSGM,
                                  create_stereo_algorithm)
from bpvo_tpu.data.synthetic import SyntheticPlaneDataset


def make_stereo_pair(rows=96, cols=160, disp=6.0, seed=0):
    """Right image = left shifted right-to-left by ``disp`` pixels."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    tex = lambda x, y: (
        128 + 50 * np.sin(x / 5.0) * np.cos(y / 7.0)
        + 40 * np.sin((2 * x + y) / 11.0) + 20 * np.sin(x / 2.3))
    L = tex(xx, yy)
    R = tex(xx + disp, yy)  # right camera sees the scene shifted left
    noise = r.standard_normal((rows, cols)).astype(np.float32)
    return (np.clip(L + noise, 0, 255).astype(np.uint8),
            np.clip(R + noise, 0, 255).astype(np.uint8))


class TestStereo:
    def test_device_block_matching_recovers_disparity(self):
        L, R = make_stereo_pair(disp=6.0)
        bm = DeviceBlockMatching(num_disparities=32, sad_window=9)
        D = bm.run(L, R)
        valid = D[20:-20, 40:-20]
        valid = valid[valid > 0]
        assert len(valid) > 500
        assert abs(np.median(valid) - 6.0) < 0.5

    def test_device_sgm_recovers_disparity(self):
        L, R = make_stereo_pair(disp=6.0)
        sgm = DeviceSGM(num_disparities=32)
        D = sgm.run(L, R)
        valid = D[20:-20, 40:-20]
        valid = valid[valid > 0]
        assert len(valid) > 500
        assert abs(np.median(valid) - 6.0) < 0.5

    def test_sgm_calibrated_against_oracle(self):
        """Calibrated defaults (docs/SGM_CALIBRATION.md) must keep DeviceSGM
        within a stated band of exact GT on a slanted-plane pair where cv2
        SGBM also succeeds (VERDICT r2 item 7)."""
        import cv2
        from bpvo_tpu.data.synthetic import SyntheticPlaneDataset
        b = 0.12
        ds = SyntheticPlaneDataset(
            rows=240, cols=320, n_frames=2, z0=4.0, texture="noise",
            baseline=b, twist_per_frame=(0, 0, 0, -b, 0, 0))
        f0, f1 = ds.get_frame(0), ds.get_frame(1)
        L = np.clip(f0.image, 0, 255).astype(np.uint8)
        R = np.clip(f1.image, 0, 255).astype(np.uint8)
        gt = f0.disparity

        def mae(d):
            ok = (gt > 1.0) & (gt < 30.0) & (d > 0)
            assert ok.sum() > 10000
            return float(np.abs(d - gt)[ok].mean())

        sgbm = cv2.StereoSGBM_create(minDisparity=0, numDisparities=32,
                                     blockSize=5, P1=200, P2=800,
                                     uniquenessRatio=10)
        mae_oracle = mae(sgbm.compute(L, R).astype(np.float32) / 16.0)
        mae_sgm = mae(DeviceSGM(num_disparities=32).run(
            L.astype(np.float32), R.astype(np.float32)))
        assert mae_oracle < 0.5          # oracle succeeds on this scene
        assert mae_sgm < 0.5, mae_sgm    # calibrated band
        assert mae_sgm < 3.0 * mae_oracle, (mae_sgm, mae_oracle)

    def test_cv_block_matching(self):
        L, R = make_stereo_pair(disp=6.0)
        cf = ConfigFile()
        cf.set("numberOfDisparities", 32).set("SADWindowSize", 9)
        bm = CvBlockMatching(cf)
        D = bm.run(L, R)
        valid = D[20:-20, 40:-20]
        valid = valid[valid > 0]
        assert len(valid) > 100
        assert abs(np.median(valid) - 6.0) < 1.0

    def test_factory(self):
        cf = ConfigFile()
        cf.set("StereoAlgorithm", "DeviceBlockMatching")
        cf.set("numberOfDisparities", 32)
        assert isinstance(create_stereo_algorithm(cf), DeviceBlockMatching)
        cf.set("StereoAlgorithm", "sgm")
        assert isinstance(create_stereo_algorithm(cf), DeviceSGM)


class TestSynthetic:
    def test_frames_and_gt(self):
        ds = SyntheticPlaneDataset(rows=60, cols=80, n_frames=5)
        frames = list(ds)
        assert len(frames) == 5
        assert frames[0].image.shape == (60, 80)
        assert frames[0].disparity.shape == (60, 80)
        assert np.all(frames[0].disparity > 0)
        # frame 0 pose is identity
        np.testing.assert_allclose(ds.pose_at(0), np.eye(4))

    def test_factory_from_config(self):
        cf = ConfigFile()
        cf.set("Dataset", "synthetic")
        cf.set("SyntheticRows", 48).set("SyntheticCols", 64)
        ds = create_dataset(cf)
        assert ds.image_size == (48, 64)


class TestLoader:
    def test_prefetch_all_frames(self):
        ds = SyntheticPlaneDataset(rows=48, cols=64, n_frames=7)
        with DatasetLoaderThread(ds, buffer_size=3) as loader:
            frames = list(loader)
        assert len(frames) == 7
        assert all(isinstance(f, DatasetFrame) for f in frames)

    def test_max_frames(self):
        ds = SyntheticPlaneDataset(rows=48, cols=64, n_frames=100)
        with DatasetLoaderThread(ds, buffer_size=2, max_frames=4) as loader:
            frames = list(loader)
        assert len(frames) == 4

    def test_frames_in_order(self):
        ds = SyntheticPlaneDataset(rows=48, cols=64, n_frames=6)
        with DatasetLoaderThread(ds, buffer_size=2) as loader:
            names = [f.filename for f in loader]
        assert names == [f"synthetic/{i:06d}" for i in range(6)]


class TestKittiCalib:
    def test_parse(self, tmp_path):
        calib = tmp_path / "calib.txt"
        calib.write_text(
            "P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
            "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
        from bpvo_tpu.data.kitti import load_kitti_calibration
        c = load_kitti_calibration(str(calib))
        assert abs(c.K[0, 0] - 718.856) < 1e-3
        assert abs(c.baseline - 386.1448 / 718.856) < 1e-5


class TestFileSequence:
    def test_format(self, tmp_path):
        seq = FileSequence(str(tmp_path), "img_%04d.png", first_frame=3)
        assert seq[0].endswith("img_0003.png")
        assert seq[2].endswith("img_0005.png")
        assert not seq.exists(0)


class TestDevicePrefetch:
    def test_loader_yields_device_arrays(self):
        import jax
        ds = SyntheticPlaneDataset(rows=48, cols=64, n_frames=3)
        with DatasetLoaderThread(ds, buffer_size=2,
                                 device_prefetch=True) as loader:
            frames = list(loader)
        assert len(frames) == 3
        assert all(isinstance(f.image, jax.Array) for f in frames)


class TestTunnelDataset:
    """conf/tunnel.cfg-style config -> working DisparityDataset (reference
    utils/tunnel_dataset.cc:21-105 path: CalibrationFile + LeftImageFormat +
    DisparityMapFormat)."""

    def test_end_to_end(self, tmp_path):
        import cv2
        rng = np.random.default_rng(0)
        for i in range(900, 903):
            img = rng.integers(0, 255, (32, 40), np.uint8)
            cv2.imwrite(str(tmp_path / f"image{i:06d}.pgm"), img)
            disp16 = (rng.uniform(1, 64, (32, 40)) * 16).astype(np.uint16)
            cv2.imwrite(str(tmp_path / f"image{i:06d}-disparity.pgm"), disp16)
        (tmp_path / "stereoCalibration.txt").write_text(
            "CRL Camera Config\n"
            "fx,fy,cx,cy: 600.0, 601.0, 320.5, 240.5\n"
            "xyzrpq: -0.25, 0, 0, 0, 0, 0\n")
        cfg = tmp_path / "tunnel.cfg"
        cfg.write_text(
            "Dataset = tunnel\n"
            f"DataSetRootDirectory = {tmp_path}\n"
            f"CalibrationFile = {tmp_path}/stereoCalibration.txt\n"
            "LeftImageFormat = image%06d.pgm\n"
            "DisparityMapFormat = image%06d-disparity.pgm\n"
            "firstFrameNumber = 900\n")
        from bpvo_tpu.data.dataset import create_dataset
        ds = create_dataset(str(cfg))
        assert ds.name == "tunnel"
        assert abs(ds.calibration.K[0, 0] - 600.0) < 1e-6
        assert abs(ds.calibration.baseline - 0.25) < 1e-6
        f = ds.get_frame(0)
        assert f is not None and f.image.shape == (32, 40)
        # uint16 disparity scaled by 1/16
        assert f.disparity.dtype == np.float32
        assert f.disparity.max() <= 64.5 and f.disparity.min() >= 0.5
        assert ds.get_frame(3) is None
