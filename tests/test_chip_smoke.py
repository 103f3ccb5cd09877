"""chip_smoke.py's phase functions at full KITTI width (376x1241) on the CPU
device, with fewer frames than the card run: DeviceVO scan against the exact
ground truth, online against scan, and the host VisualOdometry against
DeviceVO, for both descriptors."""
import jax
import numpy as np
import pytest

import chip_smoke as cs

N_FRAMES = 9    # init + 2 scan chunks of 4
CHUNK = 4
N_ONLINE = 6


@pytest.fixture(scope="module")
def sequence():
    return cs.make_sequence(N_FRAMES)


@pytest.fixture(scope="module")
def scans(sequence):
    K, baseline, images, disps = sequence
    return {d: cs.run_scan(d, K, baseline, images, disps, cs.cpu_device(),
                           chunk=CHUNK)
            for d in cs.DESCRIPTORS}


@pytest.mark.parametrize("desc", cs.DESCRIPTORS)
def test_scan_matches_ground_truth(desc, scans):
    scan = scans[desc]
    assert scan["pose"].shape == (N_FRAMES - 1, 4, 4)
    err = cs.check_ground_truth(desc, scan["pose"])
    assert err <= cs.TOL[desc]["gt_trans"]
    # a run compared with itself passes every GPU-vs-CPU check
    diff = cs.differences(scan, scan)
    cs.check_differences(desc, diff)
    assert diff["pose_world_vs_ref"] == 0.0 and diff["keyframes"] >= 1
    assert 1.0 < cs.mean_iters(scan) < 200.0


@pytest.mark.parametrize("desc", cs.DESCRIPTORS)
def test_online_matches_scan(desc, sequence, scans):
    K, baseline, images, disps = sequence
    online = cs.run_online(desc, K, baseline, images, disps, cs.cpu_device(),
                           n=N_ONLINE)
    assert online.shape == (N_ONLINE, 4, 4)
    assert cs.check_online(desc, online, scans[desc]) <= cs.ONLINE_TOL[desc]


@pytest.mark.parametrize("desc", cs.DESCRIPTORS)
def test_host_api_matches_device_vo(desc, sequence, scans):
    K, baseline, images, disps = sequence
    poses, is_kf = cs.run_host(desc, K, baseline, images, disps,
                               cs.cpu_device(), n=N_ONLINE)
    assert poses.shape == (N_ONLINE, 4, 4)
    gt, d = cs.check_host(desc, poses, scans[desc])
    assert gt <= cs.TOL[desc]["gt_trans"] and d <= cs.TOL[desc]["vs_cpu"]
    np.testing.assert_array_equal(is_kf, scans[desc]["is_keyframe"][:N_ONLINE])
    assert jax.default_backend() == "cpu"
