"""chip_smoke.py's stereo phase and its four-device comparison, on the CPU:
SGM inside DeviceVO's keyframe branch at full width (D=64 instead of the
card's 128), and the sharded VO and BA on 4 virtual CPU devices against
their single-device runs."""
import jax
import pytest

import chip_smoke as cs


def test_stereo_in_the_loop():
    cpu = cs.cpu_device()
    found = cs.run_stereo(cpu, cpu, n_frames=4, num_disparities=64)
    assert float(found["sgm_median_abs_diff_px"]) == 0.0   # same device
    assert found["keyframes"] >= 1
    assert float(found["max_translation_err_m"]) < 0.01


def test_four_device_comparison():
    assert len(jax.devices()) >= 4
    p = cs.params_for("Intensity", minTranslationMagToKeyFrame=0.05,
                      maxIterations=8, coarseMaxIterations=6)
    vo = cs.sharded_vo_vs_single(4, n_frames=5, chunk=2, params=p)
    assert vo["chunks"] == 2 and vo["keyframes"] >= 1
    assert float(vo["pose_vs_single"]) <= cs.SHARDED_TOL
    assert len(vo["bytes_in_use"]) == 4
    # one fused psum per GN iteration, plus the keyframe-path reductions
    assert vo["collectives_per_step"]["all-reduce"]["count"] >= 1
    ba = cs.sharded_ba_vs_single(4, m_keyframes=4, iterations=3)
    assert float(ba["pose_vs_single"]) <= cs.SHARDED_TOL
    assert float(ba["pose_err_after"]) < float(ba["pose_err_before"])


@pytest.mark.parametrize("line,op,count,nbytes", [
    ("  %ar = f32[6,6]{1,0} all-reduce(f32[6,6]{1,0} %x), "
     "replica_groups={{0,1}}, to_apply=%sum", "all-reduce", 1, 144),
    ("  %ars = (f32[1024]{0}, s32[]) all-reduce-start(%a, %b), "
     "to_apply=%sum", "all-reduce", 1, 4100),
    ("  %ag = bf16[8,128]{1,0} all-gather(bf16[2,128]{1,0} %y), "
     "dimensions={0}", "all-gather", 1, 2048),
])
def test_collective_stats_parses_hlo(line, op, count, nbytes):
    text = "\n".join([line, "  %d = f32[] add(f32[] %p, f32[] %q)",
                      "  %done = f32[6,6]{1,0} all-reduce-done(%ars)"])
    assert cs.collective_stats(text) == {op: {"count": count,
                                              "bytes": nbytes}}
