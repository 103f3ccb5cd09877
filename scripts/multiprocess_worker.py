"""Worker for the 2-process distributed GN test (VERDICT round-1 item 6).

Each process contributes 2 virtual CPU devices to a 4-device global mesh
(2 processes x 2 devices); the point-sharded Gauss-Newton then runs its
per-iteration psum across the process boundary through the gloo CPU
collectives backend.  Process 0 also solves the identical problem on a
single local device and asserts the distributed pose matches.

Launched by tests/test_multiprocess.py as:
    python scripts/multiprocess_worker.py <coordinator> <num_procs> <pid>

No reference analogue — halismai/bpvo is single-process (SURVEY.md §2.4);
this exercises the BASELINE.md multi-host scaling path on CPU, the same
code path a multi-process GPU run takes through jax.distributed.
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def _rep(x):
    """Value of a replicated multi-process array on this process."""
    import numpy as np
    return np.asarray(x.addressable_shards[0].data)


def _mode_gn(info, pid):
    """Point-sharded inner GN across the process boundary (round-1 test)."""
    import numpy as np
    import jax.numpy as jnp
    from __graft_entry__ import _synthetic_problem
    from bpvo_tpu.parallel import multihost, sharded
    from bpvo_tpu.solver import gauss_newton as gn

    # identical seed => identical host data on every process
    tdata, channels, cam, _ = _synthetic_problem(96, 128, 512, seed=3)
    opts = gn.GNOptions(max_iterations=20, function_tolerance=1e-5,
                        parameter_tolerance=1e-7)

    # 2-D (kf=1, points=4) global mesh spanning both processes
    mesh = multihost.global_mesh(kf_axis_size=1)
    tdata_sh = sharded.shard_template(tdata, mesh)
    st = sharded.make_sharded_gn(mesh, opts)(
        tdata_sh, channels, cam, jnp.eye(4, dtype=jnp.float32))
    # replicated outputs: every process holds the full value locally
    T_dist = _rep(st.T)
    iters = int(_rep(st.num_iters))
    assert np.all(np.isfinite(T_dist)), T_dist
    assert iters >= 1

    # single-device reference on this process's first local device
    st_local = gn.run(tdata, channels, cam, jnp.eye(4, dtype=jnp.float32),
                      opts)
    T_local = np.asarray(st_local.T)
    err = np.abs(T_dist - T_local).max()
    assert err < 1e-4, (err, T_dist, T_local)
    return f"iters={iters} T_err={err:.2e}"


def _mode_vo(info, pid):
    """FULL sharded VO step (descriptors -> coarse-to-fine GN -> keyframe
    cond -> template rebuild, parallel/sharded_vo.py) with its psums crossing
    the real process boundary; parity vs single-device DeviceVO including a
    keyframe event (VERDICT round-3 item 5a)."""
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    from test_gn import H_IMG, W_IMG, make_cam
    from test_odometry import make_sequence
    from bpvo_tpu.config import AlgorithmParameters
    from bpvo_tpu.parallel import multihost, sharded_vo
    from bpvo_tpu.vo.device_vo import DeviceVO

    p = AlgorithmParameters(minSaliency=2.0, numPyramidLevels=3,
                            functionTolerance=1e-4, parameterTolerance=1e-6,
                            maxIterations=50,
                            minTranslationMagToKeyFrame=0.04)
    frames = make_sequence([0, 0, 0, 0.0, 0.0, 0.011], 5)
    cam = make_cam()
    K = np.asarray(cam.K())

    vo = DeviceVO(K, float(cam.baseline), (H_IMG, W_IMG), p)
    single = []
    for I, D in frames:
        out = vo.add_frame(I, D)
        if out is not None:
            single.append(out)
    assert any(bool(o.is_keyframe) for o in single), "no keyframe exercised"

    mesh = multihost.global_mesh(kf_axis_size=1)   # points axis x-process
    init_fn, step_fn, _ = sharded_vo.make_sharded_vo(
        mesh, K, float(cam.baseline), (H_IMG, W_IMG), p)
    state = init_fn(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
    max_err = 0.0
    n_kf = 0
    for (I, D), ref in zip(frames[1:], single):
        state, out = step_fn(state, jnp.asarray(I), jnp.asarray(D))
        err = float(np.abs(_rep(out.pose) - np.asarray(ref.pose)).max())
        max_err = max(max_err, err)
        assert err < 2e-4, (err,)
        kf_dist = bool(_rep(out.is_keyframe))
        assert kf_dist == bool(ref.is_keyframe), (kf_dist,)
        n_kf += int(kf_dist)
    return f"frames={len(single)} keyframes={n_kf} pose_err={max_err:.2e}"


def _mode_ba(info, pid):
    """2-D (kf x points) windowed BA with the KEYFRAME axis spanning the two
    processes (multihost.global_mesh kf_axis_size=2 = the cross-host
    placement), parity vs a single-device 1x1-mesh run (VERDICT round-3
    item 5b)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from __graft_entry__ import _synthetic_problem
    from bpvo_tpu.parallel import bundle_adjustment as ba
    from bpvo_tpu.parallel import multihost, sharded

    M = 2
    tdata, channels, cam, _ = _synthetic_problem(96, 128, 512, seed=3)
    templates = ba.stack_templates([tdata] * M)
    ch = jnp.broadcast_to(channels, (M,) + channels.shape)
    # slightly perturbed initial poses so BA has work to do
    poses0 = np.stack([np.eye(4, dtype=np.float32)] * M)
    poses0[1, 0, 3] = 0.004
    poses0 = jnp.asarray(poses0)
    opts = ba.BAOptions(max_iterations=4)

    # kf axis (size 2) spans the process boundary; points axis within process
    mesh = multihost.global_mesh(kf_axis_size=2)
    tmpl_spec = jax.tree.map(
        lambda s: P(*((multihost.KEYFRAME_AXIS,) + tuple(s))),
        sharded.template_spec())
    templates_g = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        templates, tmpl_spec)
    poses_dist, cost_dist = ba.make_sharded_ba_2d(mesh, opts, M)(
        templates_g, ch, cam, poses0)
    poses_dist = _rep(poses_dist)
    cost_dist = float(_rep(cost_dist))

    # single-device reference: the same program on a local 1x1 mesh
    mesh1 = multihost.global_mesh(devices=[jax.local_devices()[0]],
                                  kf_axis_size=1)
    poses_loc, cost_loc = ba.make_sharded_ba_2d(mesh1, opts, M)(
        templates, ch, cam, poses0)
    err = float(np.abs(poses_dist - np.asarray(poses_loc)).max())
    assert np.isfinite(cost_dist) and cost_dist > 0
    assert err < 1e-4, (err, cost_dist, float(cost_loc))
    return f"M={M} cost={cost_dist:.1f} pose_err={err:.2e}"


MODES = {"gn": _mode_gn, "vo": _mode_vo, "ba": _mode_ba}


def main(coordinator: str, num_procs: int, pid: int,
         mode: str = "gn") -> None:
    from bpvo_tpu.parallel import multihost

    multihost.initialize(coordinator_address=coordinator,
                         num_processes=num_procs, process_id=pid)
    info = multihost.process_info()
    assert info["process_count"] == num_procs, info
    assert info["process_index"] == pid, info  # coordinator assignment check
    assert info["global_devices"] == 2 * num_procs, info

    detail = MODES[mode](info, pid)
    print(f"MULTIPROC_OK mode={mode} pid={pid} "
          f"procs={info['process_count']} "
          f"devices={info['global_devices']} {detail}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         sys.argv[4] if len(sys.argv) > 4 else "gn")
