"""Scaling-efficiency benchmark for the distributed IRLS-GN step.

Measures the point-sharded Gauss-Newton runner at mesh sizes 1, 2, 4, ...
devices on whatever backend is available (8 virtual CPU devices under
XLA_FLAGS=--xla_force_host_platform_device_count=8, real chips on a pod) and
reports strong-scaling efficiency — the BASELINE.md target is >= 80% at 2+
hosts.

Usage: python -m bpvo_tpu.apps.scaling_bench [--points 65536] [--rows 240]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_scaling(total_points: int = 65536, rows: int = 240, cols: int = 320,
                reps: int = 20):
    import jax
    import jax.numpy as jnp
    from bpvo_tpu.parallel import sharded
    from bpvo_tpu.solver import gauss_newton as gn
    from __graft_entry__ import _synthetic_problem

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    opts = gn.GNOptions(max_iterations=10, function_tolerance=1e-12,
                        parameter_tolerance=1e-12)  # fixed work per run

    tdata, channels, cam, p = _synthetic_problem(rows, cols, total_points)
    results = {}
    t_base = None
    for n in sizes:
        mesh = sharded.make_mesh(n)
        tdata_sh = sharded.shard_template(tdata, mesh)
        run = sharded.make_sharded_gn(mesh, opts)
        T0 = jnp.eye(4, dtype=jnp.float32)
        st = run(tdata_sh, channels, cam, T0)
        np.asarray(st.T)  # force
        t0 = time.perf_counter()
        for _ in range(reps):
            st = run(tdata_sh, channels, cam, T0)
        np.asarray(st.T)
        dt = (time.perf_counter() - t0) / reps * 1000.0
        if t_base is None:
            t_base = dt
        eff = t_base / (dt * n)
        results[n] = {"ms_per_solve": round(dt, 3),
                      "speedup": round(t_base / dt, 3),
                      "efficiency": round(eff, 3)}
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--rows", type=int, default=240)
    ap.add_argument("--cols", type=int, default=320)
    args = ap.parse_args()
    from bpvo_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    print(json.dumps(run_scaling(args.points, args.rows, args.cols), indent=2))


if __name__ == "__main__":
    main()
