"""Multi-host initialization and mesh construction.

No reference analogue (the reference is single-process, SURVEY.md §2.4).  For
a multi-process run, call ``initialize()`` once per process before any JAX
use; ``global_mesh()`` then builds a mesh spanning every device of every
process, laid out by the mesh axes:
  - axis "points": template-point shard (frame tracking + BA reductions) —
    keep it within one host, where its per-iteration reductions are cheapest;
  - axis "kf": keyframe-window shard for BA at larger windows — this is the
    axis to place across hosts, since edges only couple neighboring keyframes
    and the psum'd block system is KBs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from bpvo_tpu.parallel.sharded import POINT_AXIS

KEYFRAME_AXIS = "kf"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` wrapper; no-op for single-process
    runs."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(points_axis_size: Optional[int] = None,
                kf_axis_size: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """2-D (kf, points) mesh over all (global) devices.

    ``points_axis_size`` defaults to filling whatever ``kf_axis_size`` leaves.
    With multiple hosts, devices enumerate host-major, so a kf axis of
    ``num_hosts`` places each keyframe shard on one host's devices — BA's
    cross-keyframe psum then crosses hosts once per iteration while the
    dense point reductions stay within a host.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if points_axis_size is None:
        assert n % kf_axis_size == 0, (n, kf_axis_size)
        points_axis_size = n // kf_axis_size
    assert kf_axis_size * points_axis_size == n, (n, kf_axis_size,
                                                  points_axis_size)
    arr = np.asarray(devs).reshape(kf_axis_size, points_axis_size)
    return Mesh(arr, (KEYFRAME_AXIS, POINT_AXIS))


def process_info():
    return {"process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": len(jax.local_devices()),
            "global_devices": len(jax.devices())}
