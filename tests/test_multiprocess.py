"""2-process distributed GN: the point-sharded solver must produce the
single-device pose when its psum crosses a real process boundary (gloo CPU
collectives).  VERDICT round-1 item 6; BASELINE.md multi-host path."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "scripts" / "multiprocess_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(port: int, mode: str, timeout: int = 600):
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the workers set their own device counts; drop the test harness's flag
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, "2", str(pid), mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(ROOT))
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


def _check_mode(mode: str):
    # _free_port closes its socket before the workers bind it — a TOCTOU
    # window another process could steal.  One retry with a fresh port
    # removes the (rare) flake (ADVICE.md round 2).
    for attempt in range(2):
        procs, outs = _run_workers(_free_port(), mode)
        bind_race = any(p.returncode != 0 and "bind" in out.lower()
                        for p, out in zip(procs, outs))
        if not bind_race or attempt == 1:
            break
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert (f"MULTIPROC_OK mode={mode} pid={pid} procs=2 devices=4"
                in out), out[-3000:]


def test_two_process_sharded_gn():
    _check_mode("gn")


def test_two_process_full_sharded_vo():
    """The FULL sharded VO step (descriptors -> GN -> keyframe cond ->
    template rebuild) across a real 2-process gloo boundary, with a keyframe
    event, matching single-device (VERDICT round-3 item 5a — the program the
    scaling claim rests on, not just the inner GN)."""
    _check_mode("vo")


def test_two_process_ba_2d_kf_axis():
    """2-D (kf x points) windowed BA with the KEYFRAME axis crossing the
    process boundary — the cross-host placement of multihost.global_mesh —
    matching a single-device run (VERDICT round-3 item 5b)."""
    _check_mode("ba")
