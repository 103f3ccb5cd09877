"""Profiling / tracing integration.

Counterpart of the reference's Timer/gperftools hooks (SURVEY.md §5: timer.h,
WITH_PROFILER, scripts/profile) using the native JAX tooling: ``jax.profiler``
traces viewable in XProf/Perfetto/TensorBoard, plus a lightweight per-stage
wall-clock harness that forces device completion before reading the clock.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/bpvo_trace"):
    """Capture a device trace: ``with profiling.trace("/tmp/t"): run()``."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    import jax
    return jax.profiler.TraceAnnotation(name)


def force_sync(tree) -> None:
    """Force completion by fetching one element of every array in the pytree
    (reliable on backends where block_until_ready is asynchronous)."""
    import jax

    def fetch(x):
        if hasattr(x, "addressable_data"):
            np.asarray(jax.numpy.ravel(x)[0])
        return x

    jax.tree.map(fetch, tree)


def timed(fn, *args, n_rep: int = 10, warmup: int = 1, **kw) -> float:
    """Mean wall-clock ms of ``fn`` with a hard device sync per call."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    force_sync(out)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn(*args, **kw)
        force_sync(out)
    return (time.perf_counter() - t0) / n_rep * 1000.0
