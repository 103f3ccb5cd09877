"""Set-up shared by the measuring entry points (``chip_smoke.py``,
``bench.py``, the ``bpvo_tpu.apps`` CLIs): the persistent compilation cache,
the GPU requirement, and the card's name and power limit.

Nothing here runs on ``import bpvo_tpu``; each entry point calls what it
needs from its ``main()``.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

# <repo>/.jax_cache — a fixed path, because the cache key includes it; the
# directory is listed in .gitignore
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and no
    other setting is touched; otherwise the cache goes to
    ``<repo>/.jax_cache``."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU — measurements never fall
    back to the CPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``; raises if it cannot be read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi printed no card")
    return lines[0]


def device_record() -> dict:
    """What every measurement names: platform, device kind, device count."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
