"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so the multi-device
sharding paths (mesh + collectives) can be exercised without a GPU.  Must set
the XLA flags before jax is imported anywhere.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# pin the config too, so a platform plugin that rewrites the environment
# variable cannot move the tests off the CPU
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def synthetic_image(rows=120, cols=160, seed=0):
    """Smooth synthetic test image with texture (so gradients are informative)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    img = (128
           + 60 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
           + 40 * np.sin((xx + 2 * yy) / 13.0)
           + 10 * r.standard_normal((rows, cols)).astype(np.float32))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.fixture
def test_image():
    return synthetic_image()
