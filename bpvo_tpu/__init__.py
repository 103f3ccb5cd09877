"""bpvo_tpu — a semi-dense direct visual odometry framework in JAX.

JAX/XLA implementation of the capabilities of halismai/bpvo, run on an
NVIDIA GPU (or the CPU): dense-descriptor photometric alignment (intensity +
Bit-Planes census channels and the full descriptor zoo), coarse-to-fine IRLS
Gauss-Newton pose estimation over SE(3) with Huber/Tukey M-estimators,
keyframing, trajectory/point-cloud outputs, dataset + stereo front-ends,
KITTI evaluation — plus a distributed layer (sharded template points and
windowed photometric bundle adjustment over device-mesh collectives) the
reference does not have.

Public API mirrors the reference's single entry point
``VisualOdometry::addFrame(image, disparity) -> Result`` (reference bpvo/vo.h:31-105).
"""

import os as _os

# On the GPU the default matmul precision may run f32 contractions in TF32,
# which keeps ~3 decimal digits of each operand; the resulting ~1e-3 relative
# noise in pose compositions, the matmul-form pyramid and the GN normal
# equations keeps the convergence tests from firing and multiplies the GN
# iteration count.  Everything here is latency-bound 6-dof estimation, not
# throughput-bound training — default to full f32.  Override with
# BPVO_MATMUL_PRECISION=default to opt out.
_prec = _os.environ.get("BPVO_MATMUL_PRECISION", "float32")
if _prec != "default":
    import jax as _jax
    _jax.config.update("jax_default_matmul_precision", _prec)

from bpvo_tpu.config import AlgorithmParameters, ConfigFile
from bpvo_tpu.types import (
    DescriptorType,
    GradientEstimationType,
    InterpolationType,
    KeyFramingReason,
    LossFunctionType,
    OptimizerStatistics,
    PoseEstimationStatus,
    Result,
    VerbosityType,
)

__version__ = "0.1.0"

__all__ = [
    "AlgorithmParameters",
    "ConfigFile",
    "DescriptorType",
    "GradientEstimationType",
    "InterpolationType",
    "KeyFramingReason",
    "LossFunctionType",
    "OptimizerStatistics",
    "PoseEstimationStatus",
    "Result",
    "VerbosityType",
    "VisualOdometry",
]


def __getattr__(name):
    # Lazy import: keep `import bpvo_tpu` light (no jax import) for config-only use.
    if name == "VisualOdometry":
        from bpvo_tpu.vo.odometry import VisualOdometry
        return VisualOdometry
    raise AttributeError(name)
