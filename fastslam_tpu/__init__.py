"""fastslam_tpu — a FastSLAM 2.0 engine in JAX/XLA/Pallas for NVIDIA GPUs.

Public API: the reference's 14 exports (``/root/reference/fast_slam_2/
__init__.py:5-22``) plus the SoA engine types.  Reference users switch
``from fast_slam_2 import X`` to ``from fastslam_tpu import X``.
"""

# reference-compatible surface
from fastslam_tpu.api import (
    FastSLAM2,
    GeometryUtils,
    HoughTransformation,
    ICP,
    LandmarkUtils,
    LineFilter,
)
from fastslam_tpu.drivers.robot import EvaluationUtils, Robot, Serializer
from fastslam_tpu.models import (
    DirectedPoint,
    Landmark,
    Measurement,
    Particle,
    Point,
)

# engine-native surface
from fastslam_tpu.app.runner import run_driver
from fastslam_tpu.drivers.jderobot_hal import HALDriver
from fastslam_tpu.config import DEFAULT_CONFIG, FastSLAMConfig
from fastslam_tpu.core.state import FilterState, Measurements, init_state, pad_measurements
from fastslam_tpu.core.kernels import fastslam_step

__all__ = [
    # reference-compatible
    "FastSLAM2",
    "HoughTransformation",
    "ICP",
    "LineFilter",
    "DirectedPoint",
    "Landmark",
    "Measurement",
    "Particle",
    "Point",
    "GeometryUtils",
    "LandmarkUtils",
    "Robot",
    "EvaluationUtils",
    "Serializer",
    # engine-native
    "DEFAULT_CONFIG",
    "FastSLAMConfig",
    "FilterState",
    "Measurements",
    "init_state",
    "pad_measurements",
    "fastslam_step",
    "run_driver",
    "HALDriver",
]

__version__ = "0.1.0"
