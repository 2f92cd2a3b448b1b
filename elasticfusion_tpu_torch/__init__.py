"""PyTorch/CUDA port of the ElasticFusion dense RGB-D surfel SLAM engine.

Same module names as the JAX reference package so a reader finds the
counterpart; plain functions on tensors inside.  float32 throughout and no
TF32: both switches are set here, once, when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ._device import resolve_device  # noqa: E402
from .config import CameraConfig, EngineConfig  # noqa: E402

__all__ = ["CameraConfig", "EngineConfig", "resolve_device"]
