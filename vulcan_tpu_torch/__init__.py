"""vulcan_tpu_torch: the PyTorch + CUDA port of vulcan_tpu (the online step
under either renderer, marching cubes, the five-class API and the
dense-grid backend).

The JAX package ``vulcan_tpu`` is the reference; this package imports
neither it nor JAX.  Plain tensor code is PyTorch; the reference's Pallas
kernels are hand-written CUDA kernels for Hopper (``csrc/``), built with
nvcc at first use (``ops/cuda_kernels.py``).

The reference runs its SE3 products at ``Precision.HIGHEST``.  Reduced
precision broke tracking once already, so importing the port pins float32
matmuls and convolutions to full float32 (no TF32).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import TINY, Config  # noqa: E402
from .core.camera import PinholeCamera  # noqa: E402
from .core.frame import Frame, make_frame  # noqa: E402
from .core.se3 import SE3  # noqa: E402
from .ops.light import Light  # noqa: E402
from .pipeline.api import (  # noqa: E402
    ColorTracker,
    DepthTracker,
    Extractor,
    Integrator,
    LightTracker,
    Pipeline,
    Tracer,
    Tracker,
    Volume,
)

__all__ = [
    "Config", "TINY", "PinholeCamera", "Frame", "make_frame", "SE3", "Light",
    "Volume", "Integrator", "Tracer", "Tracker", "DepthTracker", "ColorTracker",
    "LightTracker", "Extractor", "Pipeline",
]
