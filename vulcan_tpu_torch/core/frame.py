"""Frame and pyramid containers.

Counterpart of ``vulcan_tpu/core/frame.py``:

  * ``depth``: (H, W) float32 meters; 0.0 marks invalid pixels.
  * ``color``: (H, W, 3) float32 in [0, 1].
  * ``pose``: camera-to-world SE3.
  * vertex/normal maps are camera-space; invalid entries are all-zero.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .camera import PinholeCamera
from .se3 import SE3


@dataclasses.dataclass(frozen=True)
class Frame:
    depth: torch.Tensor
    color: torch.Tensor
    camera: PinholeCamera
    pose: SE3


@dataclasses.dataclass(frozen=True)
class FrameMaps:
    """Derived per-pixel geometry for one pyramid level (camera space)."""

    depth: torch.Tensor                # (H, W)
    vertices: torch.Tensor             # (H, W, 3) camera-space vertex map
    normals: torch.Tensor              # (H, W, 3) unit normals (0 invalid)
    intensity: Optional[torch.Tensor]  # (H, W) grayscale, or None
    camera: PinholeCamera
