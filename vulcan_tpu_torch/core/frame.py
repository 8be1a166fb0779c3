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

import numpy as np
import torch

from ..utils.device import resolve_device
from .camera import PinholeCamera
from .se3 import SE3


@dataclasses.dataclass(frozen=True)
class Frame:
    depth: torch.Tensor
    color: torch.Tensor
    camera: PinholeCamera
    pose: SE3

    @property
    def height(self) -> int:
        return self.depth.shape[-2]

    @property
    def width(self) -> int:
        return self.depth.shape[-1]


@dataclasses.dataclass(frozen=True)
class FrameMaps:
    """Derived per-pixel geometry for one pyramid level (camera space)."""

    depth: torch.Tensor                # (H, W)
    vertices: torch.Tensor             # (H, W, 3) camera-space vertex map
    normals: torch.Tensor              # (H, W, 3) unit normals (0 invalid)
    intensity: Optional[torch.Tensor]  # (H, W) grayscale, or None
    camera: PinholeCamera


def _to_f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float32)     # a copy: numpy may be read-only
        return torch.from_numpy(x).to(device)
    return x.to(device=device, dtype=torch.float32)


def make_frame(
    depth,
    color=None,
    camera: Optional[PinholeCamera] = None,
    pose: Optional[SE3] = None,
    device=None,
) -> Frame:
    """A frame on ``device`` (the CUDA card when None; ``device="cpu"`` for
    the CPU) from numpy arrays or tensors, converted to float32 as they are
    (no unit scaling).  Defaults: zero colour, ``PinholeCamera.tum_default()``
    and the identity pose."""
    device = resolve_device(device)
    depth = _to_f32(depth, device)
    if color is None:
        color = torch.zeros(depth.shape + (3,), dtype=torch.float32, device=device)
    if camera is None:
        camera = PinholeCamera.tum_default()
    if pose is None:
        pose = SE3.identity()
    return Frame(depth, _to_f32(color, device), camera, pose.to(device))
