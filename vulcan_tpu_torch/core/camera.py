"""Pinhole camera model.

Counterpart of ``vulcan_tpu/core/camera.py``.  A 3D point (x, y, z) in
camera space projects to u = fx * x / z + cx, v = fy * y / z + cy, and
integer pixel (u, v) samples at exactly those coordinates.

Intrinsics are Python floats holding float32 values (the reference keeps
them as 0-d float32 arrays), and ``scaled``/``subsampled`` compute in
float32, so both packages work with bit-identical intrinsics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx, fy, cx, cy) -> "PinholeCamera":
        return PinholeCamera(*(float(_f32(v)) for v in (fx, fy, cx, cy)))

    @staticmethod
    def tum_default() -> "PinholeCamera":
        """TUM RGB-D freiburg1 default intrinsics at 640x480."""
        return PinholeCamera.create(517.3, 516.5, 318.6, 255.3)

    def project(self, points: torch.Tensor) -> torch.Tensor:
        """Camera-space points (...,3) -> pixel coords (...,2) = (u, v).

        z <= 0 points project to -1e9 so callers can bounds-check
        uniformly instead of branching.
        """
        z = points[..., 2]
        bad = z <= 1e-12
        safe_z = torch.where(bad, torch.ones_like(z), z)
        u = self.fx * points[..., 0] / safe_z + self.cx
        v = self.fy * points[..., 1] / safe_z + self.cy
        big = torch.full_like(u, -1e9)
        return torch.stack(
            [torch.where(bad, big, u), torch.where(bad, big, v)], dim=-1
        )

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixels (...,2) + depth (...,) -> camera-space points (...,3)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def pixel_grid(self, height: int, width: int, device=None) -> torch.Tensor:
        """(H, W, 2) tensor of (u, v) pixel coordinates."""
        v = torch.arange(height, dtype=torch.float32, device=device)
        u = torch.arange(width, dtype=torch.float32, device=device)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        return torch.stack([uu, vv], dim=-1)

    def rays(self, height: int, width: int, device=None) -> torch.Tensor:
        """(H, W, 3) camera-space ray directions with z=1 (not normalized)."""
        uv = self.pixel_grid(height, width, device)
        return self.unproject(uv, torch.ones_like(uv[..., 0]))

    def subsampled(self, step: int) -> "PinholeCamera":
        """Intrinsics for nearest ``[::step, ::step]`` subsampling (output
        pixel i maps to input pixel ``step * i``: no half-pixel shift)."""
        s = _f32(1.0 / step)
        return PinholeCamera(
            *(float(_f32(v) * s) for v in (self.fx, self.fy, self.cx, self.cy))
        )

    def scaled(self, factor: float) -> "PinholeCamera":
        """Intrinsics for an image downsampled by ``factor`` (e.g. 0.5):
        fx' = fx * s, cx' = (cx + 0.5) * s - 0.5."""
        s = _f32(factor)
        half = _f32(0.5)
        return PinholeCamera(
            float(_f32(self.fx) * s),
            float(_f32(self.fy) * s),
            float((_f32(self.cx) + half) * s - half),
            float((_f32(self.cy) + half) * s - half),
        )
