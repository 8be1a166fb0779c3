"""Model render container, the renderer dispatch and image-space normals.

Part of ``vulcan_tpu/ops/raycast.py``: the ``Render`` maps that the tracker
consumes, ``render`` (the renderer named by ``Config.render_mode``) and
``_cross_normals_axes``.  The port renders with the surfel splat
(``ops/splat.py``); the hierarchical ray march (``render_mode="march"``)
and gradient normals are not ported (ROADMAP.md queue 1 item 6) and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from .preprocess import _shift2d


@dataclasses.dataclass(frozen=True)
class Render:
    """Rendered model maps; vertex/normal channels are planar (H, W)."""

    depth: torch.Tensor          # (H, W) z-depth, 0 invalid
    vx: torch.Tensor             # (H, W) world vertex channels
    vy: torch.Tensor
    vz: torch.Tensor
    nx: torch.Tensor             # (H, W) world unit normal channels, 0 invalid
    ny: torch.Tensor
    nz: torch.Tensor
    color: torch.Tensor          # (H, W, 3)
    valid: torch.Tensor          # (H, W) bool
    camera: PinholeCamera
    pose: SE3                    # camera-to-world used for the render


def render(
    volume,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    normals: str = "cross",
    with_color: bool = True,
    color_space: str = "rgb",
) -> Render:
    """Render model maps with the configured renderer.  ``color_space=
    "luma"`` renders a grey intensity image (see ``ops/splat.py``)."""
    if config.render_mode == "march":
        raise NotImplementedError(
            'render_mode="march": the hierarchical ray march is not ported yet '
            "(ROADMAP.md queue 1 item 6)"
        )
    if normals == "gradient":
        raise NotImplementedError(
            'normals="gradient": TSDF-gradient normals come with the ray march, '
            "which is not ported yet (ROADMAP.md queue 1 item 6)"
        )
    from . import splat

    return splat.render_splat(
        volume, camera, pose, height, width, config,
        with_color=with_color, color_space=color_space,
    )


def _cross_normals_axes(px, py, pz, hit):
    """Image-space forward-difference cross-product normals, planar."""
    e1x = _shift2d(px, 0, 1) - px
    e1y = _shift2d(py, 0, 1) - py
    e1z = _shift2d(pz, 0, 1) - pz
    e2x = _shift2d(px, 1, 0) - px
    e2y = _shift2d(py, 1, 0) - py
    e2z = _shift2d(pz, 1, 0) - pz
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    hf = hit.to(torch.float32)
    hr = _shift2d(hf, 0, 1) > 0.5
    hd = _shift2d(hf, 1, 0) > 0.5
    ok = hit & hr & hd & (norm > 1e-12)
    inv = 1.0 / torch.clamp(norm, min=1e-12)
    return nx * inv, ny * inv, nz * inv, ok
