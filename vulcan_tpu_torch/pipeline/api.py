"""Online pipeline driver (the ``Pipeline`` of ``vulcan_tpu/pipeline/api.py``).

The five-class API (``Volume``, ``Integrator``, ``Tracer``, ``Tracker``,
``Extractor``) and snapshots are still to be ported (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..utils.device import resolve_device
from . import fusion


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:       # torch tensors cannot wrap read-only memory
        x = x.copy()
    return torch.from_numpy(x).to(device)


class Pipeline:
    """Full online loop: track + fuse + render per frame on ``device``
    (the CUDA card when None; ``device="cpu"`` runs the plain versions).
    ``mode`` is the tracking mode: "depth", "color", "combined" or
    "light"."""

    def __init__(
        self,
        config: Config,
        camera: PinholeCamera,
        height: int,
        width: int,
        init_pose: SE3 | None = None,
        mode: str = "depth",
        device=None,
    ):
        fusion.check_supported(config, mode)
        self.config = config
        self.height = height
        self.width = width
        self.mode = mode
        self.device = resolve_device(device)
        self.state = fusion.init_state(
            config, camera, height, width, init_pose, self.device
        )

    def process(self, depth, color=None, pose: SE3 | None = None) -> None:
        """Feed one frame (numpy arrays or tensors).  With ``pose`` given
        (camera-to-world), fuse at that pose without tracking.  uint16
        depth (TUM raw units) and uint8 colour are uploaded as they are and
        converted on the device; other dtypes are converted to float32."""
        depth = _as_tensor(depth, self.device)
        if depth.dtype not in (torch.uint16, torch.float32):
            depth = depth.to(torch.float32)
        if color is None:
            color = torch.zeros(depth.shape + (3,), device=self.device)
        color = _as_tensor(color, self.device)
        if color.dtype not in (torch.uint8, torch.float32):
            color = color.to(torch.float32)
        if pose is not None:
            self.state = fusion.step_known_pose(
                self.state, depth, color, pose.to(self.device), self.config
            )
        else:
            self.state = fusion.step(
                self.state, depth, color, self.config, self.mode
            )

    @property
    def pose(self) -> SE3:
        return self.state.pose

    def diagnostics(self) -> dict:
        s = self.state
        return {
            "frame": int(s.frame_idx),
            "track_error": float(s.track_error),
            "track_inliers": int(s.track_inliers),
            "track_failures": int(s.track_failures),
            "track_level_error": [round(float(x), 6) for x in s.track_level_error],
            "track_level_inliers": [int(x) for x in s.track_level_inliers],
            "track_level_degen": [round(float(x), 6) for x in s.track_level_degen],
            "track_degen_frames": int(s.track_degen_frames),
            "photo_armed_frames": s.photo_cnt_host,
            "allocated_blocks": int(s.volume.free_count) - 1,
            "visible_blocks": int(s.volume.num_visible),
            "alloc_overflow": int(s.volume.alloc_overflow),
            "visible_overflow": int(s.volume.visible_overflow),
        }
