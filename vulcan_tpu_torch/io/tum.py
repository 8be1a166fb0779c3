"""TUM RGB-D dataset reader.

Reads the standard TUM format: ``depth.txt`` / ``rgb.txt`` /
``groundtruth.txt`` index files, 16-bit depth PNGs at 1/5000 m per unit,
8-bit RGB PNGs, quaternion ground-truth poses.  Timestamp association uses
the same greedy nearest-neighbor algorithm as the TUM ``associate.py``
tools (``utils/evaluate.py``).

The port's one PNG decoder is its native runtime (``vulcan_tpu_torch/
native``: zlib and the PNG row filters in C++, built at first use).  The
probe, ``load`` and the prefetching ``__iter__`` all go through it; a
failed build or decode raises, nothing falls back to another decoder or
to an assumed image size.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..utils.evaluate import associate_timestamps

DEPTH_SCALE = 5000.0  # TUM: depth PNG units -> meters


def _read_index(path: str):
    ts, files = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ts.append(float(parts[0]))
            files.append(parts[1])
    return np.asarray(ts), files


def _read_groundtruth(path: str):
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts.append(vals[0])
            poses.append(vals[1:8])  # tx ty tz qx qy qz qw
    return np.asarray(ts), np.asarray(poses)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> 3x3 rotation matrix."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass
class TumFrameRef:
    timestamp: float
    depth_path: str
    rgb_path: str | None
    gt_pose: np.ndarray | None  # 4x4 camera-to-world or None


def _pose(ref: TumFrameRef) -> SE3 | None:
    """The frame's ground truth as a CPU float32 SE3, or None."""
    if ref.gt_pose is None:
        return None
    return SE3.from_matrix(torch.from_numpy(ref.gt_pose.astype(np.float32)))


class TumDataset:
    """Associated depth+rgb(+groundtruth) sequence."""

    def __init__(self, root: str, max_dt: float = 0.02):
        self.root = root
        d_ts, d_files = _read_index(os.path.join(root, "depth.txt"))
        rgb_path = os.path.join(root, "rgb.txt")
        frames: list[TumFrameRef] = []
        if os.path.exists(rgb_path):
            r_ts, r_files = _read_index(rgb_path)
            pairs = associate_timestamps(d_ts, r_ts, max_dt)
            entries = [
                (d_ts[i], d_files[i], r_files[j]) for i, j in pairs
            ]
        else:
            entries = [(t, f, None) for t, f in zip(d_ts, d_files)]

        gt_file = os.path.join(root, "groundtruth.txt")
        gt = None
        if os.path.exists(gt_file):
            g_ts, g_poses = _read_groundtruth(gt_file)
            gt = (g_ts, g_poses)

        for t, df, rf in entries:
            pose = None
            if gt is not None:
                k = int(np.argmin(np.abs(gt[0] - t)))
                if abs(float(gt[0][k] - t)) <= max_dt:
                    tx_q = gt[1][k]
                    T = np.eye(4)
                    T[:3, :3] = quat_to_rotmat(tx_q[3:7])
                    T[:3, 3] = tx_q[0:3]
                    pose = T
            frames.append(
                TumFrameRef(
                    t,
                    os.path.join(root, df),
                    os.path.join(root, rf) if rf else None,
                    pose,
                )
            )
        self.frames = frames
        self.camera = self._probe_camera()

    def _probe_camera(self) -> PinholeCamera:
        """fr1 intrinsics, scaled to the sequence's actual image size (a
        fixed 640x480 camera silently breaks fusion geometry on resized
        captures).  The size comes from the first depth PNG's header; a
        failed probe raises."""
        if not self.frames:
            return PinholeCamera.tum_default()
        from .. import native

        w, h = native.png_probe(self.frames[0].depth_path)
        sx, sy = w / 640.0, h / 480.0
        base = PinholeCamera.tum_default()
        return PinholeCamera.create(
            float(base.fx) * sx,
            float(base.fy) * sy,
            (float(base.cx) + 0.5) * sx - 0.5,
            (float(base.cy) + 0.5) * sy - 0.5,
        )

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the sequence's images."""
        from .. import native

        return native.png_probe(self.frames[0].depth_path)

    def __len__(self):
        return len(self.frames)

    def load(self, idx: int):
        """-> (depth (H,W) f32 meters, color (H,W,3) f32, gt_pose SE3|None),
        the pose on the CPU."""
        from .. import native

        ref = self.frames[idx]
        w, h = native.png_probe(ref.depth_path)
        depth = native.decode_depth(ref.depth_path, w, h, DEPTH_SCALE)
        if ref.rgb_path:
            color = native.decode_rgb(ref.rgb_path, w, h)
        else:
            color = np.zeros(depth.shape + (3,), np.float32)
        return depth, color, _pose(ref)

    def __iter__(self):
        """Iterate (depth, color, gt_pose) through the native prefetching
        loader (decode overlaps device compute)."""
        from .. import native

        if not self.frames:
            return
        w, h = self.size
        loader = native.PrefetchLoader(
            [f.depth_path for f in self.frames],
            [f.rgb_path for f in self.frames],
            w,
            h,
            depth_scale=DEPTH_SCALE,
            capacity=4,
            n_threads=2,
        )
        try:
            for ref, (depth, color) in zip(self.frames, loader):
                yield depth, color, _pose(ref)
        finally:
            loader.close()
