"""Shared fixtures of the ``test_torch_*`` files: one scene, one config,
and helpers that carry values between the JAX package (the reference) and
the PyTorch port as numpy arrays."""
import dataclasses

import numpy as np
import torch

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.core.camera import PinholeCamera as JCam
from vulcan_tpu.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu_torch.core.se3 import SE3 as TSE3
from vulcan_tpu_torch.utils.convert import flatten

# The suite runs as several worker processes on the machine's cores: one
# intra-op thread a worker keeps PyTorch's thread pools from spinning
# against each other (with a pool as wide as the machine in every worker,
# a 150x200 port step ran ~50x slower than alone).
torch.set_num_threads(1)

# tests/test_pipeline.py's closed-loop configuration and scene.
_KW = dict(
    voxel_size=0.015,
    trunc_dist=0.06,
    icp_iters=(4, 5, 16),
    num_blocks=8192,
    hash_size=32768,
    max_visible=8192,
    depth_max=4.0,
)
CFG_J = dataclasses.replace(J_TINY, **_KW)
CFG_T = dataclasses.replace(P.TINY, **_KW)
CAM_J = JCam.create(160.0, 160.0, 99.5, 74.5)
CAM_T = P.PinholeCamera.create(160.0, 160.0, 99.5, 74.5)
H, W = 150, 200
SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
)
FLOOR = -0.6


def orbit(n, span_per_frame=0.9 * np.pi / 16):
    """JAX ground-truth poses of the closed-loop orbit (~18 cm/frame)."""
    return orbit_poses(n, (0.0, 0.0, 0.0), radius=1.6, height=0.35,
                       span=span_per_frame * n)


def scene(pose_j):
    """(depth (H, W), color (H, W, 3)) float32 numpy frames, rendered by
    the reference's synthetic scene."""
    d, c = render_scene_depth(CAM_J, pose_j, H, W, SPHERES, FLOOR)
    return np.asarray(d), np.asarray(c)


def jflat(obj):
    """Flatten a JAX dataclass tree to {dotted path: numpy copy}; copies,
    so a later donated step cannot invalidate the arrays."""
    return {k: np.array(v, copy=True) for k, v in flatten(obj).items()}


def t(x):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True))


def se3_t(p) -> TSE3:
    """A JAX package SE3 -> the port's."""
    return TSE3(t(p.rotation), t(p.translation))


def close_frac(a, b, atol):
    """Fraction of entries of two arrays that differ by more than atol."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64)) > atol))



def rot_angle(Ra, Rb):
    """Angle (rad) between two float32 rotations, from the antisymmetric
    part of Ra^T Rb: unlike arccos of the trace, it stays accurate for
    small angles when the matrices are orthonormal only to float32."""
    m = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = 0.5 * np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))
