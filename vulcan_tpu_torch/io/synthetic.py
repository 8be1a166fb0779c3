"""Analytic synthetic scenes (part of ``vulcan_tpu/io/synthetic.py``).

Exact ray-sphere/plane intersections give ground-truth depth images and an
orbiting camera gives ground-truth poses; ``chip_smoke.py`` makes its
frames here, since the port runs without JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..utils.device import resolve_device


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> SE3:
    """Camera-to-world pose with +z looking from eye toward target
    (camera x right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-9:
        x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)  # columns = camera axes in world
    return SE3(
        torch.from_numpy(R.astype(np.float32)),
        torch.from_numpy(eye.astype(np.float32)),
    )


def orbit_poses(
    n: int, center=(0.0, 0.0, 0.0), radius: float = 1.5, height: float = 0.4,
    span: float = 2.0 * np.pi,
) -> list[SE3]:
    """n camera poses on a circle around ``center``, looking inward."""
    poses = []
    center = np.asarray(center, np.float64)
    for i in range(n):
        a = span * i / max(n, 1)
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a), height])
        poses.append(look_at(eye, center))
    return poses


def procedural_color(points: torch.Tensor) -> torch.Tensor:
    """Smooth position-based RGB in [0,1]."""
    k = torch.tensor([3.0, 5.0, 7.0], dtype=points.dtype, device=points.device)
    return 0.5 + 0.5 * torch.sin(points * k)


def render_scene_depth(
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    spheres=(((0.0, 0.0, 0.0), 0.5),),
    floor_z: float | None = None,
    device=None,
):
    """Depth (z-depth, 0 = miss) and colour of a union of spheres plus an
    optional z=floor_z plane, exact.  Returns (depth (H, W), color (H, W, 3))
    on ``device`` (the CUDA card when None)."""
    device = resolve_device(device)
    pose = pose.to(device)
    d_world = pose.rotate(camera.rays(height, width, device))
    o = pose.translation
    best_t = torch.full((height, width), float("inf"), device=device)
    a = torch.sum(d_world * d_world, dim=-1)
    for center, radius in spheres:
        oc = o - torch.tensor(center, dtype=torch.float32, device=device)
        b = 2.0 * torch.sum(d_world * oc, dim=-1)
        cc = torch.sum(oc * oc) - radius * radius
        disc = b * b - 4.0 * a * cc
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
        ok = (disc >= 0.0) & (t > 0.0)
        best_t = torch.where(ok & (t < best_t), t, best_t)
    if floor_z is not None:
        dz = d_world[..., 2]
        safe = torch.where(torch.abs(dz) > 1e-9, dz, 1e-9)
        t = (floor_z - o[2]) / safe
        ok = (torch.abs(dz) > 1e-9) & (t > 0.0)
        best_t = torch.where(ok & (t < best_t), t, best_t)
    hit = torch.isfinite(best_t)
    depth = torch.where(hit, best_t, 0.0)
    p = o + depth[..., None] * d_world
    color = torch.where(hit[..., None], procedural_color(p), 0.0)
    return depth, color


def add_depth_noise(
    depth,
    rng: np.random.Generator,
    sigma_base: float = 1.2e-3,
    sigma_quad: float = 1.9e-3,
    dropout: float = 0.02,
    hole_count: int = 4,
    hole_radius: int = 6,
    quantize: float = 1.0 / 5000.0,
):
    """Kinect-class sensor noise on an exact synthetic depth image (axial
    noise growing with range, dropout, blob holes, uint16 quantization).
    Returns a float32 numpy array; invalid stays 0."""
    d = np.asarray(depth, np.float32).copy()
    valid = d > 0.0
    z = np.where(valid, d, 1.0)
    sigma = sigma_base + sigma_quad * np.square(np.maximum(z - 0.4, 0.0))
    d = d + np.where(valid, rng.normal(0.0, 1.0, d.shape) * sigma, 0.0)
    drop = rng.uniform(size=d.shape) < dropout
    h, w = d.shape
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(hole_count):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(hole_radius // 2, hole_radius + 1)
        drop |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    d = np.where(valid & ~drop, d, 0.0)
    if quantize > 0:
        d = np.round(d / quantize) * quantize
    return d.astype(np.float32)
