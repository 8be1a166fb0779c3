"""Analytic synthetic scenes (part of ``vulcan_tpu/io/synthetic.py``).

Exact ray-sphere/plane/box intersections give ground-truth depth images
and an orbiting camera gives ground-truth poses: one sphere
(``render_sphere_depth``, with its signed distance ``sphere_sdf``), the
sphere orbit (``render_scene_depth``) and the cluttered desk
(``render_desk_depth``).
``chip_smoke.py`` makes its frames here, since the port runs without JAX.
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


def sphere_sdf(points: torch.Tensor, center, radius: float) -> torch.Tensor:
    """Signed distance (..., ) of points (..., 3) to a sphere."""
    c = torch.as_tensor(center, dtype=points.dtype, device=points.device)
    return torch.linalg.vector_norm(points - c, dim=-1) - radius


def procedural_color(points: torch.Tensor) -> torch.Tensor:
    """Smooth position-based RGB in [0,1]."""
    k = torch.tensor([3.0, 5.0, 7.0], dtype=points.dtype, device=points.device)
    return 0.5 + 0.5 * torch.sin(points * k)


def render_sphere_depth(
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    center=(0.0, 0.0, 0.0),
    radius: float = 0.5,
    device=None,
):
    """Exact depth (z-depth, 0 = miss) and colour of one sphere, solved as
    the reference solves it.  Returns (depth (H, W), color (H, W, 3)) on
    ``device`` (the CUDA card when None)."""
    device = resolve_device(device)
    pose = pose.to(device)
    d_world = pose.rotate(camera.rays(height, width, device))      # z = 1
    o = pose.translation
    oc = o - torch.as_tensor(center, dtype=torch.float32, device=device)
    # |o + t*d - c|^2 = r^2 for t (d not normalized; t is z-depth).
    a = torch.sum(d_world * d_world, dim=-1)
    b = 2.0 * torch.sum(d_world * oc, dim=-1)
    cc = torch.sum(oc * oc) - radius * radius
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / (2.0 * a)
    hit = (disc >= 0.0) & (t > 0.0)
    depth = torch.where(hit, t, 0.0)
    p = o + t[..., None] * d_world
    color = torch.where(hit[..., None], procedural_color(p), 0.0)
    return depth, color


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
    hits = [_ray_sphere_t(o, d_world, c, r) for c, r in spheres]
    if floor_z is not None:
        hits.append(_ray_floor_t(o, d_world, floor_z))
    for t, ok in hits:
        best_t = torch.where(ok & (t < best_t), t, best_t)
    hit = torch.isfinite(best_t)
    depth = torch.where(hit, best_t, 0.0)
    p = o + depth[..., None] * d_world
    color = torch.where(hit[..., None], procedural_color(p), 0.0)
    return depth, color


# The cluttered-desk scene: a tabletop with ~18 primitives at varied
# depths.  Axis-aligned boxes: ((lo_x, lo_y, lo_z), (hi_x, hi_y, hi_z)).
DESK_BOXES = (
    ((-0.70, -0.50, -0.32), (0.70, 0.50, -0.28)),   # table top
    ((-0.65, -0.45, -0.70), (-0.57, -0.37, -0.32)), # 4 legs
    ((0.57, -0.45, -0.70), (0.65, -0.37, -0.32)),
    ((-0.65, 0.37, -0.70), (-0.57, 0.45, -0.32)),
    ((0.57, 0.37, -0.70), (0.65, 0.45, -0.32)),
    ((-0.30, -0.05, -0.28), (0.10, 0.02, 0.02)),    # monitor panel
    ((-0.14, -0.02, -0.28), (-0.06, 0.06, -0.24)),  # monitor base
    ((0.25, -0.35, -0.28), (0.50, -0.10, -0.22)),   # keyboard
    ((-0.55, -0.40, -0.28), (-0.35, -0.18, -0.12)), # book stack
    ((-0.52, -0.37, -0.12), (-0.38, -0.21, -0.06)),
    ((0.30, 0.18, -0.28), (0.44, 0.32, -0.02)),     # box on desk
)
DESK_SPHERES = (
    ((0.18, 0.28, -0.22), 0.06),                    # mug
    ((-0.18, 0.30, -0.20), 0.08),                   # bowl
    ((0.52, 0.05, -0.23), 0.05),                    # apple
    ((-0.05, -0.38, -0.21), 0.07),                  # ball
    ((0.05, 0.40, -0.16), 0.12),                    # vase
    ((-0.40, 0.12, -0.18), 0.10),                   # globe
    ((0.55, 0.35, -0.19), 0.09),
)
DESK_FLOOR = -0.70


def _ray_sphere_t(o, d_world, center, radius):
    """Nearest z-depth of a ray-sphere hit, with the hit mask."""
    oc = o - torch.tensor(center, dtype=torch.float32, device=o.device)
    a = torch.sum(d_world * d_world, dim=-1)
    b = 2.0 * torch.sum(d_world * oc, dim=-1)
    cc = torch.sum(oc * oc) - radius * radius
    disc = b * b - 4.0 * a * cc
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    return t, (disc >= 0.0) & (t > 0.0)


def _ray_floor_t(o, d_world, floor_z):
    """z-depth where each ray meets the plane z = floor_z, with the mask."""
    dz = d_world[..., 2]
    t = (floor_z - o[2]) / torch.where(torch.abs(dz) > 1e-9, dz, 1e-9)
    return t, (torch.abs(dz) > 1e-9) & (t > 0.0)


def _ray_box_t(o, d_world, lo, hi):
    """Ray-AABB slab intersection; returns (t_entry, hit) with t in z-depth
    units (rays have unit camera-space z, like the spheres)."""
    eps = 1e-9
    inv = 1.0 / torch.where(torch.abs(d_world) > eps, d_world, eps)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_near <= t_far) & (t_far > 0.0) & (t_near > 0.0)
    return t_near, hit


def render_desk_depth(
    camera: PinholeCamera, pose: SE3, height: int, width: int, device=None
):
    """Exact depth + colour of the cluttered desk scene, on ``device`` (the
    CUDA card when None).  The colour is ``procedural_color`` modulated by
    an ~8 cm-scale pattern, so the desk's dominant planes carry intensity
    gradient for photometric tracking."""
    device = resolve_device(device)
    pose = pose.to(device)
    d_world = pose.rotate(camera.rays(height, width, device))
    o = pose.translation
    best_t = torch.full((height, width), float("inf"), device=device)
    hits = [_ray_sphere_t(o, d_world, c, r) for c, r in DESK_SPHERES]
    for lo, hi in DESK_BOXES:
        hits.append(_ray_box_t(
            o, d_world,
            torch.tensor(lo, dtype=torch.float32, device=device),
            torch.tensor(hi, dtype=torch.float32, device=device),
        ))
    hits.append(_ray_floor_t(o, d_world, DESK_FLOOR))
    for t, ok in hits:
        best_t = torch.where(ok & (t < best_t), t, best_t)
    hit = torch.isfinite(best_t)
    depth = torch.where(hit, best_t, 0.0)
    p = o + depth[..., None] * d_world
    tex = 0.80 + 0.20 * (
        torch.sin(p[..., 0] * 80.0) * torch.sin(p[..., 1] * 74.0)
        * torch.sin(p[..., 2] * 68.0)
    )
    color = torch.where(hit[..., None], procedural_color(p) * tex[..., None], 0.0)
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
