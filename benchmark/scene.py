"""The benchmark's traffic generator: analytic RGB-D frames of a scene that
a traffic file describes, seen from a camera that circles it.

A frozen copy, batched and moved onto the device, of
``vulcan_tpu_torch/io/synthetic.py`` (``look_at``, ``orbit_poses``,
``procedural_color``, the ray-sphere and ray-box hits of
``render_scene_depth`` / ``render_desk_depth``, ``add_depth_noise``), so
that later changes to the program do not change the benchmark's inputs;
a scene may stand on an open floor (a plane, as the program's scenes
do) or in a room (walls, floor and ceiling of a box seen from inside).
Only torch and numpy: nothing of the program.

One turn of the trajectory is rendered at set-up, in batches on the
device, with the sensor noise drawn from a ``torch.Generator`` seeded by
``--seed``; the frames are handed to the system as host arrays (uint16
depth in 1/5000 m, uint8 rgb), as a sensor driver hands them over.  The
trajectory loops, so frame ``i`` is frame ``i % turn``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BATCH = 16      # frames rendered per batch on the device


@dataclasses.dataclass
class Stream:
    """One turn of frames: host ``depth`` (n, H, W) uint16, ``color``
    (n, H, W, 3) uint8 and the true camera-to-world poses ``rotation``
    (n, 3, 3) / ``translation`` (n, 3) float32."""

    depth: np.ndarray
    color: np.ndarray
    rotation: np.ndarray
    translation: np.ndarray

    def __len__(self) -> int:
        return self.depth.shape[0]

    def frame(self, i: int):
        k = i % len(self)
        return self.depth[k], self.color[k]


def turn_length(traffic: dict) -> int:
    """Frames in one turn of the circle."""
    return int(round(360.0 / float(traffic["trajectory"]["deg_per_frame"])))


def look_at(eye, target, up=(0.0, 0.0, 1.0), dtype=torch.float64):
    """Camera-to-world rotations (n, 3, 3) and translations (n, 3) with +z
    looking from ``eye`` (n, 3) toward ``target`` (camera x right, y down,
    z forward), computed in ``dtype``."""
    eye = torch.as_tensor(eye, dtype=dtype)
    target = torch.as_tensor(target, dtype=dtype).expand_as(eye)
    up = torch.as_tensor(up, dtype=dtype).expand_as(eye)
    z = target - eye
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    x = torch.cross(z, up, dim=-1)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1), eye


def trajectory(traffic: dict, dtype=torch.float64):
    """The true poses of one turn, in ``dtype``: (rotation, translation)."""
    tr = traffic["trajectory"]
    n = turn_length(traffic)
    a = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
    c = torch.tensor(tr["center"], dtype=torch.float64)
    r, h = float(tr["radius"]), float(tr["height"])
    eye = c + torch.stack([r * torch.cos(a), r * torch.sin(a),
                           torch.full_like(a, h)], dim=-1)
    return look_at(eye.to(dtype), c.to(dtype), dtype=dtype)


def _sphere_t(o, d, center, radius):
    oc = o - torch.tensor(center, dtype=o.dtype, device=o.device)
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(d * oc[:, None, None, :], dim=-1)
    cc = torch.sum(oc * oc, dim=-1)[:, None, None] - radius * radius
    disc = b * b - 4.0 * a * cc
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    return t, (disc >= 0.0) & (t > 0.0)


def _box_t(o, d, lo, hi):
    eps = 1e-9
    lo = torch.tensor(lo, dtype=o.dtype, device=o.device)
    hi = torch.tensor(hi, dtype=o.dtype, device=o.device)
    inv = 1.0 / torch.where(torch.abs(d) > eps, d, eps)
    oo = o[:, None, None, :]
    t0 = (lo - oo) * inv
    t1 = (hi - oo) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_near, (t_near <= t_far) & (t_far > 0.0) & (t_near > 0.0)


def _floor_t(o, d, z):
    """Where each ray meets the plane z = ``z`` (an open floor)."""
    dz = d[..., 2]
    t = (z - o[:, None, None, 2]) / torch.where(torch.abs(dz) > 1e-9, dz, 1e-9)
    return t, (torch.abs(dz) > 1e-9) & (t > 0.0)


def _room_t(o, d, lo, hi):
    """Where a ray from inside the box [lo, hi] leaves it: its walls,
    floor and ceiling."""
    eps = 1e-9
    lo = torch.tensor(lo, dtype=o.dtype, device=o.device)
    hi = torch.tensor(hi, dtype=o.dtype, device=o.device)
    dd = torch.where(torch.abs(d) > eps, d, eps)
    oo = o[:, None, None, :]
    t = torch.where(dd > 0, (hi - oo) / dd, (lo - oo) / dd)
    t_exit = torch.amin(t, dim=-1)
    return t_exit, t_exit > 0.0


def render(scene: dict, sensor: dict, rotation, translation):
    """Exact z-depth (n, H, W) (0 = miss) and rgb in [0, 1] (n, H, W, 3)
    of ``scene`` from the poses (n, 3, 3) / (n, 3), float32 on their
    device."""
    h, w = sensor["height"], sensor["width"]
    dev = rotation.device
    v = torch.arange(h, dtype=torch.float32, device=dev)
    u = torch.arange(w, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    f32 = np.float32
    rays = torch.stack([(uu - float(f32(sensor["cx"]))) / float(f32(sensor["fx"])),
                        (vv - float(f32(sensor["cy"]))) / float(f32(sensor["fy"])),
                        torch.ones_like(uu)], dim=-1)                 # z = 1
    d = torch.einsum("nij,hwj->nhwi", rotation, rays)
    o = translation
    hits = [_sphere_t(o, d, c, r) for c, r in scene["spheres"]]
    hits += [_box_t(o, d, lo, hi) for lo, hi in scene["boxes"]]
    if scene.get("floor") is not None:
        hits.append(_floor_t(o, d, scene["floor"]))
    if scene.get("room") is not None:
        hits.append(_room_t(o, d, *scene["room"]))
    best = torch.full(d.shape[:-1], float("inf"), device=dev)
    for t, ok in hits:
        best = torch.where(ok & (t < best), t, best)
    hit = torch.isfinite(best)
    depth = torch.where(hit, best, 0.0)
    p = o[:, None, None, :] + depth[..., None] * d
    k = torch.tensor([3.0, 5.0, 7.0], device=dev)
    color = 0.5 + 0.5 * torch.sin(p * k)
    tex = scene.get("texture")
    if tex is not None:
        t = 0.80 + 0.20 * (torch.sin(p[..., 0] * tex[0]) * torch.sin(p[..., 1] * tex[1])
                           * torch.sin(p[..., 2] * tex[2]))
        color = color * t[..., None]
    return depth, torch.where(hit[..., None], color, 0.0)


def add_noise(depth, noise: dict, units: float, gen: torch.Generator):
    """Kinect-class sensor noise on exact depth (n, H, W) in metres, drawn
    from ``gen`` on the depth's device: axial noise growing with range,
    dropout, blob holes; returns uint16 in 1/``units`` m (0 = invalid)."""
    n, h, w = depth.shape
    dev = depth.device
    valid = depth > 0.0
    z = torch.where(valid, depth, 1.0)
    sigma = noise["sigma_base"] + noise["sigma_quad"] * torch.square(
        torch.clamp(z - 0.4, min=0.0))
    g = torch.randn(depth.shape, generator=gen, device=dev)
    d = depth + torch.where(valid, g * sigma, 0.0)
    drop = torch.rand(depth.shape, generator=gen, device=dev) < noise["dropout"]
    k, rad = int(noise["hole_count"]), int(noise["hole_radius"])
    if k:
        cy = torch.randint(0, h, (n, k), generator=gen, device=dev)
        cx = torch.randint(0, w, (n, k), generator=gen, device=dev)
        r = torch.randint(rad // 2, rad + 1, (n, k), generator=gen, device=dev)
        yy = torch.arange(h, device=dev)[None, None, :, None]
        xx = torch.arange(w, device=dev)[None, None, None, :]
        disc = ((yy - cy[..., None, None]) ** 2 + (xx - cx[..., None, None]) ** 2
                < (r * r)[..., None, None])
        drop |= disc.any(dim=1)
    d = torch.where(valid & ~drop, d, 0.0)
    return torch.clamp(torch.round(d * units), 0, 65535).to(torch.int32).to(torch.uint16)


def make_stream(traffic: dict, sensor: dict, seed: int, device) -> Stream:
    """One turn of ``traffic``'s frames, the noise drawn from ``seed``."""
    rot64, trans64 = trajectory(traffic)
    rot = rot64.to(torch.float32)
    trans = trans64.to(torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    units = float(sensor["depth_units_per_m"])
    n = rot.shape[0]
    h, w = sensor["height"], sensor["width"]
    depth = np.empty((n, h, w), np.uint16)
    color = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, BATCH):
        r = rot[s:s + BATCH].to(device)
        t = trans[s:s + BATCH].to(device)
        d, c = render(traffic["scene"], sensor, r, t)
        depth[s:s + BATCH] = add_noise(d, traffic["noise"], units, gen).cpu().numpy()
        color[s:s + BATCH] = torch.clamp(torch.round(c * 255.0), 0, 255).to(
            torch.uint8).cpu().numpy()
    return Stream(depth, color, rot.numpy(), trans.numpy())
