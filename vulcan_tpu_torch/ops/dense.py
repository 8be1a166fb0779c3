"""Dense-grid TSDF volume: integration and raycast, and the per-voxel
update rule the sparse integrator shares.

Counterpart of ``vulcan_tpu/ops/dense.py``: the plain (X, Y, Z) voxel grid
with no hashing (BASELINE.json configs 1-2), beside ``voxel_update`` and
``_sample_nearest``, which the online step's sparse integrator uses:

    sdf = depth(project(voxel)) - z_voxel
    if sdf > -mu:  F <- (W*F + w*clamp(sdf/mu)) / (W + w);  W <- min(W+w, Wmax)

TSDF is stored in [-1, 1] (1 = free space), weight 0 = never observed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import Frame
from ..core.se3 import SE3
from ..utils.device import resolve_device

# Pixel coordinates are clamped to this before the float->int32 cast: an
# out-of-range cast gives INT_MIN on the CPU but saturates on CUDA.  Both
# are out of bounds anyway; the clamp makes the two devices agree.
COORD_CLAMP = 1e7


def round_to_int(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (like jnp.round) and cast to int64 indices."""
    return torch.round(torch.clamp(x, -COORD_CLAMP, COORD_CLAMP)).to(torch.int64)


def floor_to_int(x: torch.Tensor) -> torch.Tensor:
    """``floor`` cast to int64 indices, clamped like ``round_to_int``."""
    return torch.floor(torch.clamp(x, -COORD_CLAMP, COORD_CLAMP)).to(torch.int64)


def _sample_nearest(img: torch.Tensor, uv: torch.Tensor):
    """Nearest-neighbour image sample. Returns (values, valid_mask)."""
    h, w = img.shape[0], img.shape[1]
    u = round_to_int(uv[..., 0])
    v = round_to_int(uv[..., 1])
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc = torch.clamp(u, 0, w - 1)
    vc = torch.clamp(v, 0, h - 1)
    return img[vc, uc], ok


def voxel_update(
    tsdf, weight, color, color_weight, sdf, sample_color, valid, config: Config
):
    """Shared per-voxel TSDF + colour running-average update.  Only voxels
    with sdf > -mu are touched; colour is updated inside |sdf| < mu."""
    mu = config.trunc_dist
    update = valid & (sdf > -mu)
    tsdf_obs = torch.clamp(sdf / mu, -1.0, 1.0)
    w_obs = update.to(torch.float32)

    new_weight = weight + w_obs
    new_tsdf = torch.where(
        update,
        (weight * tsdf + w_obs * tsdf_obs) / torch.clamp(new_weight, min=1e-12),
        tsdf,
    )
    new_weight = torch.clamp(new_weight, max=config.max_weight)

    cupdate = update & (torch.abs(sdf) < mu)
    cw_obs = cupdate.to(torch.float32)
    new_cweight = color_weight + cw_obs
    new_color = torch.where(
        cupdate[..., None],
        (color_weight[..., None] * color + cw_obs[..., None] * sample_color)
        / torch.clamp(new_cweight[..., None], min=1e-12),
        color,
    )
    new_cweight = torch.clamp(new_cweight, max=config.max_weight)
    return new_tsdf, new_weight, new_color, new_cweight


@dataclasses.dataclass
class DenseVolumeState:
    """Dense TSDF grid.  ``origin`` = world position of voxel (0,0,0)."""

    shape: tuple[int, int, int]
    tsdf: torch.Tensor          # (X, Y, Z) float32 in [-1, 1]
    weight: torch.Tensor        # (X, Y, Z) float32
    color: torch.Tensor         # (X, Y, Z, 3) float32
    color_weight: torch.Tensor  # (X, Y, Z) float32
    origin: torch.Tensor        # (3,) float32 world coords


def create_dense_volume(shape: tuple[int, int, int], origin,
                        dtype=torch.float32, device=None) -> DenseVolumeState:
    """An empty grid on ``device`` (the CUDA card when None)."""
    device = resolve_device(device)
    shape = tuple(int(n) for n in shape)
    return DenseVolumeState(
        shape=shape,
        tsdf=torch.ones(shape, dtype=dtype, device=device),
        weight=torch.zeros(shape, dtype=dtype, device=device),
        color=torch.zeros(shape + (3,), dtype=dtype, device=device),
        color_weight=torch.zeros(shape, dtype=dtype, device=device),
        origin=torch.as_tensor(origin, dtype=dtype, device=device),
    )


def integrate_dense(volume: DenseVolumeState, frame: Frame,
                    config: Config) -> DenseVolumeState:
    """Fuse one frame into a dense grid: one vectorized pass over every
    voxel (world -> camera -> projective sdf -> running average)."""
    X, Y, Z = volume.shape
    vs = config.voxel_size
    dev = volume.tsdf.device

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=dev)

    ii, jj, kk = torch.meshgrid(ar(X), ar(Y), ar(Z), indexing="ij")
    world = torch.stack([ii, jj, kk], dim=-1) * vs + volume.origin
    cam_pts = frame.pose.inverse().apply(world)
    z = cam_pts[..., 2]
    uv = frame.camera.project(cam_pts)
    depth, in_bounds = _sample_nearest(frame.depth, uv)
    color, _ = _sample_nearest(frame.color, uv)
    valid = (in_bounds & (depth > config.depth_min) & (depth < config.depth_max)
             & (z > 0.0))
    tsdf, weight, col, cweight = voxel_update(
        volume.tsdf, volume.weight, volume.color, volume.color_weight,
        depth - z, color, valid, config,
    )
    return DenseVolumeState(volume.shape, tsdf, weight, col, cweight, volume.origin)


def _trilinear(grid: torch.Tensor, weight: torch.Tensor, pts: torch.Tensor):
    """Trilinear sample of a dense grid at voxel-space points (..., 3).

    Returns (value, ok): ok requires all 8 corners in bounds and observed
    (weight > 0).  ``grid`` may be (X, Y, Z) or (X, Y, Z, C)."""
    X, Y, Z = weight.shape
    p0f = torch.floor(pts)
    frac = pts - p0f
    p0 = floor_to_int(pts)
    g_flat = grid.reshape((X * Y * Z,) + tuple(grid.shape[3:]))
    w_flat = weight.reshape(-1)
    val = torch.zeros(pts.shape[:-1] + grid.shape[3:], dtype=grid.dtype,
                      device=grid.device)
    ok = torch.ones(pts.shape[:-1], dtype=torch.bool, device=grid.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                xi = p0[..., 0] + dx
                yi = p0[..., 1] + dy
                zi = p0[..., 2] + dz
                inb = ((xi >= 0) & (xi < X) & (yi >= 0) & (yi < Y) & (zi >= 0)
                       & (zi < Z))
                idx = ((torch.clamp(xi, 0, X - 1) * Y + torch.clamp(yi, 0, Y - 1))
                       * Z + torch.clamp(zi, 0, Z - 1))
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
                g = g_flat[idx]
                ok = ok & inb & (w_flat[idx] > 0.0)
                val = val + (w[..., None] * g if grid.ndim == 4 else w * g)
    return val, ok


def raycast_dense(volume: DenseVolumeState, camera: PinholeCamera, pose: SE3,
                  height: int, width: int, config: Config) -> dict:
    """Per-pixel ray march through the dense TSDF -> model maps.

    ``raycast_steps`` samples at a fixed 0.75 mu step with sign-change
    detection, then ``refine_steps`` secant rounds on trilinear samples
    (static trip counts, no host read).  Returns a dict with world-space
    depth/vertex/normal/colour maps and a validity mask; invalid pixels
    are zero."""
    vs = config.voxel_size
    dev = volume.tsdf.device
    rays_world = pose.rotate(camera.rays(height, width, dev))   # z-depth 1
    origin = pose.translation

    def sample_tsdf(t):
        p = origin + t[..., None] * rays_world
        return _trilinear(volume.tsdf, volume.weight, (p - volume.origin) / vs)

    step = 0.75 * config.trunc_dist
    shape = (height, width)
    t_hit = torch.zeros(shape, device=dev)
    prev_f = torch.ones(shape, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    f32 = np.float32
    for i in range(config.raycast_steps):
        # float32 arithmetic, as the reference's traced loop index.
        t = torch.full((), float(f32(config.ray_near) + f32(i) * f32(step)),
                       device=dev)
        f, ok = sample_tsdf(t)
        crossing = ok & (prev_f > 0.0) & (f <= 0.0) & ~done
        t_hit = torch.where(crossing, t, t_hit)
        done = done | crossing
        prev_f = torch.where(ok, f, prev_f)
    hit = done

    # Secant refinement between t_hit - step (F > 0) and t_hit (F <= 0).
    t_lo = t_hit - step
    t_hi = t_hit
    for _ in range(config.refine_steps):
        f_lo, _ = sample_tsdf(t_lo)
        f_hi, _ = sample_tsdf(t_hi)
        denom = f_lo - f_hi
        alpha = torch.where(torch.abs(denom) > 1e-12, f_lo / denom, 0.5)
        t_mid = t_lo + torch.clamp(alpha, 0.0, 1.0) * (t_hi - t_lo)
        f_mid, _ = sample_tsdf(t_mid)
        t_lo, t_hi = (torch.where(f_mid > 0.0, t_mid, t_lo),
                      torch.where(f_mid > 0.0, t_hi, t_mid))
    t_surf = 0.5 * (t_lo + t_hi)

    p_surf = origin + t_surf[..., None] * rays_world
    vox = (p_surf - volume.origin) / vs

    # Normal = normalized TSDF gradient (central differences of trilinear).
    def grad_axis(axis):
        e = torch.zeros(3, device=dev)
        e[axis] = 0.5
        fp, okp = _trilinear(volume.tsdf, volume.weight, vox + e)
        fm, okm = _trilinear(volume.tsdf, volume.weight, vox - e)
        return fp - fm, okp & okm

    gx, okx = grad_axis(0)
    gy, oky = grad_axis(1)
    gz, okz = grad_axis(2)
    g = torch.stack([gx, gy, gz], dim=-1)
    gn = torch.sqrt(gx * gx + gy * gy + gz * gz)[..., None]
    normal = g / torch.clamp(gn, min=1e-12)
    n_ok = okx & oky & okz & (gn[..., 0] > 1e-12)

    color, _ = _trilinear(volume.color, volume.weight, vox)

    valid = hit & n_ok
    m = valid[..., None]
    depth = torch.where(valid, t_surf, 0.0)
    return {
        "t": depth,
        "depth": depth,      # rays have z = 1, so t is the z-depth
        "vertex_world": torch.where(m, p_surf, 0.0),
        "normal_world": torch.where(m, normal, 0.0),
        "color": torch.where(m, color, 0.0),
        "valid": valid,
    }
