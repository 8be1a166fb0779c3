"""Batched block allocation and visible-block compaction.

Counterpart of ``vulcan_tpu/ops/allocate.py``: per-pixel truncation-band
samples -> candidate block codes -> sort + neighbour-compare dedup ->
cumsum compaction to a fixed-capacity batch -> the hash's deterministic
batched insertion.  Dropped candidates are counted, never silently lost.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from . import blocks as B
from . import hashing


@functools.lru_cache(maxsize=8)
def _band_offsets(mu: float, k: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(-mu, mu, k, dtype=float32)`` to the bit: jnp computes
    ``start * (1 - s) + stop * s`` with s = i / (k-1) in float32 (fused to
    one FMA on the CPU) and sets the last entry to ``stop`` exactly.  Cached
    per device: rebuilding it would be a host->device copy, which PyTorch
    follows with a stream sync, every frame."""
    f32 = np.float32
    lo, hi = f32(-mu), f32(mu)
    if k == 1:
        return torch.tensor([lo], device=device)
    s = (np.arange(k - 1, dtype=f32) / f32(k - 1)).astype(f32)
    b = (hi * s).astype(f32)
    out = (np.float64(lo) * (f32(1) - s).astype(np.float64) + b).astype(f32)
    return torch.from_numpy(np.append(out, hi).astype(f32)).to(device)


def candidate_block_codes(
    depth: torch.Tensor, camera: PinholeCamera, pose: SE3, config: Config
) -> torch.Tensor:
    """Packed block codes touched by the truncation band of each depth
    ray.  Returns (N,) int32 with INVALID_CODE holes, where
    N = ceil(H/ss) * ceil(W/ss) * alloc_samples."""
    ss = config.alloc_subsample
    d = depth[::ss, ::ss]
    uv = camera.pixel_grid(depth.shape[0], depth.shape[1], depth.device)[::ss, ::ss]
    rays_cam = camera.unproject(uv, torch.ones_like(d))        # z = 1
    rays_world = pose.rotate(rays_cam)
    origin = pose.translation

    mu = config.trunc_dist
    offs = _band_offsets(mu, config.alloc_samples, depth.device)
    t = d[..., None] + offs                                       # (h, w, k)
    pts = origin + t[..., None] * rays_world[:, :, None, :]       # (h, w, k, 3)
    coords = torch.floor(pts / config.block_extent).to(torch.int32)
    valid = (
        ((d > config.depth_min) & (d < config.depth_max))[..., None]
        & (t > 0.0)
        & B.coords_in_bounds(coords)
    )
    codes = torch.where(valid, B.pack_block_coords(coords), B.INVALID_CODE)
    return codes.reshape(-1)


def compact_mask(keep: torch.Tensor, values: torch.Tensor, capacity: int, fill):
    """Stream compaction: pack ``values[keep]`` to the front of a fixed-size
    buffer via cumsum + scatter (order-preserving).  Index ``capacity`` is
    a trash slot for masked and beyond-capacity lanes."""
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    tgt = torch.where(keep & (pos < capacity), pos, capacity)
    out = torch.full((capacity + 1,), fill, dtype=values.dtype, device=values.device)
    out.index_put_((tgt,), values)
    return out[:capacity]


def dedup_codes(codes: torch.Tensor, capacity: int):
    """Sort-based dedup + cumsum compaction to a fixed-size batch.
    Returns (unique_codes (capacity,), n_unique, n_dropped)."""
    s = torch.sort(codes).values
    first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]]
    ) & (s != B.INVALID_CODE)
    compact = compact_mask(first, s, capacity, B.INVALID_CODE)
    n_unique = torch.sum(first).to(torch.int32)
    n_dropped = torch.clamp(n_unique - capacity, min=0)
    return compact, n_unique, n_dropped


def allocate_for_frame(
    volume: B.VolumeState,
    depth: torch.Tensor,
    camera: PinholeCamera,
    pose: SE3,
    config: Config,
):
    """Allocate every block touched by this frame's truncation band.

    Returns ``(volume, band_ids, n_band)``: the compacted block indices of
    the frame's truncation band, the integration work list.
    """
    codes = candidate_block_codes(depth, camera, pose, config)
    uniq, _, n_dropped = dedup_codes(codes, config.alloc_capacity)
    want = uniq != B.INVALID_CODE
    coords = B.unpack_block_coords(uniq)

    codes_t, values, free_count, assigned, ok = hashing.insert_unique(
        volume.hash_codes, volume.hash_values, volume.free_count,
        coords, want, config,
    )
    # Record coords for every assigned block (new or existing: idempotent).
    nb = volume.block_coords.shape[0]
    tgt = torch.where(assigned > 0, assigned.to(torch.int64), nb)
    block_coords = torch.cat([volume.block_coords, volume.block_coords[:1]])
    block_coords.index_put_((tgt,), coords)

    overflow = volume.alloc_overflow + n_dropped + torch.sum(~ok)
    volume = dataclasses.replace(
        volume,
        hash_codes=codes_t,
        hash_values=values,
        free_count=free_count,
        block_coords=block_coords[:nb],
        alloc_overflow=overflow.to(torch.int32),
    )
    band_ids = torch.where(want & ok, assigned, 0)
    n_band = torch.sum(want).to(torch.int32)
    return volume, band_ids, n_band


def update_visibility(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
) -> B.VolumeState:
    """Compact the dense list of blocks visible in the current frustum.

    Block centre projects within the image inflated by the block's
    projected radius, camera-space z in [near, far] inflated by the block
    diagonal -- conservative, no false negatives.
    """
    be = config.block_extent
    centers = (volume.block_coords.to(torch.float32) + 0.5) * be
    cam_pts = pose.inverse().apply(centers)                    # (nb, 3)
    z = cam_pts[..., 2]
    radius_w = 0.87 * be
    zc = torch.clamp(z, min=1e-3)
    # float32 product, as the reference's f32 intrinsics times a scalar.
    r_px = float(np.float32(max(camera.fx, camera.fy)) * np.float32(radius_w)) / zc
    uv = camera.project(cam_pts)
    allocated = B.allocated_mask(volume, config)
    visible = (
        allocated
        & (z > config.ray_near - radius_w)
        & (z < config.ray_far + radius_w)
        & (uv[..., 0] > -r_px)
        & (uv[..., 0] < width - 1 + r_px)
        & (uv[..., 1] > -r_px)
        & (uv[..., 1] < height - 1 + r_px)
    )
    nb = visible.shape[0]
    ids = torch.arange(nb, dtype=torch.int32, device=visible.device)
    n_vis = torch.sum(visible).to(torch.int32)
    cap = config.max_visible
    visible_ids = compact_mask(visible, ids, cap, 0)
    overflow = torch.clamp(n_vis - cap, min=0)
    return dataclasses.replace(
        volume,
        visible_ids=visible_ids,
        num_visible=torch.clamp(n_vis, max=cap),
        visible_overflow=(volume.visible_overflow + overflow).to(torch.int32),
    )
