"""Truncation-band sparse TSDF integration, flat gather path.

Counterpart of the flat path of ``vulcan_tpu/ops/sparse.py``: one
vectorized pass over chunks of (chunk, 512) voxel rows -- gather rows,
sample the packed depth+colour image once per voxel, update, write back.
The reference's one-hot mip-patch gather (a TPU layout trick, pinned equal
to the flat path by its own tests) is not ported.

Updates are IN PLACE: the voxel rows are written back with ``index_copy_``
into the volume's tensors.  The reference gets the same effect from jit
buffer donation; copying the ~0.45 GB volume every frame would dominate.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.frame import Frame
from ..utils import sync
from . import blocks as B
from .dense import _sample_nearest, voxel_update


def _pack_depth_color(depth, color, config: Config) -> torch.Tensor:
    """(H, W) f32 depth + (H, W, 3) f32 rgb -> (H, W) int32
    ``depth16 << 16 | rgb565``: one image gather per voxel."""
    d16 = torch.clamp(torch.round(depth * config.depth_raw_scale), 0, 65535).to(
        torch.int32
    )
    c = torch.clamp(torch.round(color * 255.0), 0, 255).to(torch.int32)
    rgb565 = ((c[..., 0] >> 3) << 11) | ((c[..., 1] >> 2) << 5) | (c[..., 2] >> 3)
    return (d16 << 16) | rgb565


def _unpack_depth_color(packed: torch.Tensor, config: Config):
    d = ((packed >> 16) & 0xFFFF).to(torch.float32) * (1.0 / config.depth_raw_scale)
    r = ((packed >> 11) & 0x1F).to(torch.float32) * (1.0 / 31.0)
    g = ((packed >> 5) & 0x3F).to(torch.float32) * (1.0 / 63.0)
    b = (packed & 0x1F).to(torch.float32) * (1.0 / 31.0)
    return d, torch.stack([r, g, b], dim=-1)


def _local_grid(config: Config, device) -> torch.Tensor:
    """(512, 3) int32 local voxel coords in flat lidx order."""
    r = torch.arange(config.block_size, dtype=torch.int32, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def _integrate_batch(volume, frame, packed_img, ids, row_valid, config):
    """Fuse one chunk of blocks; returns the new rows (C, 512) etc.

    Masked rows (``row_valid`` False) come back with their OLD values, so
    writing the chunk back is the identity for them."""
    bs = config.block_size
    coords = volume.block_coords[ids]                         # (C, 3)
    local = _local_grid(config, ids.device)                   # (512, 3)
    g = coords[:, None, :] * bs + local                       # (C, 512, 3)
    world = g.to(torch.float32) * config.voxel_size

    cam_pts = frame.pose.inverse().apply(world)
    z = cam_pts[..., 2]
    uv = frame.camera.project(cam_pts)
    packed, in_bounds = _sample_nearest(packed_img, uv)
    depth, color = _unpack_depth_color(packed, config)
    valid = (
        row_valid[:, None]
        & in_bounds
        & (depth > config.depth_min)
        & (depth < config.depth_max)
        & (z > 0.0)
    )
    sdf = depth - z

    old_tsdf = volume.tsdf[ids]
    old_cpack = volume.colorpack[ids]
    old_weight = volume.weight[ids]
    col, cweight = B.unpack_voxel_color(old_cpack)
    tsdf, weight, col, cweight = voxel_update(
        old_tsdf, old_weight, col, cweight, sdf, color, valid, config
    )
    surf, surf_count, dropped = B.pack_surfels(
        tsdf, weight, B.surfel_band(config), config.surfel_slots
    )
    cpack = B.pack_voxel_color(col, cweight)
    # Mesh-dirty gate: mark a block only when its TSDF moved by more than
    # mesh_dirty_eps or its stored rgb888 bytes changed.
    eps = config.mesh_dirty_eps
    if eps > 0.0:
        changed = torch.any(torch.abs(tsdf - old_tsdf) > eps, dim=1) | torch.any(
            (cpack & 0xFFFFFF) != (old_cpack & 0xFFFFFF), dim=1
        )
    else:
        changed = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)

    rv = row_valid[:, None]
    return (
        torch.where(rv, tsdf, old_tsdf),
        torch.where(rv, weight, old_weight),
        torch.where(rv, cpack, old_cpack),
        torch.where(rv, surf, volume.surfpack[ids]),
        torch.where(row_valid, surf_count, volume.surf_count[ids]),
        torch.sum(torch.where(row_valid, dropped, 0)),
        row_valid & changed,
    )


def integrate_sparse(
    volume: B.VolumeState,
    frame: Frame,
    config: Config,
    ids: torch.Tensor | None = None,
    count: torch.Tensor | None = None,
    host_count: int | None = None,
) -> B.VolumeState:
    """Fuse one frame into the listed blocks, in place.

    Default work list: ``volume.visible_ids``; the online pipeline passes
    the frame's truncation-band list from allocation instead.  The
    reference's ``lax.while_loop`` over chunks of the list
    (``utils.sync.chunk_loop``): eager, the chunk count follows the list's
    length, read on the host once per call unless the caller has read it
    already (``host_count``); while a CUDA graph is captured, the loop is
    one WHILE node on the device count.  A chunk's rows are the list's
    entries at its device offset; rows past the count (or the list's
    capacity) are masked and write back their old values.
    """
    work_ids = volume.visible_ids if ids is None else ids
    work_count = volume.num_visible if count is None else count
    V = work_ids.shape[0]
    C = min(config.integrate_chunk, V)
    packed_dc = _pack_depth_color(frame.depth, frame.color, config)
    work_ids = work_ids.to(torch.int64)
    lanes = torch.arange(C, device=work_ids.device)

    # surf_overflow is a per-frame gauge: it resets here, and the chunks
    # add to it in place.
    surf_overflow = torch.zeros((), dtype=torch.int32, device=work_ids.device)

    def chunk_at(offset: torch.Tensor) -> None:
        rows = offset + lanes
        chunk = work_ids[rows]
        row_valid = (rows < work_count) & (chunk > 0)
        tsdf, weight, cpack, surf, s_count, s_drop, mark = _integrate_batch(
            volume, frame, packed_dc, chunk, row_valid, config
        )
        # Masked rows carry block 0 and their old values (see
        # _integrate_batch), so duplicate indices write identical rows.
        volume.tsdf.index_copy_(0, chunk, tsdf)
        volume.weight.index_copy_(0, chunk, weight)
        volume.colorpack.index_copy_(0, chunk, cpack)
        volume.surfpack.index_copy_(0, chunk, surf)
        volume.surf_count.index_copy_(0, chunk, s_count)
        volume.mesh_dirty.index_copy_(0, chunk, volume.mesh_dirty[chunk] | mark)
        surf_overflow.add_(s_drop.to(torch.int32))

    sync.chunk_loop(work_count, V, C, chunk_at, host_count)
    return dataclasses.replace(volume, surf_overflow=surf_overflow)
