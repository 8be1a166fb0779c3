"""Truncation-band sparse TSDF integration, flat gather path.

Counterpart of the flat path of ``vulcan_tpu/ops/sparse.py``: one
vectorized pass over chunks of (chunk, 512) voxel rows -- gather rows,
sample the packed depth+colour image once per voxel, update, write back.
The reference's one-hot mip-patch gather (a TPU layout trick, pinned equal
to the flat path by its own tests) is not ported.

Updates are IN PLACE: the voxel rows are written back with ``index_copy_``
into the volume's tensors.  The reference gets the same effect from jit
buffer donation; copying the ~0.45 GB volume every frame would dominate.

On the card the whole list is one launch of kernel I1
(``csrc/integrate.cu``), which writes the rows in place itself; the chunk
loop over ``_integrate_batch`` is its plain version, which the CPU takes.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.frame import Frame
from ..core.se3 import SE3
from ..utils import sync
from . import blocks as B
from . import cuda_kernels
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


def _to_camera(pose: SE3, world: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) under the world-to-camera ``pose``, a row as
    the reference's compiled dot takes it: the first product, two fused
    multiply-adds, then the translation.  A fused multiply-add is written
    out in float64 (the product is exact there) and rounded once to float32,
    so I1 repeats it bit for bit; an einsum has no fixed order on the card."""
    R, t = pose.rotation, pose.translation
    Rd = R.double()
    x, y, z = world.unbind(-1)
    yd, zd = y.double(), z.double()
    rows = []
    for i in range(3):
        a = R[i, 0] * x
        a = (Rd[i, 1] * yd + a.double()).float()
        a = (Rd[i, 2] * zd + a.double()).float()
        rows.append(a + t[i])
    return torch.stack(rows, dim=-1)


def _integrate_batch(volume, frame, packed_img, ids, row_valid, config):
    """Fuse one chunk of blocks; returns the new rows (C, 512) etc.

    Masked rows (``row_valid`` False) come back with their OLD values, so
    writing the chunk back is the identity for them."""
    bs = config.block_size
    coords = volume.block_coords[ids]                         # (C, 3)
    local = _local_grid(config, ids.device)                   # (512, 3)
    g = coords[:, None, :] * bs + local                       # (C, 512, 3)
    world = g.to(torch.float32) * config.voxel_size

    cam_pts = _to_camera(frame.pose.inverse(), world)
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


def i1_scalars(config: Config) -> cuda_kernels.IntegrateScalars:
    """The ``Config`` scalars I1 takes (the wrapper rounds each to float32,
    as the plain version's ops round a Python float on the card); ``inv_mu``
    is the reciprocal that PyTorch's CUDA division by a Python float
    multiplies by: 1 / mu in float64, then rounded."""
    band = B.surfel_band(config)
    mu = config.trunc_dist
    return cuda_kernels.IntegrateScalars(
        config.voxel_size, 1.0 / config.depth_raw_scale, config.depth_min,
        config.depth_max, mu, 1.0 / mu, config.max_weight, band,
        0.5 * band, config.mesh_dirty_eps, config.mesh_dirty_eps > 0.0,
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
    the frame's truncation-band list from allocation instead.  A CPU volume
    takes the plain version (``_integrate_plain``); a CUDA volume launches
    I1 once (``cuda_kernels.integrate``), which reads the list's device
    count on the card and raises for more than 512 ``surfel_slots``
    (``Config`` holds ``block_size`` at 8).  Every launch is counted on the
    card: ``cuda_kernels.launch_counts``."""
    work_ids = volume.visible_ids if ids is None else ids
    work_count = volume.num_visible if count is None else count
    if work_ids.is_cpu:
        return _integrate_plain(volume, frame, config, work_ids, work_count, host_count)
    # surf_overflow is a per-frame gauge: it resets here, and I1's CTAs add
    # to it.
    surf_overflow = torch.zeros((), dtype=torch.int32, device=work_ids.device)
    inv = frame.pose.inverse()
    cam = frame.camera
    cuda_kernels.integrate(
        work_ids.to(torch.int32), work_count,
        torch.cat([inv.rotation.reshape(9), inv.translation]),
        _pack_depth_color(frame.depth, frame.color, config), volume.block_coords,
        (volume.tsdf, volume.weight, volume.colorpack),
        (volume.surfpack, volume.surf_count, volume.mesh_dirty), surf_overflow,
        (cam.fx, cam.fy, cam.cx, cam.cy), i1_scalars(config))
    return dataclasses.replace(volume, surf_overflow=surf_overflow)


def _integrate_plain(volume: B.VolumeState, frame: Frame, config: Config,
                     ids: torch.Tensor, count: torch.Tensor,
                     host_count: int | None = None) -> B.VolumeState:
    """I1's plain version, on any device: the reference's
    ``lax.while_loop`` over chunks of the list (``utils.sync.chunk_loop``),
    whose chunk count follows the list's length, read on the host once per
    call unless the caller has read it already (``host_count``); while a
    graph is captured, the loop is one WHILE node on the device count.  A
    chunk's rows are the list's entries at its device offset; rows past the
    count (or the list's capacity) are masked and write back their old
    values."""
    V = ids.shape[0]
    C = min(config.integrate_chunk, V)
    packed_dc = _pack_depth_color(frame.depth, frame.color, config)
    work_ids = ids.to(torch.int64)
    lanes = torch.arange(C, device=work_ids.device)
    # surf_overflow is a per-frame gauge: it resets here, and the chunks
    # add to it in place.
    surf_overflow = torch.zeros((), dtype=torch.int32, device=work_ids.device)

    def chunk_at(offset: torch.Tensor) -> None:
        rows = offset + lanes
        chunk = work_ids[rows]
        row_valid = (rows < count) & (chunk > 0)
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

    sync.chunk_loop(count, V, C, chunk_at, host_count)
    return dataclasses.replace(volume, surf_overflow=surf_overflow)
