"""Per-frame raycast acceleration structure.

Counterpart of ``vulcan_tpu/ops/render_cache.py``.  Built once per render
from the visible list:

  * **halo arrays** ``tsdf`` and ``march`` ((max_visible+1) * 729,): every
    visible block plus one voxel of +x/+y/+z neighbour data, row-major
    9x9x9, so trilinear interpolation never resolves blocks per corner;
    row 0 is the null block.  ``march`` holds the tsdf quantized to
    [-127, 127], or ``MARCH_UNSEEN`` where the voxel is unobserved (it
    doubles as the observed mask); ``tsdf`` is float32 for sub-voxel work;
  * **block grid** ((G*G*G),) int32: dense map from block coordinate
    (relative to the visible set's lowest corner, ``grid_min``) to halo
    row; ``row_block`` maps a halo row back to its volume block so that
    colour is read from the volume directly.

Visible blocks outside the G^3 window are counted in ``overflow`` and not
rendered this frame.  The halo build runs over ``ceil(num_visible / C)``
chunks, the reference's ``lax.while_loop`` (``utils.sync.chunk_loop``:
eager, the count read on the host once; captured, one WHILE node on the
device count).  Every sampler takes per-axis coordinates (planar arrays),
as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import Config
from ..utils import sync
from . import blocks as B
from .dense import floor_to_int, round_to_int

MARCH_UNSEEN = -128  # sentinel in ``march`` for unobserved voxels

# The seven +x/+y/+z neighbours whose faces, edges and corner extend a
# block to 9x9x9, in the reference's order.
_NEIGHBOURS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
               (0, 1, 1), (1, 1, 1))


@functools.lru_cache(maxsize=None)
def _neighbour_offsets(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_NEIGHBOURS`` as a (7, 3) tensor, built once a device and dtype:
    built in the step it would be a host-to-device copy, which a CUDA
    graph's capture refuses."""
    return torch.tensor(_NEIGHBOURS, dtype=dtype, device=device)


@dataclasses.dataclass
class RenderCache:
    """All gather targets are flat 1-D arrays, as in the reference."""

    grid: torch.Tensor       # ((G*G*G),) int32 halo row; 0 = empty
    grid_min: torch.Tensor   # (3,) int32 block coord of grid[0, 0, 0]
    tsdf: torch.Tensor       # ((V+1)*729,) float32 halo voxels
    march: torch.Tensor      # ((V+1)*729,) int32 quantized tsdf or UNSEEN
    row_block: torch.Tensor  # (V+1,) int32 volume block index (0 = null)
    overflow: torch.Tensor   # () int32 visible blocks outside the grid


def _extend(flat: torch.Tensor, own: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(NB, 512) voxel rows -> (C, 9, 9, 9) halos of the blocks ``own``
    (C,), with the faces, edges and corner of their neighbours ``nbr``
    (C, 7).  Every one of the 729 entries is written."""
    C = own.shape[0]
    ext = flat.new_empty((C, 9, 9, 9))
    ext[:, :8, :8, :8] = flat[own].reshape(C, 8, 8, 8)

    def rows(j):
        return flat[nbr[:, j]].reshape(C, 8, 8, 8)

    ext[:, 8, :8, :8] = rows(0)[:, 0, :, :]
    ext[:, :8, 8, :8] = rows(1)[:, :, 0, :]
    ext[:, :8, :8, 8] = rows(2)[:, :, :, 0]
    ext[:, 8, 8, :8] = rows(3)[:, 0, 0, :]
    ext[:, 8, :8, 8] = rows(4)[:, 0, :, 0]
    ext[:, :8, 8, 8] = rows(5)[:, :, 0, 0]
    ext[:, 8, 8, 8] = rows(6)[:, 0, 0, 0]
    return ext


def build(volume: B.VolumeState, config: Config) -> RenderCache:
    """Build the cache for the current visible set (one pass per frame)."""
    ids = volume.visible_ids
    V = ids.shape[0]
    dev = ids.device
    row_valid = B.visible_rows(volume)
    coords = volume.block_coords[ids.long()]                       # (V, 3)
    offs = _neighbour_offsets(dev, coords.dtype)
    nbr = B.lookup_blocks(volume, coords[:, None, :] + offs, config)
    nbr = torch.where(row_valid[:, None], nbr, 0).long()           # (V, 7)
    own = torch.where(row_valid, ids, 0)

    # The halo copies run over the actual visible count, in chunks: a
    # chunk's rows are its device offset + lanes, its halo rows one past.
    C = min(2048, V)
    halo_tsdf = torch.ones(((V + 1) * 729,), dtype=torch.float32, device=dev)
    march = torch.full(((V + 1) * 729,), MARCH_UNSEEN, dtype=torch.int32,
                       device=dev)
    own_l = own.long()
    lanes = torch.arange(C, device=dev)
    halo_rows, march_rows = halo_tsdf.view(V + 1, 729), march.view(V + 1, 729)

    def chunk(offset):
        rows = offset + lanes
        o, nb = own_l[rows], nbr[rows]
        et = _extend(volume.tsdf, o, nb)
        ew = _extend(volume.weight, o, nb)
        em = torch.where(
            ew > 0.0, torch.round(torch.clamp(et, -1.0, 1.0) * 127.0),
            float(MARCH_UNSEEN),
        ).to(torch.int32)
        halo_rows.index_copy_(0, rows + 1, et.reshape(C, 729))
        march_rows.index_copy_(0, rows + 1, em.reshape(C, 729))

    sync.chunk_loop(volume.num_visible, V, C, chunk)

    G = config.render_grid_size
    big = 1 << 20
    masked = torch.where(row_valid[:, None], coords, big)
    grid_min = torch.amin(masked, dim=0)
    grid_min = torch.where(grid_min == big, 0, grid_min)

    rel = coords - grid_min
    inside = row_valid & torch.all((rel >= 0) & (rel < G), dim=-1)
    flat = (rel[:, 0] * G + rel[:, 1]) * G + rel[:, 2]
    rows = torch.arange(1, V + 1, dtype=torch.int32, device=dev)
    # Index G^3 is a trash slot for the rows outside the grid.
    grid = torch.zeros((G * G * G + 1,), dtype=torch.int32, device=dev)
    grid.index_put_((torch.where(inside, flat, G * G * G).long(),), rows)
    overflow = torch.sum(row_valid & ~inside).to(torch.int32)

    return RenderCache(
        grid=grid[:G * G * G],
        grid_min=grid_min,
        tsdf=halo_tsdf,
        march=march,
        row_block=torch.cat([own.new_zeros(1), own]),
        overflow=overflow,
    )


def _row_and_local(cache: RenderCache, gx, gy, gz, config: Config):
    """Integer voxel coords (per axis) -> (halo_row, lx, ly, lz)."""
    G = config.render_grid_size
    bx, by, bz = gx >> 3, gy >> 3, gz >> 3
    rx = bx - cache.grid_min[0]
    ry = by - cache.grid_min[1]
    rz = bz - cache.grid_min[2]
    inside = (rx >= 0) & (rx < G) & (ry >= 0) & (ry < G) & (rz >= 0) & (rz < G)
    flat = ((torch.clamp(rx, 0, G - 1) * G + torch.clamp(ry, 0, G - 1)) * G
            + torch.clamp(rz, 0, G - 1))
    row = torch.where(inside, cache.grid[flat.long()], 0).long()
    return row, gx - (bx << 3), gy - (by << 3), gz - (bz << 3)


def sample_march_texture(cache: RenderCache, gx, gy, gz, config: Config):
    """March sample at integer voxel coords: the quantized tsdf, with
    ``MARCH_UNSEEN`` where unobserved or outside.  Two gathers."""
    row, lx, ly, lz = _row_and_local(cache, gx, gy, gz, config)
    return cache.march[((row * 9 + lx) * 9 + ly) * 9 + lz]


def _floor_axes(px, py, pz, config: Config):
    inv_vs = 1.0 / config.voxel_size
    qx, qy, qz = px * inv_vs, py * inv_vs, pz * inv_vs
    x0, y0, z0 = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    return (floor_to_int(qx), floor_to_int(qy), floor_to_int(qz),
            qx - x0, qy - y0, qz - z0)


def _trilinear(cache: RenderCache, px, py, pz, config: Config, quantized: bool):
    """Trilinear sum over the 8 halo corners, in the reference's corner
    order; ``ok`` = every corner observed (the march sentinel)."""
    x0, y0, z0, fx, fy, fz = _floor_axes(px, py, pz, config)
    row, lx, ly, lz = _row_and_local(cache, x0, y0, z0, config)
    val = torch.zeros(row.shape, dtype=torch.float32, device=row.device)
    ok = row > 0
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                hidx = ((row * 9 + lx + dx) * 9 + ly + dy) * 9 + lz + dz
                m = cache.march[hidx]
                f = m.to(torch.float32) if quantized else cache.tsdf[hidx]
                val = val + (wx * wy * wz) * f
                ok = ok & (m != MARCH_UNSEEN)
    return val, ok


def sample_trilinear_axes(cache: RenderCache, px, py, pz, config: Config):
    """Trilinear float32 TSDF at world points given per axis: (value, ok).
    1 grid gather + 8 halo gathers of each halo."""
    return _trilinear(cache, px, py, pz, config, quantized=False)


def sample_march_trilinear_axes(cache: RenderCache, px, py, pz, config: Config):
    """Trilinear on the quantized march texture (1/127 mu resolution): one
    gather per corner gives the value and the observed mask (splat
    polish)."""
    val, ok = _trilinear(cache, px, py, pz, config, quantized=True)
    return val * (1.0 / 127.0), ok


def sample_color_nearest_axes(cache: RenderCache, volume: B.VolumeState,
                              px, py, pz, config: Config):
    """Nearest-voxel colour from the volume through the row -> block map."""
    inv_vs = 1.0 / config.voxel_size
    gx = round_to_int(px * inv_vs)
    gy = round_to_int(py * inv_vs)
    gz = round_to_int(pz * inv_vs)
    row, lx, ly, lz = _row_and_local(cache, gx, gy, gz, config)
    b = cache.row_block[row].long()
    li = (lx * 8 + ly) * 8 + lz
    rgb, cw = B.unpack_voxel_color(volume.colorpack[b, li])
    ok = (row > 0) & (cw > 0.0)
    return torch.where(ok[..., None], rgb, 0.0), ok


def sample_gradient_axes(cache: RenderCache, px, py, pz, config: Config):
    """TSDF-gradient normals from 6 trilinear samples (per-axis offsets)."""
    h = 0.5 * config.voxel_size
    gpx, okx1 = sample_trilinear_axes(cache, px + h, py, pz, config)
    gmx, okx2 = sample_trilinear_axes(cache, px - h, py, pz, config)
    gpy, oky1 = sample_trilinear_axes(cache, px, py + h, pz, config)
    gmy, oky2 = sample_trilinear_axes(cache, px, py - h, pz, config)
    gpz, okz1 = sample_trilinear_axes(cache, px, py, pz + h, config)
    gmz, okz2 = sample_trilinear_axes(cache, px, py, pz - h, config)
    nx, ny, nz = gpx - gmx, gpy - gmy, gpz - gmz
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    ok = okx1 & okx2 & oky1 & oky2 & okz1 & okz2 & (norm > 1e-12)
    inv = 1.0 / torch.clamp(norm, min=1e-12)
    return nx * inv, ny * inv, nz * inv, ok
