"""Voxel-block volume state, surfel packing and block-coordinate codes.

Counterpart of ``vulcan_tpu/ops/blocks.py``.  Storage is flat and static:

  * voxel data: (num_blocks, 512) -- block b, flat local index
    lidx = (lx*8 + ly)*8 + lz;
  * hash table: see ``ops/hashing.py``;
  * visible list: fixed capacity with a valid count.

Block coords are bounded to [-512, 512) per axis so a block key packs into
one int32.  Block index 0 is a sentinel null block (weight forever 0);
real blocks start at index 1.  At the default ``Config`` the volume takes
~0.45 GB of device memory.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from . import hashing

COORD_BOUND = 512  # per-axis block coord in [-COORD_BOUND, COORD_BOUND)
EMPTY_SURFEL = 0x7FFFFFFF
INVALID_CODE = 0x7FFFFFFF


@dataclasses.dataclass
class VolumeState:
    """Sparse voxel-block TSDF volume.  Field for field the reference's
    ``VolumeState``; integration updates the voxel arrays IN PLACE."""

    hash_codes: torch.Tensor     # (hash_size,) int32, EMPTY_CODE = empty
    hash_values: torch.Tensor    # (hash_size,) int32 block index
    free_count: torch.Tensor     # () int32, next free block index
    block_coords: torch.Tensor   # (num_blocks, 3) int32
    tsdf: torch.Tensor           # (num_blocks, 512) float32 in [-1, 1]
    weight: torch.Tensor         # (num_blocks, 512) float32
    colorpack: torch.Tensor      # (num_blocks, 512) int32 w8|r8|g8|b8
    visible_ids: torch.Tensor    # (max_visible,) int32
    num_visible: torch.Tensor    # () int32
    surfpack: torch.Tensor       # (num_blocks, surfel_slots) int32
    surf_count: torch.Tensor     # (num_blocks,) int32
    surf_overflow: torch.Tensor  # () int32
    alloc_overflow: torch.Tensor     # () int32
    visible_overflow: torch.Tensor   # () int32
    mesh_dirty: torch.Tensor     # (num_blocks,) bool


def surfel_band(config: Config) -> float:
    """|tsdf| gate (mu units) for voxel surfels (shared by the splat
    renderer and integrate-time surfel maintenance, which must agree)."""
    return min(
        1.0, max(config.splat_band, 1.5 * config.voxel_size / config.trunc_dist)
    )


def create_volume(config: Config, device=None) -> VolumeState:
    nb = config.num_blocks
    bv = config.block_volume

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    return VolumeState(
        hash_codes=i32(config.hash_size, fill=hashing.EMPTY_CODE),
        hash_values=i32(config.hash_size),
        free_count=i32(fill=1),  # block 0 = null sentinel
        block_coords=i32(nb, 3),
        tsdf=torch.ones((nb, bv), dtype=torch.float32, device=device),
        weight=torch.zeros((nb, bv), dtype=torch.float32, device=device),
        colorpack=i32(nb, bv),
        visible_ids=i32(config.max_visible),
        num_visible=i32(),
        surfpack=i32(nb, config.surfel_slots, fill=EMPTY_SURFEL),
        surf_count=i32(nb),
        surf_overflow=i32(),
        alloc_overflow=i32(),
        visible_overflow=i32(),
        mesh_dirty=torch.zeros((nb,), dtype=torch.bool, device=device),
    )


def quantized_orientation(tsdf_rows: torch.Tensor):
    """Per-voxel quantized TSDF-gradient direction (gx, gy, gz), int32 in
    {-1, 0, 1}: central differences within the block, one-sided at block
    faces; components below a quarter of the dominant one quantize to 0."""
    t3 = tsdf_rows.reshape(-1, 8, 8, 8)

    def _grad(axis):
        lo = torch.cat([t3.narrow(axis, 0, 1), t3.narrow(axis, 0, 7)], dim=axis)
        hi = torch.cat([t3.narrow(axis, 1, 7), t3.narrow(axis, 7, 1)], dim=axis)
        return (hi - lo).reshape(tsdf_rows.shape)

    gx, gy, gz = _grad(1), _grad(2), _grad(3)
    gm = 0.25 * torch.maximum(
        torch.abs(gx), torch.maximum(torch.abs(gy), torch.abs(gz))
    )

    def _q(g):
        one = torch.ones_like(g, dtype=torch.int32)
        return torch.where(g > gm, one, torch.where(g < -gm, -one, 0 * one))

    return _q(gx), _q(gy), _q(gz)


def pack_surfels(tsdf_rows, weight_rows, band: float, slots: int):
    """Rows (C, 512) -> compacted surfel rows (C, slots) + counts.

    A voxel is a surfel iff observed and |tsdf| < band.  Packed value::

        qgz+1 << 28 | qgy+1 << 26 | qgx+1 << 24 |
        |tsdf|_q14 << 10 | sign(tsdf) << 9 | lidx

    Inner half-band voxels are placed first, the outer half-band after
    them, so overflow sheds outer-shell voxels only.  The reference places
    values with a bf16 one-hot matmul (a TPU trick); here a plain scatter
    puts ``val`` at slot ``pos`` -- bit-identical, since each kept slot
    receives exactly one value.  Returns (surf (C, slots), kept (C,),
    dropped (C,)).
    """
    c, n = tsdf_rows.shape
    dev = tsdf_rows.device
    lidx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    a = torch.abs(tsdf_rows)
    mag = torch.clamp(torch.round(a * 16383.0), 0, 16383).to(torch.int32)
    sign = (tsdf_rows < 0.0).to(torch.int32)
    live = (a < band) & (weight_rows > 0.0)

    gx, gy, gz = quantized_orientation(tsdf_rows)
    val = (
        ((gz + 1) << 28) | ((gy + 1) << 26) | ((gx + 1) << 24)
        | (mag << 10) | (sign << 9) | lidx
    )

    inner = live & (a < 0.5 * band)
    outer = live & ~inner
    n_inner = torch.sum(inner, dim=1, keepdim=True)
    pos = torch.where(
        inner,
        torch.cumsum(inner, dim=1) - 1,
        n_inner + torch.cumsum(outer, dim=1) - 1,
    )
    keep = live & (pos < slots)
    # Column ``slots`` is a trash slot for the masked lanes.
    out = torch.full((c, slots + 1), EMPTY_SURFEL, dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(keep, pos, slots), val)
    out = out[:, :slots]

    count = torch.sum(live, dim=1).to(torch.int32)
    kept = torch.clamp(count, max=slots)
    slot_live = torch.arange(slots, device=dev)[None, :] < kept[:, None]
    out = torch.where(slot_live, out, EMPTY_SURFEL)
    return out, kept, count - kept


def unpack_surfels(surf_rows: torch.Tensor):
    """(..., S) int32 -> (lidx int32, tsdf f32, valid bool,
    (gx, gy, gz) f32 quantized outward-orientation components)."""
    valid = surf_rows != EMPTY_SURFEL
    lidx = torch.where(valid, surf_rows & 0x1FF, 0)
    mag = (surf_rows >> 10) & 0x3FFF
    neg = ((surf_rows >> 9) & 1) == 1
    sign = torch.where(neg, -1.0, 1.0)
    tsdf = sign * mag.to(torch.float32) * (1.0 / 16383.0)
    gx = (((surf_rows >> 24) & 3) - 1).to(torch.float32)
    gy = (((surf_rows >> 26) & 3) - 1).to(torch.float32)
    gz = (((surf_rows >> 28) & 3) - 1).to(torch.float32)
    return lidx, torch.where(valid, tsdf, 1.0), valid, (gx, gy, gz)


def pack_block_coords(coords: torch.Tensor) -> torch.Tensor:
    """(...,3) int32 block coords -> (...,) int32 sortable code."""
    c = coords + COORD_BOUND
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def unpack_block_coords(codes: torch.Tensor) -> torch.Tensor:
    x = (codes >> 20) & 0x3FF
    y = (codes >> 10) & 0x3FF
    z = codes & 0x3FF
    return torch.stack([x, y, z], dim=-1) - COORD_BOUND


def coords_in_bounds(coords: torch.Tensor) -> torch.Tensor:
    return torch.all((coords >= -COORD_BOUND) & (coords < COORD_BOUND), dim=-1)


# --- sparse voxel access -------------------------------------------------


def world_to_voxel(p: torch.Tensor, config: Config) -> torch.Tensor:
    """World points (..., 3) -> continuous voxel coords."""
    return p / config.voxel_size


def voxel_block_local(g: torch.Tensor, config: Config):
    """Integer voxel indices (..., 3) -> (block_coords, local_idx)."""
    bs = config.block_size
    block = torch.div(g, bs, rounding_mode="floor")
    return block, g - block * bs


def lookup_blocks(volume: VolumeState, block_coords: torch.Tensor,
                  config: Config) -> torch.Tensor:
    """Hash-lookup block coords (..., 3) -> block index (0 = null/missing)."""
    idx, found = hashing.lookup(
        volume.hash_codes, volume.hash_values, block_coords, config
    )
    return torch.where(found, idx, 0)


def local_flat(local: torch.Tensor, config: Config) -> torch.Tensor:
    """Local voxel coords (..., 3) -> flat index (lx*8 + ly)*8 + lz."""
    bs = config.block_size
    return (local[..., 0] * bs + local[..., 1]) * bs + local[..., 2]


def _voxel_rows(volume: VolumeState, g: torch.Tensor, config: Config):
    """(block index, flat local index) of integer voxel coords g (..., 3),
    as int64 indices into the (num_blocks, 512) voxel arrays; an
    unallocated voxel's block is the null block 0."""
    block, local = voxel_block_local(g, config)
    b = lookup_blocks(volume, block, config)
    return b.to(torch.int64), local_flat(local, config).to(torch.int64)


def read_voxels(volume: VolumeState, g: torch.Tensor, config: Config):
    """TSDF and weight at integer voxel coords g (..., 3); unallocated
    voxels read the null block: tsdf 1, weight 0."""
    b, li = _voxel_rows(volume, g, config)
    return volume.tsdf[b, li], volume.weight[b, li]


def sample_tsdf_nearest(volume: VolumeState, p_world: torch.Tensor, config: Config):
    """Nearest-voxel (tsdf, weight) at world points (..., 3)."""
    g = torch.round(world_to_voxel(p_world, config)).to(torch.int32)
    return read_voxels(volume, g, config)


def _corners(p_world: torch.Tensor, config: Config):
    """The 8 voxels around world points (..., 3), each with its trilinear
    weight: yields (integer voxel coords, weight) in the reference's
    order, x outermost."""
    q = world_to_voxel(p_world, config)
    q0 = torch.floor(q)
    frac = q - q0
    q0 = q0.to(torch.int32)
    for dx in (0, 1):
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        for dy in (0, 1):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            for dz in (0, 1):
                wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
                step = torch.stack([q0[..., 0] + dx, q0[..., 1] + dy, q0[..., 2] + dz], -1)
                yield step, wx * wy * wz


def sample_tsdf_trilinear(volume: VolumeState, p_world: torch.Tensor, config: Config):
    """Trilinear TSDF at world points (..., 3) -> (value, all_observed):
    8 hash lookups a point (one a corner, across blocks), ``ok`` only
    where every corner was observed (weight > 0)."""
    val = torch.zeros(p_world.shape[:-1], dtype=volume.tsdf.dtype, device=p_world.device)
    ok = torch.ones(p_world.shape[:-1], dtype=torch.bool, device=p_world.device)
    for g, w in _corners(p_world, config):
        f, weight = read_voxels(volume, g, config)
        val = val + w * f
        ok = ok & (weight > 0.0)
    return val, ok


def sample_color_trilinear(volume: VolumeState, p_world: torch.Tensor, config: Config):
    """Trilinear colour at world points (..., 3) -> (rgb, any_observed):
    an unobserved corner (colour weight 0) weighs 0, so colour bleeds less
    at boundaries; ``ok`` where the weights sum above 1e-6 (rgb 0
    elsewhere)."""
    shape = p_world.shape[:-1]
    rgb = torch.zeros(shape + (3,), dtype=torch.float32, device=p_world.device)
    wsum = torch.zeros(shape, dtype=torch.float32, device=p_world.device)
    for g, w in _corners(p_world, config):
        b, li = _voxel_rows(volume, g, config)
        c, cw = unpack_voxel_color(volume.colorpack[b, li])
        w = w * torch.where(cw > 0.0, 1.0, 0.0)
        rgb = rgb + w[..., None] * c
        wsum = wsum + w
    ok = wsum > 1e-6
    rgb = rgb / torch.clamp(wsum, min=1e-6)[..., None]
    return torch.where(ok[..., None], rgb, 0.0), ok


def pack_voxel_color(rgb: torch.Tensor, cweight: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 rgb in [0,1] + (...,) f32 weight -> (...) int32."""
    c = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.int32)
    w = torch.clamp(torch.round(cweight), 0, 255).to(torch.int32)
    return (w << 24) | (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_voxel_color(packed: torch.Tensor):
    """(...) int32 -> ((..., 3) f32 rgb, (...) f32 color weight)."""
    r = ((packed >> 16) & 0xFF).to(torch.float32)
    g = ((packed >> 8) & 0xFF).to(torch.float32)
    b = (packed & 0xFF).to(torch.float32)
    cw = ((packed >> 24) & 0xFF).to(torch.float32)
    return torch.stack([r, g, b], dim=-1) * (1.0 / 255.0), cw


def visible_rows(volume: VolumeState) -> torch.Tensor:
    """(max_visible,) bool -- which rows of the visible list hold a block."""
    ids = volume.visible_ids
    return (torch.arange(ids.shape[0], device=ids.device) < volume.num_visible) & (ids > 0)


def allocated_mask(volume: VolumeState, config: Config) -> torch.Tensor:
    """(num_blocks,) bool -- which block slots hold real allocated blocks."""
    n = volume.tsdf.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=volume.tsdf.device)
    return (ids >= 1) & (ids < volume.free_count)
