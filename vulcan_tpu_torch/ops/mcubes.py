"""Coloured marching-cubes mesh extraction from the sparse TSDF volume.

Counterpart of ``vulcan_tpu/ops/mcubes.py``: full extraction
(``extract_mesh``), the persistent per-block triangle cache of incremental
extraction (``MeshCache``, ``update_mesh_cache``) and its decode into a
triangle soup (``cache_to_mesh``).  The structure is the reference's:

  1. **Halo**: each block of a chunk gathers its 7 +direction neighbour
     blocks once into a (9, 9, 9) halo (a missing neighbour reads the null
     block 0, weight 0), so every cube corner is a static slice.  Colour is
     gathered packed and unpacked once.
  2. **Classify**: per-cube configuration bits and triangle counts from the
     tables (``mc_tables``).
  3. **Compact**: the active cubes go to ``ACT`` lanes (cumsum + scatter);
     actives beyond ``ACT`` are counted in ``compact_dropped``, never lost
     silently.  Output offsets are an exclusive cumsum plus a running total.
  4. **Edges**: each active cube interpolates its 12 edges once; every
     triangle vertex then picks its edge.

Triangle order is the reference's: ascending block row, then cube order
inside a block.  The cache holds per vertex ``lidx<<20 | edge<<16 | t16``
(the cube's flat index in its block, the crossed edge, the interpolation
parameter in 16 bits) and an rgb888 colour.

The reference's loops whose trip counts are device values (chunks of
allocated rows, of flagged blocks, of work blocks, of cache rows) run here
as Python loops over one host read per loop bound (``utils.sync.read_int``):
``extract_mesh`` reads once, ``update_mesh_cache`` twice, ``cache_to_mesh``
once.  None of them runs in the per-frame step.  The reference's
out-of-range scatters (``mode="drop"``) write to one extra trash slot at
the end of each buffer, which is cut off afterwards.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from ..config import Config
from ..utils.sync import read_int
from . import blocks as B
from . import mc_tables as T

# The 7 +direction halo neighbours of a block (and, negated, the blocks
# whose halos read a given block).
_HALO_OFFSETS = (
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
)


@dataclasses.dataclass
class Mesh:
    """Triangle soup with per-vertex colours (fixed capacity + count)."""

    positions: torch.Tensor   # (capacity, 3, 3) world-space triangle vertices
    colors: torch.Tensor      # (capacity, 3, 3) rgb in [0, 1]
    count: torch.Tensor       # () int32 valid triangles
    overflow: torch.Tensor    # () int32 triangles dropped for any reason
    compact_dropped: torch.Tensor  # () int32 the part of ``overflow`` lost to
                                   # active-cube compaction / per-block slots


@dataclasses.dataclass
class MeshCache:
    """Persistent per-block triangle cache (incremental extraction).

    Triangle k of block b lives in slot ``(b, k)``; slots fill in cube
    order, so ``counts[b]`` delimits the live prefix.  ``dropped[b]``
    counts that block's triangles lost to the slot capacity or active-cube
    compaction at its last re-mesh.
    """

    va: torch.Tensor       # (num_blocks, mesh_slots) int32 vertex word A
    vb: torch.Tensor       # (num_blocks, mesh_slots) int32 vertex word B
    vc: torch.Tensor       # (num_blocks, mesh_slots) int32 vertex word C
    ca: torch.Tensor       # (num_blocks, mesh_slots) int32 rgb888 colour A
    cb: torch.Tensor       # (num_blocks, mesh_slots) int32 rgb888 colour B
    cc: torch.Tensor       # (num_blocks, mesh_slots) int32 rgb888 colour C
    counts: torch.Tensor   # (num_blocks,) int32 live triangles per block
    dropped: torch.Tensor  # (num_blocks,) int32 triangles lost per block


def create_mesh_cache(config: Config, device=None) -> MeshCache:
    nb, ts = config.num_blocks, config.mesh_slots

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return MeshCache(va=z(nb, ts), vb=z(nb, ts), vc=z(nb, ts), ca=z(nb, ts),
                     cb=z(nb, ts), cc=z(nb, ts), counts=z(nb), dropped=z(nb))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> SimpleNamespace:
    """The tables as tensors on ``device``, built once: a host-built
    tensor's copy to the card is followed by a stream sync."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    offs = T.CORNER_OFFSETS.astype(np.float32)
    return SimpleNamespace(
        num_tris=t(T.NUM_TRIS),                        # (256,) int32
        tri_table=t(T.TRI_TABLE),                      # (256, 15) int32
        ends=t(T.EDGE_ENDPOINTS.astype(np.int64)),     # (12, 2)
        off_a=t(offs[T.EDGE_ENDPOINTS[:, 0]]),         # (12, 3) f32
        off_b=t(offs[T.EDGE_ENDPOINTS[:, 1]]),
        halo=t(np.asarray(_HALO_OFFSETS, np.int32)),   # (7, 3)
    )


def _trash(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter indices with every out-of-range one sent to the trash slot
    ``size`` (the reference's ``mode="drop"``)."""
    return torch.where((idx >= 0) & (idx < size), idx, size)


def _dyn_slice(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``x[start:start + size]`` with the start clamped into range, as
    ``jax.lax.dynamic_slice_in_dim`` clamps it."""
    start = min(max(start, 0), x.shape[0] - size)
    return x[start:start + size]


def _halos_for_ids(volume: B.VolumeState, ids, row_valid, config: Config):
    """(CB, 9, 9, 9[, 3]) halo arrays for the given block rows: tsdf,
    weight, rgb, and the rows' block coords.  Invalid rows read the null
    block 0, whose weight is 0, so the observed mask covers them."""
    bs = config.block_size
    safe_ids = torch.where(row_valid, ids, 0).long()
    coords = volume.block_coords[safe_ids]
    tb = _tables(coords.device)
    idx = B.lookup_blocks(volume, coords[:, None, :] + tb.halo[None], config)
    nbr = torch.where(row_valid[:, None], idx, 0).long()    # (CB, 7)
    CB = ids.shape[0]

    def extend(flat):
        """(NB, 512) -> (CB, 9, 9, 9) using the neighbours' faces."""
        ext = flat.new_zeros((CB, bs + 1, bs + 1, bs + 1))
        ext[:, :bs, :bs, :bs] = flat[safe_ids].reshape(CB, bs, bs, bs)

        def rows(j):
            return flat[nbr[:, j]].reshape(CB, bs, bs, bs)

        ext[:, bs, :bs, :bs] = rows(0)[:, 0, :, :]
        ext[:, :bs, bs, :bs] = rows(1)[:, :, 0, :]
        ext[:, :bs, :bs, bs] = rows(2)[:, :, :, 0]
        ext[:, bs, bs, :bs] = rows(3)[:, 0, 0, :]
        ext[:, bs, :bs, bs] = rows(4)[:, 0, :, 0]
        ext[:, :bs, bs, bs] = rows(5)[:, :, 0, 0]
        ext[:, bs, bs, bs] = rows(6)[:, 0, 0, 0]
        return ext

    return (
        extend(volume.tsdf),
        extend(volume.weight),
        B.unpack_voxel_color(extend(volume.colorpack))[0],
        coords,
    )


def _chunk_surface(volume, ids, row_valid, config: Config, act_frac: float):
    """Halo + classify + active-cube compaction + per-edge interpolation
    for one chunk of block rows.  Returns a dict of compacted arrays:
    ``t12`` (ACT, 12) and ``c12`` (ACT, 12, 3) hold each active cube's 12
    edge parameters and colours."""
    bs = config.block_size
    dev = ids.device
    tb = _tables(dev)
    CB = ids.shape[0]
    ext_tsdf, ext_weight, ext_color, coords = _halos_for_ids(
        volume, ids, row_valid, config
    )

    # --- classify: per-cube configuration over (CB, 8, 8, 8) cubes ---
    corner_vals, corner_cols = [], []
    observed = None
    cfg_bits = torch.zeros((CB, bs, bs, bs), dtype=torch.int32, device=dev)
    for ci in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSETS[ci])
        window = (slice(None), slice(ox, ox + bs), slice(oy, oy + bs),
                  slice(oz, oz + bs))
        v = ext_tsdf[window]
        obs = ext_weight[window] > 0.0
        observed = obs if observed is None else observed & obs
        cfg_bits = cfg_bits | ((v < 0.0).to(torch.int32) << ci)
        corner_vals.append(v)
        corner_cols.append(ext_color[window])
    active = observed & row_valid[:, None, None, None]
    counts = torch.where(active, tb.num_tris[cfg_bits.long()], 0)

    # --- compact the active cubes ---
    N = CB * bs ** 3
    ACT = max(4096, min(N, int(N * act_frac)))
    flat_counts = counts.reshape(-1)
    keep = flat_counts > 0
    order = torch.cumsum(keep, 0) - 1
    kept = keep & (order < ACT)
    elig = torch.where(kept, flat_counts, 0)
    dropped = flat_counts.sum() - elig.sum()

    cube_ids = torch.full((ACT + 1,), N, dtype=torch.int64, device=dev)
    cube_ids[torch.where(kept, order, ACT)] = torch.arange(N, device=dev)
    cube_ids = cube_ids[:ACT]
    live = cube_ids < N
    safe = torch.clamp(cube_ids, max=N - 1)

    def g(x):
        """Dense (flattens to (N, ...)) -> compacted (ACT, ...)."""
        return x.reshape((N,) + x.shape[4:])[safe]

    vals_c = torch.stack([g(v) for v in corner_vals], dim=1)     # (ACT, 8)
    cols_c = torch.stack([g(c) for c in corner_cols], dim=1)     # (ACT, 8, 3)

    # --- per-edge interpolation ---
    va, vb = vals_c[:, tb.ends[:, 0]], vals_c[:, tb.ends[:, 1]]  # (ACT, 12)
    t12 = va / torch.where(torch.abs(va - vb) > 1e-12, va - vb, 1.0)
    t12 = torch.clamp(t12, 0.0, 1.0)
    ca, cb = cols_c[:, tb.ends[:, 0]], cols_c[:, tb.ends[:, 1]]  # (ACT, 12, 3)
    c12 = ca + t12[..., None] * (cb - ca)

    return dict(
        flat_counts=flat_counts, elig=elig, dropped=dropped, live=live,
        cfg_c=g(cfg_bits), counts_c=torch.where(live, g(counts), 0), g=g,
        t12=t12, c12=c12, block_of=safe // (bs ** 3), lidx_c=safe % (bs ** 3),
        coords=coords,
    )


def _edge_positions(s, config: Config) -> torch.Tensor:
    """(ACT, 12, 3) world-lattice edge-vertex positions (voxel units)."""
    bs = config.block_size
    tb = _tables(s["t12"].device)
    lidx = s["lidx_c"]
    local = torch.stack([lidx // (bs * bs), (lidx // bs) % bs, lidx % bs], dim=-1)
    base = (s["coords"][s["block_of"]] * bs + local).to(torch.float32)   # (ACT, 3)
    return base[:, None] + tb.off_a[None] + s["t12"][..., None] * (tb.off_b - tb.off_a)[None]


def _select_edges(tri_all: torch.Tensor, per_edge: torch.Tensor) -> torch.Tensor:
    """Per-vertex values picked from the 12 per-edge ones: ``tri_all``
    (ACT, 15) holds edge ids (-1 pads, which read 0), ``per_edge`` (ACT,
    12[, C])."""
    idx = torch.clamp(tri_all, min=0).long()
    pad = tri_all < 0
    if per_edge.dim() == 3:
        idx = idx[..., None].expand(-1, -1, per_edge.shape[2])
        pad = pad[..., None]
    return torch.where(pad, 0, torch.gather(per_edge, 1, idx))


def extract_mesh(volume: B.VolumeState, config: Config) -> Mesh:
    """Extract the zero isosurface of every allocated block."""
    nb = volume.tsdf.shape[0]
    dev = volume.tsdf.device
    cap = config.max_mesh_triangles
    CB = min(config.mesh_chunk, nb)
    # Rows [0, free_count) cover the null sentinel and every allocated block.
    n_chunks = (read_int(volume.free_count) + CB - 1) // CB
    tb = _tables(dev)

    # Vertex rows tri * 3 + vertex; row cap * 3 is the trash row.
    pos = torch.zeros((cap * 3 + 1, 3), dtype=torch.float32, device=dev)
    col = torch.zeros_like(pos)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros_like(total)
    v = torch.arange(15, device=dev)
    for i in range(n_chunks):
        ids = i * CB + torch.arange(CB, dtype=torch.int32, device=dev)
        row_valid = (ids >= 1) & (ids < volume.free_count)
        s = _chunk_surface(volume, ids, row_valid, config, config.mesh_active_frac)

        offsets = total + torch.cumsum(s["elig"], 0) - s["elig"]   # exclusive
        off_c = s["g"](offsets)                                    # (ACT,)
        tri_all = tb.tri_table[s["cfg_c"].long()]                  # (ACT, 15)
        tri_idx = off_c[:, None] + v[None] // 3
        ok = (
            s["live"][:, None]
            & ((v[None] // 3) < s["counts_c"][:, None])
            & (tri_idx < cap)
        )
        tgt = _trash(torch.where(ok, tri_idx * 3 + v[None] % 3, cap * 3),
                     cap * 3).reshape(-1)
        pos12 = _edge_positions(s, config) * config.voxel_size
        pos.index_put_((tgt,), _select_edges(tri_all, pos12).reshape(-1, 3))
        col.index_put_((tgt,), _select_edges(tri_all, s["c12"]).reshape(-1, 3))
        total = total + s["elig"].sum()
        dropped = dropped + s["dropped"]

    return Mesh(
        positions=pos[:cap * 3].reshape(cap, 3, 3),
        colors=torch.clamp(col[:cap * 3].reshape(cap, 3, 3), 0.0, 1.0),
        count=torch.clamp(total, max=cap).to(torch.int32),
        overflow=(torch.clamp(total - cap, min=0) + dropped).to(torch.int32),
        compact_dropped=dropped.to(torch.int32),
    )


def _compact_flags(flags: torch.Tensor):
    """(NB,) bool -> ((NB,) int64 padded index list, () count)."""
    nb = flags.shape[0]
    order = torch.cumsum(flags, 0) - 1
    lst = torch.zeros((nb + 1,), dtype=torch.int64, device=flags.device)
    lst[torch.where(flags, order, nb)] = torch.arange(nb, device=flags.device)
    return lst[:nb], flags.sum()


def update_mesh_cache(volume: B.VolumeState, cache: MeshCache, config: Config):
    """Re-mesh every block whose triangles may have changed; clear flags.

    The dirty set is ``volume.mesh_dirty`` (blocks whose voxel data
    changed, flagged by integration) expanded by the 7 minus-neighbour
    lookups: block b's halo reads b's +direction neighbours, so a change
    to t re-meshes {t - off}.  Returns ``(volume, cache)``, both new: the
    volume with its flags cleared (the whole expanded set is re-meshed, so
    clearing every flag is exact) and a new cache (the given one is not
    modified); a block whose surface vanished rewrites to count 0.
    """
    nb = volume.tsdf.shape[0]
    dev = volume.tsdf.device
    bs = config.block_size
    ts = config.mesh_slots
    tb = _tables(dev)

    # --- expand the dirty flags by the minus-neighbours ---
    flag_list, n_flagged_t = _compact_flags(volume.mesh_dirty)
    n_flagged = read_int(n_flagged_t)
    CE = min(4096, nb)
    expanded = volume.mesh_dirty.clone()
    for i in range(-(-n_flagged // CE)):
        ids = _dyn_slice(flag_list, i * CE, CE)
        valid = (i * CE + torch.arange(CE, device=dev)) < n_flagged
        coords = volume.block_coords[torch.where(valid, ids, 0)]
        t = B.lookup_blocks(volume, coords[:, None, :] - tb.halo[None], config)
        expanded[torch.where(valid[:, None], t, 0).long().reshape(-1)] = True
    expanded[0] = False

    # --- re-mesh the expanded set ---
    work_list, n_work_t = _compact_flags(expanded)
    n_work = read_int(n_work_t)
    CB = min(config.mesh_chunk, nb)
    size = nb * ts

    def with_trash(x):
        return torch.cat([x.reshape(-1), x.new_zeros(1)])

    words = [with_trash(x) for x in (cache.va, cache.vb, cache.vc,
                                     cache.ca, cache.cb, cache.cc)]
    counts = with_trash(cache.counts)
    dropped = with_trash(cache.dropped)
    k = torch.arange(T.MAX_TRIS, device=dev)
    for i in range(-(-n_work // CB)):
        ids = _dyn_slice(work_list, i * CB, CB)
        row_valid = (
            ((i * CB + torch.arange(CB, device=dev)) < n_work)
            & (ids >= 1) & (ids < volume.free_count)
        )
        s = _chunk_surface(volume, ids, row_valid, config,
                           config.mesh_cache_active_frac)

        elig2 = s["elig"].reshape(CB, bs ** 3)
        cube_off = torch.cumsum(elig2, 1) - elig2            # exclusive per block
        full = s["flat_counts"].reshape(CB, bs ** 3).sum(1)
        kept = torch.clamp(elig2.sum(1), max=ts)

        # Quantize: t -> 16 bits, colour -> rgb888 (clip, round, cast).
        t16 = torch.clamp(torch.round(s["t12"] * 65535.0), 0, 65535).to(torch.int32)
        q = torch.clamp(torch.round(s["c12"] * 255.0), 0, 255).to(torch.int32)
        c888 = (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]   # (ACT, 12)

        tri_all = tb.tri_table[s["cfg_c"].long()]                # (ACT, 15)
        word = (
            (s["lidx_c"].to(torch.int32)[:, None] << 20)
            | (torch.clamp(tri_all, min=0) << 16)
            | _select_edges(tri_all, t16)
        )
        c_sel = _select_edges(tri_all, c888)

        rows = torch.where(row_valid[s["block_of"]], ids[s["block_of"]], nb)
        slot = s["g"](cube_off.reshape(-1))[:, None] + k[None]   # (ACT, 5)
        ok = (
            s["live"][:, None]
            & (k[None] < s["counts_c"][:, None])
            & (slot < ts)
        )
        tgt = _trash(torch.where(ok, rows[:, None] * ts + slot, size), size).reshape(-1)
        for buf, src in zip(words, (word[:, 0::3], word[:, 1::3], word[:, 2::3],
                                    c_sel[:, 0::3], c_sel[:, 1::3], c_sel[:, 2::3])):
            buf.index_put_((tgt,), src.reshape(-1))
        tgt_rows = _trash(torch.where(row_valid, ids, nb), nb)
        counts.index_put_((tgt_rows,), kept.to(torch.int32))
        dropped.index_put_((tgt_rows,), (full - kept).to(torch.int32))

    volume = dataclasses.replace(
        volume, mesh_dirty=torch.zeros_like(volume.mesh_dirty)
    )
    va, vb, vc, ca, cb, cc = (w[:size].view(nb, ts) for w in words)
    return volume, MeshCache(va=va, vb=vb, vc=vc, ca=ca, cb=cb, cc=cc,
                             counts=counts[:nb], dropped=dropped[:nb])


def cache_to_mesh(volume: B.VolumeState, cache: MeshCache, config: Config) -> Mesh:
    """Decode the per-block triangle cache into a compact triangle soup.

    The slot -> output lane map is built in row chunks whose count follows
    ``free_count``.  Triangle order matches ``extract_mesh`` (ascending
    block row, cube order within the block); lanes past the count read
    slot 0 and are zeroed.
    """
    nb, ts = cache.counts.shape[0], cache.va.shape[1]
    dev = cache.va.device
    bs = config.block_size
    cap = config.max_mesh_triangles
    tb = _tables(dev)

    counts = cache.counts.long()
    offsets = torch.cumsum(counts, 0) - counts               # exclusive
    total = counts.sum()

    RC = min(8192, nb)
    n_rch = (read_int(torch.clamp(volume.free_count, max=nb)) + RC - 1) // RC
    lane_of = torch.arange(RC * ts, device=dev)
    sl, rrel = lane_of % ts, lane_of // ts
    gmap = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    for i in range(n_rch):
        base = i * RC
        cnt = _dyn_slice(cache.counts, base, RC)[rrel]
        off = _dyn_slice(offsets, base, RC)[rrel]
        dst = torch.where(sl < cnt, off + sl, cap)
        gmap.index_put_((_trash(dst, cap),), (base + rrel) * ts + sl)
    gmap = gmap[:cap]

    lane_ok = (torch.arange(cap, device=dev) < torch.clamp(total, max=cap))[:, None]
    # A row chunk clamped at the end of the table (num_blocks not a multiple
    # of RC) maps rows past it; the reference's gathers clamp them, and an
    # out-of-range gather on the card would fault.
    gmap = torch.clamp(gmap, max=nb * ts - 1)
    base_xyz = volume.block_coords[gmap // ts] * bs          # (cap, 3) int32

    def decode(vwords, cwords):
        """-> ((cap, 3) position, (cap, 3) colour) of one triangle vertex."""
        vword = vwords.reshape(-1)[gmap]
        cword = cwords.reshape(-1)[gmap]
        lidx = (vword >> 20) & 0x1FF
        edge = ((vword >> 16) & 0xF).long()
        t = (vword & 0xFFFF).to(torch.float32) * (1.0 / 65535.0)
        local = torch.stack([lidx // (bs * bs), (lidx // bs) % bs, lidx % bs], dim=-1)
        a = tb.off_a[edge]
        p = ((base_xyz + local).to(torch.float32) + a
             + t[:, None] * (tb.off_b[edge] - a)) * config.voxel_size
        c = torch.stack([(cword >> s) & 0xFF for s in (16, 8, 0)], dim=-1)
        c = c.to(torch.float32) * (1.0 / 255.0)
        return torch.where(lane_ok, p, 0.0), torch.where(lane_ok, c, 0.0)

    verts = [decode(v, c) for v, c in ((cache.va, cache.ca), (cache.vb, cache.cb),
                                       (cache.vc, cache.cc))]
    dropped = cache.dropped.sum()
    return Mesh(
        positions=torch.stack([p for p, _ in verts], dim=1),
        colors=torch.clamp(torch.stack([c for _, c in verts], dim=1), 0.0, 1.0),
        count=torch.clamp(total, max=cap).to(torch.int32),
        overflow=(torch.clamp(total - cap, min=0) + dropped).to(torch.int32),
        compact_dropped=dropped.to(torch.int32),
    )
