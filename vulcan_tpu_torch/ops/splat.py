"""Surfel-splatting model renderer.

Counterpart of ``vulcan_tpu/ops/splat.py``'s ``render_splat``:

  1. the z-buffer, from one of three sources:
     ``_splat_zbuf_surfels`` (``splat_source="surfels"``, the default):
     every surfel of the persistent per-block lists (z_surf = z_voxel +
     tsdf * mu on the voxel's own ray) scatter-mins its depth, by kernel
     S1 on the card and in two tiers over the surfel slots on the CPU
     (its plain version).  Without colour it is a float32
     z-buffer; ``model_color="luma"`` makes it one scatter-min of a packed
     ``zq19 << 12 | luma12`` int32 word, ``"rgb"`` adds a second pass that
     scatters each depth winner's rgb888;
     ``_splat_zbuf_direct`` (``splat_source="direct"``): the same surfel
     model read straight from the voxel rows of the blocks that hold a
     near-surface voxel (``_surface_block_list``);
     ``_splat_zbuf_cached``: voxel-edge crossings of the render-cache
     halos, used whenever the cache is built anyway (polish, gradient
     normals, or colour off the surfel path);
  2. ``_fill_and_smooth`` (kernel K2 on the card): hole fill and
     edge-aware smoothing of the z-buffer, on every source;
  3. the optional trilinear polish (``splat_polish`` secant rounds on the
     cache's quantized march texture), cross-product or TSDF-gradient
     normals and their 3x3 smoothing, and the model colour: diffused into
     the hole-filled pixels on the surfel paths, nearest-voxel through the
     cache otherwise.

The reference picks a surfel's rgb out of its block's ``colorpack`` row
with a one-hot matmul (a TPU layout trick, exact for 0..255); here the
same int32 word is read by index.
"""
from __future__ import annotations

import functools

import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..utils import sync
from ..utils.sync import read_ints
from . import blocks as B
from . import cuda_kernels
from . import render_cache as RC
from .allocate import compact_mask
from .dense import round_to_int
from .preprocess import _shift2d
from .raycast import Render, _cross_normals_axes, _secant

_ZQ_BITS = 19                       # packed-luma depth quantization bits
_ZQ_MAX = (1 << _ZQ_BITS) - 1       # depth step = ray_far / _ZQ_MAX
_LUMA_EMPTY = 0x7FFFFFFF            # packed-luma z-buffer init value


def _decode_luma_zbuf(word: torch.Tensor, config: Config):
    """Packed (zq19 << 12 | i12) -> (depth f32, +inf empty; intensity)."""
    valid = word != _LUMA_EMPTY
    depth = torch.where(
        valid, (word >> 12).to(torch.float32) * (config.ray_far / _ZQ_MAX),
        float("inf"),
    )
    inten = torch.where(
        valid, (word & 0xFFF).to(torch.float32) * (1.0 / 4095.0), 0.0
    )
    return depth, inten


def _surface_block_list(volume: B.VolumeState, config: Config):
    """Visible blocks holding an observed voxel inside the splat band,
    compacted (one dense row pass + a prefix-sum compaction)."""
    ids = volume.visible_ids
    rows = ids.to(torch.int64)
    near = (torch.abs(volume.tsdf[rows]) < B.surfel_band(config)) & (
        volume.weight[rows] > 0.0)
    has_surf = B.visible_rows(volume) & torch.any(near, dim=1)
    n_surf = torch.sum(has_surf).to(torch.int32)
    return compact_mask(has_surf, ids, ids.shape[0], 0), n_surf


def _surfel_block_list(volume: B.VolumeState, config: Config):
    """Visible blocks with a nonempty persistent surfel list, compacted."""
    ids = volume.visible_ids
    has_surf = B.visible_rows(volume) & (volume.surf_count[ids.to(torch.int64)] > 0)
    n_surf = torch.sum(has_surf).to(torch.int32)
    return compact_mask(has_surf, ids, ids.shape[0], 0), n_surf


def _to_camera(w2c: SE3, wx, wy, wz):
    """World points given per axis -> camera coordinates, per axis."""
    R, tr = w2c.rotation, w2c.translation
    cx = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + tr[0]
    cy = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + tr[1]
    cz = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + tr[2]
    return cx, cy, cz


def _pixel(camera: PinholeCamera, cx, cy, cz, zok, height: int, width: int):
    """The pixel each point projects to, rounded half to even: (flat
    index, with height*width a trash slot for the masked lanes; in-bounds
    mask)."""
    zc = torch.clamp(cz, min=1e-6)
    u = round_to_int(camera.fx * cx / zc + camera.cx)
    v = round_to_int(camera.fy * cy / zc + camera.cy)
    inb = (u >= 0) & (u < width) & (v >= 0) & (v < height) & zok
    return torch.where(inb, v * width + u, height * width), inb


def _local_xyz(device):
    """Planar local voxel coordinates (1, 512) of lidx = (lx*8+ly)*8+lz."""
    lidx = torch.arange(512, device=device)[None, :]
    return ((lidx // 64).to(torch.float32), ((lidx // 8) % 8).to(torch.float32),
            (lidx % 8).to(torch.float32))


def _scatter_surfels(buf, volume: B.VolumeState, camera: PinholeCamera, w2c: SE3, cw,
                     ids, lanes_ok, s_lo: int, s_hi: int, height: int, width: int,
                     config: Config, luma: bool = False, zref=None) -> None:
    """Scatter surfel slots [s_lo, s_hi) of the blocks ``ids`` (int64,
    (C,)) into ``buf`` where ``lanes_ok`` ((C, 1) or (C, s_hi - s_lo) bool)
    holds; index H*W of ``buf`` is a trash slot for the masked lanes.  The
    min depth, or with ``luma`` the packed luma word, or (``zref`` given)
    the max rgb888 colour of the surfels whose depth won ``zref``.
    ``w2c``: the world-to-camera pose; ``cw``: the camera centre."""
    vs = config.voxel_size
    mu = config.trunc_dist
    npix = height * width
    rows = volume.surfpack[ids][:, s_lo:s_hi]
    lidx, t, valid, (gx, gy, gz) = B.unpack_surfels(rows)
    valid = valid & lanes_ok
    coords = volume.block_coords[ids].to(torch.float32)  # (C, 3)

    lx = (lidx // 64).to(torch.float32)
    ly = ((lidx // 8) % 8).to(torch.float32)
    lz = (lidx % 8).to(torch.float32)
    wx = (coords[:, 0:1] * 8 + lx) * vs
    wy = (coords[:, 1:2] * 8 + ly) * vs
    wz = (coords[:, 2:3] * 8 + lz) * vs
    cx, cy, cz = _to_camera(w2c, wx, wy, wz)
    z_surf = cz + t * mu
    # Back-face cull: the stored orientation points outward; a
    # surfel facing away from the camera must not write depth.
    if config.splat_backface_cull:
        back = (
            gx * (wx - cw[0]) + gy * (wy - cw[1]) + gz * (wz - cw[2])
        ) > 0.0
    else:
        back = torch.zeros_like(valid)
    zok = (
        valid
        & ~back
        & (z_surf > config.ray_near)
        & (z_surf < config.ray_far)
        & (cz > 1e-6)
    )
    pix, inb = _pixel(camera, cx, cy, cz, zok, height, width)
    pix = pix.reshape(-1)
    if zref is None and not luma:
        buf.scatter_reduce_(
            0, pix, torch.where(inb, z_surf, float("inf")).reshape(-1),
            "amin",
        )
        return
    # The voxel's colour word (w8|r8|g8|b8) within its block's row.
    word = torch.gather(volume.colorpack[ids], 1, lidx.to(torch.int64))
    r, g, b = (word >> 16) & 0xFF, (word >> 8) & 0xFF, word & 0xFF
    if luma:
        lum = (0.299 * r + 0.587 * g + 0.114 * b) * (1.0 / 255.0)
        i12 = torch.clamp(torch.round(lum * 4095.0), 0, 4095).to(torch.int32)
        zq = torch.clamp(
            torch.round(z_surf * (_ZQ_MAX / config.ray_far)),
            0, _ZQ_MAX - 1,   # keeps the word below _LUMA_EMPTY
        ).to(torch.int32)
        packed = (zq << 12) | i12
        buf.scatter_reduce_(
            0, pix, torch.where(inb, packed, _LUMA_EMPTY).reshape(-1),
            "amin",
        )
        return
    rgb888 = (r << 16) | (g << 8) | b
    zb = zref[torch.clamp(pix, max=npix - 1)].reshape(z_surf.shape)
    win = inb & (z_surf <= zb + 1e-5)
    buf.scatter_reduce_(
        0, pix, torch.where(win, rgb888, -1).reshape(-1), "amax"
    )


def _splat_zbuf_surfels_plain(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    with_color: bool = False,
    luma: bool = False,
):
    """Kernel S1's plain version, on any device: tier 1 scatters slots
    [0, S/2) of every surface block in chunks of 2048 blocks, tier 2 slots
    [S/2, S) of the blocks that use them in chunks of 512: the reference's
    two ``lax.while_loop``s (``utils.sync.chunk_loop``).  Eager, the tiers'
    lengths are read on the host (one counted read) to size the chunk
    loops; while a CUDA graph is captured, each loop is one WHILE node on
    the device length.  A chunk's blocks are the list's entries at its
    device offset; lanes past the length scatter into the trash slot.
    Returns what ``_splat_zbuf_surfels`` returns."""
    S = config.surfel_slots
    w2c = pose.inverse()
    cw = pose.translation                       # camera centre, world
    dev = volume.tsdf.device
    npix = height * width

    render_ids, n_surf = _surfel_block_list(volume, config)
    V = render_ids.shape[0]
    s1 = S // 2
    full = volume.surf_count[render_ids.to(torch.int64)] > s1
    rowv = (torch.arange(V, device=dev) < n_surf) & full
    ids2 = compact_mask(rowv, render_ids, V, 0)
    n2 = torch.sum(rowv).to(torch.int32)
    lengths = (None, None) if sync.capturing() else read_ints(n_surf, n2)

    def scatter_tier(buf, ids_list, n_list, host_n, s_lo, s_hi, chunk, zref=None):
        """Scatter surfel slots [s_lo, s_hi) of the first ``n_list`` listed
        blocks into ``buf``, in chunks of ``chunk`` blocks.  ``host_n``:
        ``n_list`` read on the host (eager)."""
        C = min(chunk, V)
        lanes = torch.arange(C, device=dev)
        sync.chunk_loop(n_list, V, C, functools.partial(
            scatter_chunk, buf, ids_list, n_list, lanes, s_lo, s_hi, zref), host_n)

    def scatter_chunk(buf, ids_list, n_list, lanes, s_lo, s_hi, zref, offset):
        """One chunk of ``scatter_tier``: the blocks listed at
        ``offset + lanes``."""
        listed = offset + lanes
        ids = ids_list[listed].to(torch.int64)
        rv = (listed < n_list) & (ids > 0)
        _scatter_surfels(buf, volume, camera, w2c, cw, ids, rv[:, None], s_lo, s_hi,
                         height, width, config, luma, zref)

    def tiers(buf, zref=None):
        scatter_tier(buf, render_ids, n_surf, lengths[0], 0, s1, 2048, zref)
        scatter_tier(buf, ids2, n2, lengths[1], s1, S, 512, zref)
        return buf[:npix]

    if luma:
        return tiers(torch.full((npix + 1,), _LUMA_EMPTY, dtype=torch.int32,
                                device=dev))
    zbuf = tiers(torch.full((npix + 1,), float("inf"), dtype=torch.float32,
                            device=dev))
    if not with_color:
        return zbuf
    cbuf = tiers(torch.full((npix + 1,), -1, dtype=torch.int32, device=dev), zbuf)
    return zbuf, cbuf


def splat_scalars(config: Config) -> cuda_kernels.SplatScalars:
    """The ``Config`` scalars S1 takes: each as the plain version's ops see
    it (the depth quantization's scale is ``_ZQ_MAX / ray_far`` in float64,
    rounded to float32 by the wrapper)."""
    return cuda_kernels.SplatScalars(
        config.voxel_size, config.trunc_dist, config.ray_near, config.ray_far,
        _ZQ_MAX / config.ray_far, config.splat_backface_cull,
    )


def _splat_zbuf_surfels(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    with_color: bool = False,
    luma: bool = False,
):
    """Z-buffer (H*W,) from the persistent surfel lists: every surfel of a
    visible block scatter-mins its depth.  A CPU volume takes the plain
    version (``_splat_zbuf_surfels_plain``, the reference's two tiers of
    chunk loops); a CUDA volume launches kernel S1 (``csrc/splat_zbuf.cu``,
    ``cuda_kernels.splat_zbuf``) once, twice with ``with_color``, which
    walks the visible list below its device count (no host read, no loop
    node) and raises for more than ``cuda_kernels.SPLAT_MAX_SLOTS``
    ``surfel_slots``.  Every launch is counted on the card:
    ``cuda_kernels.launch_counts``.

    Returns the float32 z-buffer (+inf = empty); with ``with_color``
    (zbuf, rgb888 int32 buffer, -1 = no colour), whose second pass
    scatter-maxes a surfel's colour where its depth is within 1e-5 m of
    the finished z-buffer; with ``luma`` the packed int32 buffer of one
    scatter-min (nearest depth bin wins, ties to the darker luma; decode
    with ``_decode_luma_zbuf``)."""
    if volume.tsdf.is_cpu:
        return _splat_zbuf_surfels_plain(volume, camera, pose, height, width, config,
                                         with_color, luma)
    dev = volume.tsdf.device
    w2c = pose.inverse()
    frame = torch.cat([w2c.rotation.reshape(9), w2c.translation,
                       pose.translation]).to(dev)
    scalars = splat_scalars(config)

    def launch(mode, fill, dtype, zref=None):
        buf = torch.full((height, width), fill, dtype=dtype, device=dev)
        cuda_kernels.splat_zbuf(
            buf, mode, volume.visible_ids, volume.num_visible,
            (volume.surfpack, volume.surf_count), volume.colorpack, volume.block_coords,
            frame, (camera.fx, camera.fy, camera.cx, camera.cy), scalars, zref)
        return buf

    if luma:
        return launch("luma", _LUMA_EMPTY, torch.int32).reshape(-1)
    zbuf = launch("depth", float("inf"), torch.float32)
    if not with_color:
        return zbuf.reshape(-1)
    cbuf = launch("rgb", -1, torch.int32, zbuf)
    return zbuf.reshape(-1), cbuf.reshape(-1)


def _splat_zbuf_direct(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
):
    """Z-buffer (H*W,) of the projective-TSDF voxel surfels read straight
    from the voxel rows: every observed voxel with |tsdf| inside the splat
    band splats ``z_voxel + tsdf * mu`` at its own projected pixel, under
    the surfel path's back-face cull (the same quantized orientation,
    computed here from the rows).  The chunks of 1024 listed blocks are
    the reference's ``lax.while_loop`` (``utils.sync.chunk_loop``): a
    chunk's blocks are the list's entries at its device offset + lanes,
    masked at the list's length."""
    vs = config.voxel_size
    mu = config.trunc_dist
    w2c = pose.inverse()
    cw = pose.translation                       # camera centre, world
    dev = volume.tsdf.device
    npix = height * width

    render_ids, n_surf = _surface_block_list(volume, config)
    V = render_ids.shape[0]
    C = min(1024, V)
    lanes = torch.arange(C, device=dev)
    lx, ly, lz = _local_xyz(dev)
    band = B.surfel_band(config)
    zbuf = torch.full((npix + 1,), float("inf"), dtype=torch.float32, device=dev)

    def chunk(offset):
        listed = offset + lanes
        ids = render_ids[listed].to(torch.int64)
        rv = (listed < n_surf) & (ids > 0)
        t = volume.tsdf[ids]                                  # (C, 512)
        obs = (volume.weight[ids] > 0.0) & rv[:, None]
        coords = volume.block_coords[ids].to(torch.float32)   # (C, 3)
        wx = (coords[:, 0:1] * 8 + lx) * vs
        wy = (coords[:, 1:2] * 8 + ly) * vs
        wz = (coords[:, 2:3] * 8 + lz) * vs
        cx, cy, cz = _to_camera(w2c, wx, wy, wz)
        z_surf = cz + t * mu
        if config.splat_backface_cull:
            gxq, gyq, gzq = B.quantized_orientation(t)
            back = (
                gxq.to(torch.float32) * (wx - cw[0])
                + gyq.to(torch.float32) * (wy - cw[1])
                + gzq.to(torch.float32) * (wz - cw[2])
            ) > 0.0
        else:
            back = torch.zeros_like(obs)
        zok = (
            obs
            & ~back
            & (torch.abs(t) < band)
            & (z_surf > config.ray_near)
            & (z_surf < config.ray_far)
            & (cz > 1e-6)
        )
        pix, inb = _pixel(camera, cx, cy, cz, zok, height, width)
        zbuf.scatter_reduce_(
            0, pix.reshape(-1), torch.where(inb, z_surf, float("inf")).reshape(-1),
            "amin",
        )

    sync.chunk_loop(n_surf, V, C, chunk)
    return zbuf[:npix]


def _splat_zbuf_cached(
    volume: B.VolumeState,
    cache: RC.RenderCache,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
):
    """Z-buffer (H*W,) of the voxel-edge zero crossings of the render
    cache's halos (+x, +y, +z edges of every voxel), culled by the sign of
    the crossing's axis normal against the ray.  The chunks of 1024
    visible rows are the reference's ``lax.while_loop``
    (``utils.sync.chunk_loop``): a chunk reads the halo rows one past its
    device offset + lanes.  Rows past the visible count hold no observed
    voxel, so they add no crossing."""
    vs = config.voxel_size
    w2c = pose.inverse()
    R = w2c.rotation
    dev = volume.tsdf.device
    npix = height * width

    V = volume.visible_ids.shape[0]
    C = min(1024, V)
    lanes = torch.arange(C, device=dev)
    lx, ly, lz = _local_xyz(dev)
    halo_t = cache.tsdf.view(V + 1, 9, 9, 9)
    halo_m = cache.march.view(V + 1, 9, 9, 9)
    zbuf = torch.full((npix + 1,), float("inf"), dtype=torch.float32, device=dev)

    def chunk(offset):
        rows = offset + 1 + lanes
        t = halo_t[rows]
        obs = halo_m[rows] != RC.MARCH_UNSEEN
        f0 = t[:, :8, :8, :8].reshape(C, 512)
        o0 = obs[:, :8, :8, :8].reshape(C, 512)
        coords = volume.block_coords[cache.row_block[rows].to(torch.int64)]  # (C, 3)
        bx = (coords[:, 0:1] * 8).to(torch.float32) + lx
        by = (coords[:, 1:2] * 8).to(torch.float32) + ly
        bz = (coords[:, 2:3] * 8).to(torch.float32) + lz
        for axis, sl in enumerate((
            (slice(1, 9), slice(0, 8), slice(0, 8)),
            (slice(0, 8), slice(1, 9), slice(0, 8)),
            (slice(0, 8), slice(0, 8), slice(1, 9)),
        )):
            f1 = t[:, sl[0], sl[1], sl[2]].reshape(C, 512)
            o1 = obs[:, sl[0], sl[1], sl[2]].reshape(C, 512)
            crossing = o0 & o1 & ((f0 > 0.0) != (f1 > 0.0))
            d01 = f0 - f1
            tt = torch.clamp(
                f0 / torch.where(torch.abs(d01) > 1e-12, d01, 1.0), 0.0, 1.0)
            wx = (bx + tt * float(axis == 0)) * vs
            wy = (by + tt * float(axis == 1)) * vs
            wz = (bz + tt * float(axis == 2)) * vs
            cx, cy, cz = _to_camera(w2c, wx, wy, wz)
            # Back-face cull: normal ~ -sign(f0) * e_axis (toward +TSDF);
            # front-facing iff ray . normal < 0.
            sgn = torch.where(f0 > 0.0, -1.0, 1.0)
            ndot = sgn * (R[0, axis] * cx + R[1, axis] * cy + R[2, axis] * cz)
            zok = (crossing & (cz > config.ray_near) & (cz < config.ray_far)
                   & (ndot < 0.0))
            pix, inb = _pixel(camera, cx, cy, cz, zok, height, width)
            zbuf.scatter_reduce_(
                0, pix.reshape(-1), torch.where(inb, cz, float("inf")).reshape(-1),
                "amin",
            )

    sync.chunk_loop(volume.num_visible, V, C, chunk)
    return zbuf[:npix]


def _fill_smooth_steps(d: torch.Tensor, mu: float, rounds: int,
                       smooth: bool) -> torch.Tensor:
    """``rounds`` hole-fill rounds of ``d`` (depth, +inf = invalid), then
    the smoothing pass if ``smooth``: what one launch of kernel K2 computes
    (``cuda_kernels.fill_smooth_plan`` entries).

    Fill only where the 3x3 neighbourhood agrees on one surface (filling
    across a silhouette would bleed depth); then average valid neighbours
    within half a truncation band."""
    inf = float("inf")
    for _ in range(rounds):
        best = d
        worst = torch.where(torch.isfinite(d), d, -inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                n_d = _shift2d(d, dy, dx, fill=inf)
                best = torch.minimum(best, n_d)
                worst = torch.maximum(
                    worst, torch.where(torch.isfinite(n_d), n_d, -inf)
                )
        consistent = (worst - best) < 2.0 * mu
        d = torch.where(torch.isfinite(d) | ~consistent, d, best)
    if not smooth:
        return d
    fin = torch.isfinite(d)
    acc = torch.where(fin, d, 0.0)
    cnt = fin.to(torch.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n_d = _shift2d(d, dy, dx, fill=inf)
            ok = torch.isfinite(n_d) & (torch.abs(n_d - d) < 0.5 * mu)
            acc = acc + torch.where(ok, n_d, 0.0)
            cnt = cnt + ok
    return torch.where(fin, acc / torch.clamp(cnt, min=1.0), d)


def _fill_smooth_math(d: torch.Tensor, config: Config) -> torch.Tensor:
    """Plain PyTorch version of kernel K2: ``config.splat_fill_rounds``
    fill rounds, then the smoothing pass."""
    return _fill_smooth_steps(d, config.trunc_dist, config.splat_fill_rounds, True)


def _fill_and_smooth(d: torch.Tensor, config: Config) -> torch.Tensor:
    """Post-splat hole fill + smoothing.  A CPU tensor takes the plain
    version; a CUDA tensor launches kernel K2 (``csrc/fill_smooth.cu``):
    one launch at up to ``cuda_kernels.FILL_SMOOTH_MAX_ROUNDS`` rounds, more
    as ``cuda_kernels.fill_smooth_plan`` splits them.  Every launch is
    counted on the card: ``cuda_kernels.launch_counts``.  Anything the
    kernel does not take raises."""
    if d.is_cpu:
        return _fill_smooth_math(d, config)
    mu = config.trunc_dist
    plan = cuda_kernels.fill_smooth_plan(config.splat_fill_rounds)
    return cuda_kernels.fill_smooth(d, plan, 2.0 * mu, 0.5 * mu)


def _diffuse(value: torch.Tensor, ok: torch.Tensor, rounds: int) -> torch.Tensor:
    """Grow ``value`` (H, W, C) from its ``ok`` pixels into their
    neighbours, ``rounds`` times: each newly reached pixel takes the mean
    of its valid 3x3 neighbours.  The reach of the depth hole fill, so
    filled depth pixels get a colour."""
    for _ in range(rounds):
        okf = ok.to(torch.float32)
        acc = value * okf[..., None]
        cnt = okf
        for ddy in (-1, 0, 1):
            for ddx in (-1, 0, 1):
                if ddx == 0 and ddy == 0:
                    continue
                acc = acc + _shift2d(value * okf[..., None], ddy, ddx)
                cnt = cnt + _shift2d(okf, ddy, ddx)
        grown = cnt > 0.0
        fill = acc / torch.clamp(cnt, min=1.0)[..., None]
        value = torch.where((~ok & grown)[..., None], fill, value)
        ok = ok | grown
    return value


def render_splat(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    normals: str = "cross",
    with_color: bool = True,
    cache: RC.RenderCache | None = None,
    color_space: str = "rgb",
) -> Render:
    """Render model maps by surfel splatting (see the module docstring).

    The render cache is built (or ``cache`` used) only for trilinear work
    (polish, gradient normals) and for colour off the surfel path; the
    surfel path colours its own z-buffer winners, ``color_space="luma"``
    as a grey intensity image from the packed one-pass scatter, ``"rgb"``
    from the two-pass rgb888 scatter.  Without ``with_color`` the colour
    is zeros."""
    inf = float("inf")
    vs = config.voxel_size
    surfel_color = (
        with_color
        and config.splat_source == "surfels"
        and config.splat_polish == 0
        and normals != "gradient"
        and cache is None
    )
    need_cache = (
        config.splat_polish > 0
        or normals == "gradient"
        or (with_color and not surfel_color)
    )
    cbuf = ibuf = None
    if need_cache:
        if cache is None:
            cache = RC.build(volume, config)
        zbuf = _splat_zbuf_cached(volume, cache, camera, pose, height, width, config)
    elif surfel_color and color_space == "luma":
        wbuf = _splat_zbuf_surfels(
            volume, camera, pose, height, width, config, luma=True
        )
        zbuf, ibuf = _decode_luma_zbuf(wbuf, config)
    elif surfel_color:
        zbuf, cbuf = _splat_zbuf_surfels(
            volume, camera, pose, height, width, config, with_color=True
        )
    elif config.splat_source == "surfels":
        zbuf = _splat_zbuf_surfels(volume, camera, pose, height, width, config)
    else:
        zbuf = _splat_zbuf_direct(volume, camera, pose, height, width, config)
    depth = zbuf.reshape(height, width)
    has = torch.isfinite(depth)
    d = _fill_and_smooth(torch.where(has, depth, inf), config)
    depth = torch.where(torch.isfinite(d), d, 0.0)
    hit = depth > 0.0

    rays_world = pose.rotate(camera.rays(height, width, depth.device))
    dx_, dy_, dz_ = rays_world[..., 0], rays_world[..., 1], rays_world[..., 2]
    origin = pose.translation
    ox, oy, oz = origin[0], origin[1], origin[2]

    # Optional trilinear polish onto the ray's crossing, on the quantized
    # march texture: a bracket of +-2 voxels, secant rounds inside it.
    t_surf = depth
    if config.splat_polish > 0:
        inv_dn = 1.0 / torch.clamp(torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_),
                                   min=1e-9)
        half = 2.0 * vs * inv_dn

        def sample_tri(t):
            return RC.sample_march_trilinear_axes(
                cache, ox + t * dx_, oy + t * dy_, oz + t * dz_, config)

        t_lo = t_surf - half
        t_hi = t_surf + half
        f_both, ok_both = sample_tri(torch.stack([t_lo, t_hi], dim=0))
        f_lo, f_hi = f_both[0], f_both[1]
        bracket = (f_lo > 0.0) & (f_hi <= 0.0) & ok_both[0] & ok_both[1]
        for _ in range(config.splat_polish - 1):
            t_mid = _secant(t_lo, t_hi, f_lo, f_hi)
            f_mid, _ = sample_tri(t_mid)
            posm = f_mid > 0.0
            t_lo = torch.where(posm, t_mid, t_lo)
            f_lo = torch.where(posm, f_mid, f_lo)
            t_hi = torch.where(posm, t_hi, t_mid)
            f_hi = torch.where(posm, f_hi, f_mid)
        t_surf = torch.where(bracket & hit, _secant(t_lo, t_hi, f_lo, f_hi), t_surf)

    px = ox + t_surf * dx_
    py = oy + t_surf * dy_
    pz = oz + t_surf * dz_

    if normals == "gradient":
        nx, ny, nz, n_ok = RC.sample_gradient_axes(cache, px, py, pz, config)
    else:
        nx, ny, nz, n_ok = _cross_normals_axes(px, py, pz, hit)
    flip = nx * dx_ + ny * dy_ + nz * dz_ > 0.0
    sign = torch.where(flip, -1.0, 1.0)
    nx, ny, nz = nx * sign, ny * sign, nz * sign

    # Normal smoothing (vector mean over the valid 3x3, renormalized).
    ax = torch.where(n_ok, nx, 0.0)
    ay = torch.where(n_ok, ny, 0.0)
    az = torch.where(n_ok, nz, 0.0)
    sx_, sy_, sz_ = ax, ay, az
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            if ddx == 0 and ddy == 0:
                continue
            sx_ = sx_ + _shift2d(ax, ddy, ddx)
            sy_ = sy_ + _shift2d(ay, ddy, ddx)
            sz_ = sz_ + _shift2d(az, ddy, ddx)
    nrm = torch.sqrt(sx_ * sx_ + sy_ * sy_ + sz_ * sz_)
    good = (nrm > 1e-6) & n_ok
    inv = 1.0 / torch.clamp(nrm, min=1e-6)
    nx = torch.where(good, sx_ * inv, nx)
    ny = torch.where(good, sy_ * inv, ny)
    nz = torch.where(good, sz_ * inv, nz)

    rounds = config.splat_fill_rounds
    if ibuf is not None:
        # Luma: diffuse the scattered intensity (valid where the packed
        # word hit), then broadcast grey: intensity_from_color of (i, i, i)
        # is i, so the tracker sees the packed intensity unchanged.
        inten = _diffuse(ibuf.reshape(height, width, 1), has, rounds)
        color = inten.expand(height, width, 3)
    elif cbuf is not None:
        cimg = cbuf.reshape(height, width)
        c_ok = cimg >= 0
        rgb = torch.stack(
            [(cimg >> 16) & 0xFF, (cimg >> 8) & 0xFF, cimg & 0xFF], dim=-1
        ).to(torch.float32) * (1.0 / 255.0)
        color = _diffuse(torch.where(c_ok[..., None], rgb, 0.0), c_ok, rounds)
    elif with_color:
        color, _ = RC.sample_color_nearest_axes(cache, volume, px, py, pz, config)
    else:
        color = torch.zeros((height, width, 3), device=depth.device)

    valid = hit & n_ok
    zero = torch.zeros((), device=depth.device)
    return Render(
        depth=torch.where(valid, t_surf, zero),
        vx=torch.where(valid, px, zero),
        vy=torch.where(valid, py, zero),
        vz=torch.where(valid, pz, zero),
        nx=torch.where(valid, nx, zero),
        ny=torch.where(valid, ny, zero),
        nz=torch.where(valid, nz, zero),
        color=torch.where(valid[..., None], color, zero),
        valid=valid,
        camera=camera,
        pose=pose,
    )
