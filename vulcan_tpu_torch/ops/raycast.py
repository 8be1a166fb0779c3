"""Sparse raycast through the voxel-block hash, and the renderer dispatch.

Counterpart of ``vulcan_tpu/ops/raycast.py``:

  1. ``compute_range_image``: visible blocks stamp their projected AABB
     into a coarse (1/``range_scale``) min/max range image, upsampled to
     full resolution (scatter-min/max on the CPU, kernel R1 on the card);
     blocks whose footprint exceeds the fixed stamp widen a conservative
     global range instead;
  2. ``_march``: each round samples ``S`` positions along every ray at once
     through the per-frame render cache (two gathers a sample, no hash
     probe) and takes the first +to- sign change;
  3. ``raycast``: a coarse march at 1/``raycast_coarse`` resolution, a
     per-pixel window from its 3x3 neighbourhood, the fine march in the
     window, sub-voxel depth from the quantized bracket, ``refine_steps``
     trilinear secant rounds, then cross-product (or TSDF-gradient)
     normals and nearest colour;
  4. ``render``: the renderer ``Config.render_mode`` names (the march here,
     the surfel splat in ``ops/splat.py``).

The reference's early exit becomes a fixed trip count: each march runs
all ``n_rounds`` rounds (a finished ray's outputs never change, so the
arrays equal the reference's early exit).  The compacted-survivor branch
is the reference's ``lax.cond`` (``utils.sync.cond``: eager, one counted
read of its predicate; captured, one IF/ELSE node on the device).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..utils import sync
from . import blocks as B
from . import cuda_kernels
from . import render_cache as RC
from .dense import floor_to_int, round_to_int
from .preprocess import _shift2d


@dataclasses.dataclass(frozen=True)
class Render:
    """Rendered model maps; vertex/normal channels are planar (H, W)."""

    depth: torch.Tensor          # (H, W) z-depth, 0 invalid
    vx: torch.Tensor             # (H, W) world vertex channels
    vy: torch.Tensor
    vz: torch.Tensor
    nx: torch.Tensor             # (H, W) world unit normal channels, 0 invalid
    ny: torch.Tensor
    nz: torch.Tensor
    color: torch.Tensor          # (H, W, 3)
    valid: torch.Tensor          # (H, W) bool
    camera: PinholeCamera
    pose: SE3                    # camera-to-world used for the render

    @property
    def vertex_world(self) -> torch.Tensor:  # (H, W, 3)
        return torch.stack([self.vx, self.vy, self.vz], dim=-1)

    @property
    def normal_world(self) -> torch.Tensor:  # (H, W, 3)
        return torch.stack([self.nx, self.ny, self.nz], dim=-1)


def _upsample(a: torch.Tensor, k: int, height: int, width: int) -> torch.Tensor:
    """Nearest upsample by ``k`` in both axes, cut to (height, width)."""
    return a.repeat_interleave(k, 0).repeat_interleave(k, 1)[:height, :width]


class RangeRows(NamedTuple):
    """The range image's per-row values of the visible list (V,), and the
    overflow rows' global range (0-d)."""

    z_min: torch.Tensor          # near / far depth, clamped to [ray_near, ray_far]
    z_max: torch.Tensor
    u_min: torch.Tensor          # int64 footprint in coarse cells
    u_max: torch.Tensor
    v_min: torch.Tensor
    v_max: torch.Tensor
    behind: torch.Tensor         # a corner behind the camera
    oversize: torch.Tensor       # a footprint wider than the stamp
    stampable: torch.Tensor      # a listed block that stamps its footprint
    any_overflow: torch.Tensor   # a listed block that widens the global range
    g_min: torch.Tensor
    g_max: torch.Tensor


def _range_rows(volume: B.VolumeState, camera: PinholeCamera, pose: SE3,
                config: Config) -> RangeRows:
    """Each visible row's depth range and coarse-cell footprint: its
    block's AABB corners in the camera, projected."""
    sc = config.range_scale
    ids = volume.visible_ids
    dev = ids.device
    row_valid = B.visible_rows(volume)

    be = config.block_extent
    coords = volume.block_coords[ids.long()].to(torch.float32)      # (V, 3)
    a = torch.arange(2.0, device=dev)
    corner = torch.stack(torch.meshgrid(a, a, a, indexing="ij"), dim=-1).reshape(8, 3)
    pts = (coords[:, None, :] + corner) * be                          # (V, 8, 3)
    cam = pose.inverse().apply(pts)
    z = cam[..., 2]
    uv = camera.project(cam)

    margin = config.trunc_dist
    z_min = torch.clamp(torch.amin(z, dim=1) - margin, config.ray_near, config.ray_far)
    z_max = torch.clamp(torch.amax(z, dim=1) + margin, config.ray_near, config.ray_far)

    # Coarse-cell bbox of the projected corners; a corner behind the
    # camera makes the footprint unbounded -> overflow path.
    behind = torch.any(z <= 1e-3, dim=1)
    u_min = floor_to_int(torch.amin(uv[..., 0], dim=1) / sc)
    u_max = floor_to_int(torch.amax(uv[..., 0], dim=1) / sc)
    v_min = floor_to_int(torch.amin(uv[..., 1], dim=1) / sc)
    v_max = floor_to_int(torch.amax(uv[..., 1], dim=1) / sc)
    st = config.range_stamp
    oversize = (u_max - u_min >= st) | (v_max - v_min >= st)
    overflow = row_valid & (behind | oversize)
    stampable = row_valid & ~overflow

    inf = float("inf")
    any_overflow = torch.any(overflow)
    g_min = torch.amin(torch.where(overflow, z_min, inf))
    g_max = torch.amax(torch.where(overflow, z_max, -inf))
    return RangeRows(z_min, z_max, u_min, u_max, v_min, v_max, behind, oversize, stampable,
                     any_overflow, g_min, g_max)


def _stamp_lanes(rows: RangeRows, hc: int, wc: int, st: int):
    """The plain stamps' lanes: each row's fixed st x st stamp as (V * st *
    st,) flat cell indices, index hc*wc a trash slot for masked lanes, and
    the rows' z_min and z_max beside them."""
    du = torch.arange(st, device=rows.z_min.device)
    cu = rows.u_min[:, None, None] + du[None, :, None]                # (V, st, 1)
    cv = rows.v_min[:, None, None] + du[None, None, :]                # (V, 1, st)
    inside = (
        rows.stampable[:, None, None]
        & (cu <= rows.u_max[:, None, None])
        & (cv <= rows.v_max[:, None, None])
        & (cu >= 0) & (cu < wc) & (cv >= 0) & (cv < hc)
    )                                                                 # (V, st, st)
    flat = torch.where(inside, cv * wc + cu, hc * wc).reshape(-1)
    zmin_b = torch.broadcast_to(rows.z_min[:, None, None], inside.shape).reshape(-1)
    zmax_b = torch.broadcast_to(rows.z_max[:, None, None], inside.shape).reshape(-1)
    return flat, zmin_b, zmax_b


def _range_image_plain(rows: RangeRows, height: int, width: int, config: Config):
    """The stamps and the upsample of ``compute_range_image`` in PyTorch:
    the CPU's path and the yardstick of kernel R1."""
    sc = config.range_scale
    hc = -(-height // sc)
    wc = -(-width // sc)
    dev = rows.z_min.device
    inf = float("inf")
    flat, zmin_b, zmax_b = _stamp_lanes(rows, hc, wc, config.range_stamp)

    def stamp(init, values, how):
        buf = torch.full((hc * wc + 1,), init, dtype=torch.float32, device=dev)
        buf.scatter_reduce_(0, flat, values, how, include_self=True)
        return buf[:hc * wc].reshape(hc, wc)

    t_min = stamp(inf, zmin_b, "amin")
    t_fmax = stamp(inf, zmax_b, "amin")
    t_max = stamp(-inf, zmax_b, "amax")

    any_overflow, g_min, g_max = rows.any_overflow, rows.g_min, rows.g_max
    t_min = torch.where(any_overflow, torch.minimum(t_min, g_min), t_min)
    t_fmax = torch.where(any_overflow, torch.minimum(t_fmax, g_max), t_fmax)
    t_max = torch.where(any_overflow, torch.maximum(t_max, g_max), t_max)
    return (_upsample(t_min, sc, height, width), _upsample(t_fmax, sc, height, width),
            _upsample(t_max, sc, height, width))


def compute_range_image(volume: B.VolumeState, camera: PinholeCamera, pose: SE3,
                        height: int, width: int, config: Config):
    """Per-pixel conservative [t_min, t_max] from the visible blocks' AABBs.

    Returns (t_min, t_first_max, t_max) at full resolution (upsampled from
    the coarse grid); ``t_first_max`` is the exit depth of the nearest
    stamped block.  Pixels no visible block projects to get t_min > t_max.
    The rows' values are PyTorch ops on any device; a CPU tensor then takes
    the plain stamps (``_range_image_plain``), a CUDA tensor launches kernel
    R1 (``csrc/range_image.cu``: the stamps, then the upsample) or raises.
    Every launch is counted on the card: ``cuda_kernels.launch_counts``."""
    rows = _range_rows(volume, camera, pose, config)
    if volume.visible_ids.is_cpu:
        return _range_image_plain(rows, height, width, config)
    sc = config.range_scale
    maps = cuda_kernels.range_image(
        rows.z_min, rows.z_max, (rows.u_min, rows.u_max, rows.v_min, rows.v_max),
        rows.stampable, volume.num_visible, rows.any_overflow, rows.g_min, rows.g_max,
        (-(-height // sc), -(-width // sc)), config.range_stamp, sc, (height, width))
    return tuple(maps.unbind(0))


def _march(cache, config, ox, oy, oz, dx_, dy_, dz_, t0, spacing, t_limit, active,
           S, n_rounds, compact_div=0):
    """Batched sign-change march (shared by the coarse and fine levels).

    Samples S data-independent positions a round and records the first
    +to- crossing: the bracketing positions and their quantized values.
    Returns (t_hit, t_before, m_before, m_hit, hit).

    With ``compact_div`` > 0 only round 1 runs at full width; when at most
    M = max(n // compact_div, 256) rays survive it, the remaining rounds
    run over those M rays alone and scatter back, else at full width: the
    reference's ``lax.cond`` (``sync.cond``), whose two branches return
    fresh arrays of the rays' shape.
    """
    inv_vs = 1.0 / config.voxel_size
    dev = t0.device
    offs = torch.arange(S, dtype=torch.float32, device=dev)

    def make_sampler(dx, dy, dz, spacing):
        def sample_chunk(t_start):
            ts = t_start[..., None] + spacing[..., None] * offs
            gx = round_to_int((ox + ts * dx[..., None]) * inv_vs)
            gy = round_to_int((oy + ts * dy[..., None]) * inv_vs)
            gz = round_to_int((oz + ts * dz[..., None]) * inv_vs)
            return RC.sample_march_texture(cache, gx, gy, gz, config)
        return sample_chunk

    def round_step(sample_chunk, spacing, t_limit, carry):
        t_cur, last_m, t_hit, t_before, m_b, m_h, done = carry
        m = sample_chunk(t_cur)
        prev = torch.cat([last_m[..., None], m[..., :-1]], dim=-1)
        crossing = ((prev > 0) & (m <= 0) & (m != RC.MARCH_UNSEEN)
                    & (prev != RC.MARCH_UNSEEN))
        found = torch.any(crossing, dim=-1) & ~done
        # The first True (0 when none): argmax returns the first maximum.
        first = torch.argmax(crossing.to(torch.uint8), dim=-1)
        th = t_cur + spacing * first.to(torch.float32)
        m_hit_new = torch.gather(m, -1, first[..., None])[..., 0]
        m_bef_new = torch.gather(prev, -1, first[..., None])[..., 0]
        t_hit = torch.where(found, th, t_hit)
        t_before = torch.where(found, th - spacing, t_before)
        m_b = torch.where(found, m_bef_new, m_b)
        m_h = torch.where(found, m_hit_new, m_h)
        done = done | found
        t_cur = t_cur + spacing * S
        done = done | (t_cur > t_limit)
        return t_cur, m[..., -1], t_hit, t_before, m_b, m_h, done

    def run(sample_chunk, spacing, t_limit, carry, rounds):
        # A finished ray's outputs never change, so running every round
        # equals the reference's exit once all rays are done.
        for _ in range(rounds):
            carry = round_step(sample_chunk, spacing, t_limit, carry)
        return carry

    def q(fill):
        return torch.full(t0.shape, fill, dtype=torch.int32, device=dev)

    zero = torch.zeros_like(t0)
    carry = (t0, q(127), zero, zero, q(127), q(127), ~active)
    full_sampler = make_sampler(dx_, dy_, dz_, spacing)
    if not compact_div:
        carry = run(full_sampler, spacing, t_limit, carry, n_rounds)
        t_hit, t_before, m_b, m_h = carry[2:6]
        return t_hit, t_before, m_b, m_h, t_hit > 0.0

    carry = round_step(full_sampler, spacing, t_limit, carry)
    n = t0.numel()
    M = max(n // compact_div, 256)

    def full():
        return run(full_sampler, spacing, t_limit, carry, n_rounds - 1)[2:6]

    def compact():
        # The first M undone rays, by cumsum + scatter (index M is a trash
        # slot for the rest), then the remaining rounds on them alone.
        undone = ~carry[-1].reshape(-1)
        order = torch.cumsum(undone.to(torch.int64), 0) - 1
        ids = torch.full((M + 1,), n, dtype=torch.int64, device=dev)
        ids.index_put_((torch.where(undone & (order < M), order, M),),
                       torch.arange(n, device=dev))
        ids = ids[:M]
        live = ids < n
        ids = torch.where(live, ids, 0)

        def g(a):
            return a.reshape(-1)[ids]

        spc, tlc = g(spacing), g(t_limit)
        t_cur, last_m, t_hit, t_before, m_b, m_h, done = carry
        carry_c = (g(t_cur), g(last_m), g(t_hit), g(t_before), g(m_b), g(m_h),
                   g(done) | ~live)
        carry_c = run(make_sampler(g(dx_), g(dy_), g(dz_), spc), spc, tlc, carry_c,
                      n_rounds - 1)
        tgt = torch.where(live, ids, n)

        def scatter_back(whole, comp):
            out = torch.cat([whole.reshape(-1), whole.new_zeros(1)])
            out[tgt] = comp
            return out[:n].reshape(t0.shape)

        return tuple(scatter_back(f, c) for f, c in
                     zip((t_hit, t_before, m_b, m_h), carry_c[2:6]))

    t_hit, t_before, m_b, m_h = sync.cond(torch.sum(~carry[-1]) <= M, compact, full)
    return t_hit, t_before, m_b, m_h, t_hit > 0.0


def _pool(a: torch.Tensor, k: int, amax: bool) -> torch.Tensor:
    """k x k min- (or max-) pool with stride k, edges padded by replication."""
    h, w = a.shape
    ph, pw = (-h) % k, (-w) % k
    if ph:
        a = torch.cat([a, a[-1:].expand(ph, w)], 0)
    if pw:
        a = torch.cat([a, a[:, -1:].expand(h + ph, pw)], 1)
    r = a.reshape((h + ph) // k, k, (w + pw) // k, k)
    return torch.amax(r, dim=(1, 3)) if amax else torch.amin(r, dim=(1, 3))


def _minpool(a, k):
    return _pool(a, k, amax=False)


def _maxpool(a, k):
    return _pool(a, k, amax=True)


def _dilate3(a: torch.Tensor, op) -> torch.Tensor:
    """3x3 min/max dilation (outside the image counts as no constraint)."""
    out = a
    fill = float("inf") if op is torch.minimum else -float("inf")
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = op(out, _shift2d(a, dy, dx, fill=fill))
    return out


def _secant(t_lo, t_hi, f_lo, f_hi):
    """The zero of the line through (t_lo, f_lo) and (t_hi, f_hi), kept in
    [t_lo, t_hi] (the midpoint where the values are equal)."""
    denom = f_lo - f_hi
    alpha = torch.where(torch.abs(denom) > 1e-12, f_lo / denom, 0.5)
    return t_lo + torch.clamp(alpha, 0.0, 1.0) * (t_hi - t_lo)


def raycast(volume: B.VolumeState, camera: PinholeCamera, pose: SE3, height: int,
            width: int, config: Config, normals: str = "cross",
            with_color: bool = True) -> Render:
    """Render model depth/vertex/normal/colour maps from the sparse TSDF
    by the hierarchical march (see the module docstring).  The march
    renders rgb colour only."""
    vs = config.voxel_size
    mu = config.trunc_dist
    dev = volume.tsdf.device
    rays_world = pose.rotate(camera.rays(height, width, dev))
    dx_, dy_, dz_ = rays_world[..., 0], rays_world[..., 1], rays_world[..., 2]
    dir_norm = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    inv_dir_norm = 1.0 / torch.clamp(dir_norm, min=1e-9)
    origin = pose.translation
    ox, oy, oz = origin[0], origin[1], origin[2]

    cache = RC.build(volume, config)
    t_min, t_fmax, t_max = compute_range_image(volume, camera, pose, height, width,
                                               config)
    has_range = t_min <= t_max
    inf = float("inf")

    S = config.raycast_chunk
    # Both levels run ceil(raycast_steps / raycast_chunk) rounds, the fine
    # one too (with raycast_fine_chunk samples a round), as the reference.
    n_rounds = -(-config.raycast_steps // S)
    k = config.raycast_coarse

    # --- coarse march at 1/k resolution --------------------------------
    cdx, cdy, cdz = dx_[::k, ::k], dy_[::k, ::k], dz_[::k, ::k]
    c_inv = inv_dir_norm[::k, ::k]
    c_tmin = _minpool(t_min, k)
    c_tfmax = _maxpool(torch.where(has_range, t_fmax, -inf), k)
    c_tmax = _maxpool(torch.where(has_range, t_max, -inf), k)
    c_active = c_tmin <= c_tmax
    c_span = torch.clamp(c_tfmax - c_tmin, min=0.0)
    c_spacing = torch.minimum(
        torch.maximum(c_span / S, 0.75 * vs * c_inv),
        2.0 * config.raycast_step_scale * mu * c_inv,
    )
    ct_hit, _, _, _, c_hit = _march(
        cache, config, ox, oy, oz, cdx, cdy, cdz,
        torch.where(c_active, c_tmin, config.ray_far),
        c_spacing, c_tmax, c_active, S, n_rounds,
        compact_div=config.raycast_coarse_compact,
    )

    # --- conservative full-res window from the coarse depth ------------
    w_pad = 2.0 * c_spacing
    c_lo = torch.where(c_hit, ct_hit - w_pad, c_tmin)
    c_hi = torch.where(c_hit, ct_hit + w_pad, c_tfmax)   # miss: first band only
    c_lo = _dilate3(c_lo, torch.minimum)
    c_hi = _dilate3(c_hi, torch.maximum)
    lo = torch.maximum(_upsample(c_lo, k, height, width), t_min)
    hi = torch.minimum(torch.maximum(_upsample(c_hi, k, height, width), lo), t_max)

    # --- fine march in the window --------------------------------------
    Sf = config.raycast_fine_chunk
    span_f = torch.clamp(hi - lo, min=0.0)
    spacing_f = torch.minimum(
        torch.maximum(span_f / Sf, 0.5 * vs * inv_dir_norm),
        config.raycast_step_scale * mu * inv_dir_norm,
    )
    t_hit, t_before, m_b, m_h, hit = _march(
        cache, config, ox, oy, oz, dx_, dy_, dz_,
        torch.where(has_range, lo, config.ray_far),
        spacing_f, hi, has_range, Sf, n_rounds,
        compact_div=config.raycast_fine_compact,
    )

    # --- sub-voxel depth from the quantized bracket --------------------
    f_lo = m_b.to(torch.float32) / 127.0
    f_hi = m_h.to(torch.float32) / 127.0
    t_surf = _secant(t_before, t_hit, f_lo, f_hi)

    # --- optional trilinear secant polish ------------------------------
    t_lo, t_hi2, fl, fh = t_before, t_hit, f_lo, f_hi
    for _ in range(config.refine_steps):
        f_mid, _ = RC.sample_trilinear_axes(
            cache, ox + t_surf * dx_, oy + t_surf * dy_, oz + t_surf * dz_, config)
        pos = f_mid > 0.0
        t_lo = torch.where(pos, t_surf, t_lo)
        fl = torch.where(pos, f_mid, fl)
        t_hi2 = torch.where(pos, t_hi2, t_surf)
        fh = torch.where(pos, fh, f_mid)
        t_surf = _secant(t_lo, t_hi2, fl, fh)

    px = ox + t_surf * dx_
    py = oy + t_surf * dy_
    pz = oz + t_surf * dz_

    if normals == "gradient":
        nx, ny, nz, n_ok = RC.sample_gradient_axes(cache, px, py, pz, config)
    else:
        nx, ny, nz, n_ok = _cross_normals_axes(px, py, pz, hit)
    # Orient toward the viewer.
    sign = torch.where(nx * dx_ + ny * dy_ + nz * dz_ > 0.0, -1.0, 1.0)
    nx, ny, nz = nx * sign, ny * sign, nz * sign

    if with_color:
        color, _ = RC.sample_color_nearest_axes(cache, volume, px, py, pz, config)
    else:
        color = torch.zeros((height, width, 3), device=dev)

    valid = hit & n_ok
    zero = torch.zeros((), device=dev)
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


def render(
    volume,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    normals: str = "cross",
    with_color: bool = True,
    color_space: str = "rgb",
) -> Render:
    """Render model maps with the configured renderer (march or splat).
    ``color_space="luma"`` is honoured by the splat's surfel-colour path
    (a grey intensity render, see ``ops/splat.py``); the march always
    renders rgb."""
    if config.render_mode == "splat":
        from . import splat

        return splat.render_splat(
            volume, camera, pose, height, width, config, normals,
            with_color, color_space=color_space,
        )
    return raycast(volume, camera, pose, height, width, config, normals, with_color)


def _cross_normals_axes(px, py, pz, hit):
    """Image-space forward-difference cross-product normals, planar."""
    e1x = _shift2d(px, 0, 1) - px
    e1y = _shift2d(py, 0, 1) - py
    e1z = _shift2d(pz, 0, 1) - pz
    e2x = _shift2d(px, 1, 0) - px
    e2y = _shift2d(py, 1, 0) - py
    e2z = _shift2d(pz, 1, 0) - pz
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    hf = hit.to(torch.float32)
    hr = _shift2d(hf, 0, 1) > 0.5
    hd = _shift2d(hf, 1, 0) > 0.5
    ok = hit & hr & hd & (norm > 1e-12)
    inv = 1.0 / torch.clamp(norm, min=1e-12)
    return nx * inv, ny * inv, nz * inv, ok
