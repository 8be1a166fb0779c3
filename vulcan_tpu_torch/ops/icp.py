"""Frame-to-model projective ICP tracking, flat association.

Counterpart of ``vulcan_tpu/ops/icp.py`` in all four tracking modes:
coarse-to-fine point-to-plane Gauss-Newton with Huber weights ("depth"),
photometric rows on the model intensity ("color"), both summed
("combined"), and both with the model intensity scaled by a spherical-
harmonics gain field refitted every association round ("light",
``ops/light.py``).  Each 6x6 system comes from one fused reduction and is
solved on the device by Cholesky, so a whole track needs no host read.

Update convention: left-multiplicative, ``T <- exp(xi) @ T`` with twist
``xi = (omega, v)``; point-to-plane rows have ``J = [v x n, n]``.

The model maps are bit-packed exactly like the reference's (21-bit
camera-relative fixed-point vertices in two int32s, 10-bit normals + a
valid bit in one), so association reads the same quantized geometry.
The photometric samples ride two packed int32 words, built and decoded
bit for bit as the reference's flat ``color_assoc`` does.  The TPU's
one-hot patch association (``assoc_patch`` "on"/"geom") is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import FrameMaps
from ..core.se3 import SE3
from .dense import COORD_CLAMP, round_to_int
from .preprocess import _shift2d, intensity_from_color
from .raycast import Render

MODES = ("depth", "color", "combined", "light")


@dataclasses.dataclass(frozen=True)
class ModelMaps:
    """Model-side maps for one pyramid level (world space, bit-packed)."""

    vpack1: torch.Tensor      # (H, W) int32: qx<<11 | qy[20:10]
    vpack2: torch.Tensor      # (H, W) int32: qy[9:0]<<22 | qz<<1
    npack: torch.Tensor       # (H, W) int32: valid<<30 | 3x 10-bit normal
    intensity: torch.Tensor | None  # (H, W) model luma, None without photo
    valid: torch.Tensor       # (H, W) bool photometric validity (geometric
                              # association reads the packed bit instead)
    origin: torch.Tensor      # (3,) snapped model camera centre
    camera: PinholeCamera
    world_to_cam: SE3


class Reducer:
    """How a track takes its Gauss-Newton sums: the live rows a process
    sums (``rows``) and how the stacked sums of its rows become the whole
    image's (``__call__``).  This one is a single process holding every
    row, the identity both ways; ``parallel/sharding.py`` gives each rank
    its rows and adds the sums of every rank."""

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def __call__(self, sums: torch.Tensor) -> torch.Tensor:
        return sums


LOCAL = Reducer()


@dataclasses.dataclass(frozen=True)
class TrackResult:
    pose: SE3                    # live camera-to-world
    error: torch.Tensor          # () robust rms point-to-plane error (m)
    inliers: torch.Tensor        # () int32 associated pixels, finest level
    valid: torch.Tensor          # () bool: every level had enough inliers
    level_error: torch.Tensor    # (levels,) robust rms per level
    level_inliers: torch.Tensor  # (levels,) int32 gated pixels per level
    level_degen: torch.Tensor    # (levels,) observability score per level
    min_degen: torch.Tensor      # () gate score: min level_degen
    geo_degen: torch.Tensor      # () geometric-only score (photometric rows
                                 # excluded; 1.0 in mode="color")


_VERTEX_SCALE = 65536.0  # 21-bit fixed-point steps/m: +-16 m at 15 um


def _snap_origin(t: torch.Tensor) -> torch.Tensor:
    """Snap a world point onto the vertex quantization grid."""
    s = _VERTEX_SCALE
    return torch.round(t * s) * (1.0 / s)


def _pack_vertices(vx, vy, vz, origin=None):
    """Planar world-vertex channels -> two int32 images holding three
    21-bit signed fixed-point values, relative to ``origin``."""

    def q(v, o):
        if o is not None:
            v = v - o
        return torch.clamp(
            torch.round(v * _VERTEX_SCALE), -(1 << 20), (1 << 20) - 1
        ).to(torch.int32)

    o = (None, None, None) if origin is None else origin
    qx, qy, qz = q(vx, o[0]), q(vy, o[1]), q(vz, o[2])
    p1 = (qx << 11) | ((qy >> 10) & 0x7FF)
    p2 = ((qy & 0x3FF) << 22) | ((qz & 0x1FFFFF) << 1)
    return p1, p2


def _unpack_vertices(p1, p2, origin=None):
    s = 1.0 / _VERTEX_SCALE
    qx = p1 >> 11                                   # arithmetic: top 21 bits
    qy = ((p1 & 0x7FF) << 10) | ((p2 >> 22) & 0x3FF)
    qy = (qy << 11) >> 11                           # sign-extend 21 bits
    qz = (p2 >> 1) & 0x1FFFFF
    qz = (qz << 11) >> 11
    if origin is None:
        return qx.float() * s, qy.float() * s, qz.float() * s
    return (
        qx.float() * s + origin[0],
        qy.float() * s + origin[1],
        qz.float() * s + origin[2],
    )


def _pack_normals(nx, ny, nz, valid) -> torch.Tensor:
    """Unit-normal channels + valid -> one int32 (10 bits/axis + valid)."""

    def q(n):
        return torch.clamp(torch.round((n + 1.0) * 511.5), 0, 1023).to(torch.int32)

    return (valid.to(torch.int32) << 30) | (q(nx) << 20) | (q(ny) << 10) | q(nz)


def _unpack_normals(p: torch.Tensor):
    def d(v):
        return v.to(torch.float32) * (1.0 / 511.5) - 1.0

    return d((p >> 20) & 0x3FF), d((p >> 10) & 0x3FF), d(p & 0x3FF), (p >> 30) > 0


def _depth_flat_mask(
    depth: torch.Tensor, valid: torch.Tensor, reach: int = 2, thresh: float = 0.05
) -> torch.Tensor:
    """True where no pixel within ``reach`` sits on a depth discontinuity
    (a one-step neighbour jump above ``thresh`` m) or is invalid: the
    per-step jump, not the window's range, so a slanted floor keeps its
    photometric samples.  Bad seeds are dilated by separable max passes."""
    jump = torch.zeros_like(valid)
    for dy, dx in ((0, 1), (1, 0)):
        nb = _shift2d(depth, dy, dx, fill=0.0)
        nb_ok = _shift2d(valid, dy, dx, fill=False)
        j = nb_ok & (torch.abs(depth - nb) > thresh)
        # Mark both sides of the step.
        jump = jump | j | _shift2d(j, -dy, -dx, fill=False)
    bad = ~valid | jump
    for axis in (0, 1):
        grown = bad
        for s in range(1, reach + 1):
            sh = (s, 0) if axis == 0 else (0, s)
            grown = (
                grown
                | _shift2d(bad, sh[0], sh[1], fill=True)
                | _shift2d(bad, -sh[0], -sh[1], fill=True)
            )
        bad = grown
    return valid & ~bad


def model_pyramid(
    render: Render,
    levels: int,
    with_intensity: bool = True,
    flat_thresh: float = 0.05,
) -> tuple[ModelMaps, ...]:
    """Model map pyramid from a render by nearest subsampling.

    ``with_intensity`` adds the model luma and erodes the photometric
    validity at depth jumps (the splat colour near silhouettes is
    untrustworthy); it gates only the photometric samples, so geometric
    inliers are unchanged.  ``with_intensity=False`` (geometric-only
    tracking) skips both."""
    origin = _snap_origin(render.pose.translation)
    vp1, vp2 = _pack_vertices(render.vx, render.vy, render.vz, origin)
    npack = _pack_normals(render.nx, render.ny, render.nz, render.valid)
    c = intensity_from_color(render.color) if with_intensity else None
    ok = render.valid
    if with_intensity:
        ok = ok & _depth_flat_mask(render.depth, render.valid, thresh=flat_thresh)
    cam = render.camera
    w2c = render.pose.inverse()
    maps = []
    for level in range(levels):
        if level > 0:
            vp1, vp2, npack = vp1[::2, ::2], vp2[::2, ::2], npack[::2, ::2]
            ok = ok[::2, ::2]
            c = c[::2, ::2] if c is not None else None
            cam = cam.subsampled(2)
        maps.append(ModelMaps(vp1, vp2, npack, c, ok, origin, cam, w2c))
    return tuple(maps)


def model_from_frame_maps(maps: FrameMaps, pose: SE3) -> ModelMaps:
    """Lift camera-space FrameMaps to world-space ModelMaps (to bootstrap
    tracking before the first render, and in tests)."""
    ok = maps.depth > 0.0
    origin = _snap_origin(pose.translation)
    v = torch.where(ok[..., None], pose.apply(maps.vertices), origin)
    n = torch.where(ok[..., None], pose.rotate(maps.normals), 0.0)
    vp1, vp2 = _pack_vertices(v[..., 0], v[..., 1], v[..., 2], origin)
    return ModelMaps(
        vp1, vp2,
        _pack_normals(n[..., 0], n[..., 1], n[..., 2], ok),
        intensity=maps.intensity,
        valid=ok,
        origin=origin,
        camera=maps.camera,
        world_to_cam=pose.inverse(),
    )


def _bilinear_taps(uv: torch.Tensor, h: int, w: int):
    """The 2x2 bilinear footprint of each point of ``uv`` in an (h, w)
    image: its top-left tap (int64, clamped into the image), the
    fractional offsets (fu, fv) and whether all four taps lie inside."""
    u, v = uv[..., 0], uv[..., 1]
    u0f, v0f = torch.floor(u), torch.floor(v)
    u0 = torch.clamp(u0f, -COORD_CLAMP, COORD_CLAMP).to(torch.int64)
    v0 = torch.clamp(v0f, -COORD_CLAMP, COORD_CLAMP).to(torch.int64)
    inb = (u0 >= 0) & (u0 + 1 < w) & (v0 >= 0) & (v0 + 1 < h)
    uc = torch.clamp(u0, 0, w - 2)
    vc = torch.clamp(v0, 0, h - 2)
    return uc, vc, u - u0f, v - v0f, inb


def _sample_bilinear(img: torch.Tensor, uv: torch.Tensor):
    """Bilinear sample of an (H, W) image; returns (value, in_bounds)."""
    uc, vc, fu, fv, inb = _bilinear_taps(uv, *img.shape)
    val = (
        img[vc, uc] * (1 - fu) * (1 - fv)
        + img[vc, uc + 1] * fu * (1 - fv)
        + img[vc + 1, uc] * (1 - fu) * fv
        + img[vc + 1, uc + 1] * fu * fv
    )
    return val, inb


def _huber_weight(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def associate_depth(live: FrameMaps, model: ModelMaps, pose: SE3, config: Config):
    """Projective association: warp each live pixel into the model frame
    at ``pose`` and sample the model maps (nearest).  Returns fixed
    correspondences (v_m, n_m, ok) for the GN iterations that follow."""
    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)

    h, w = model.npack.shape
    u = round_to_int(uv[..., 0])
    vv = round_to_int(uv[..., 1])
    inb = (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
    uc = torch.clamp(u, 0, w - 1)
    vc = torch.clamp(vv, 0, h - 1)
    mvx, mvy, mvz = _unpack_vertices(
        model.vpack1[vc, uc], model.vpack2[vc, uc], model.origin
    )
    v_m = torch.stack([mvx, mvy, mvz], dim=-1)
    nx, ny, nz, okn = _unpack_normals(model.npack[vc, uc])
    n_m = torch.stack([nx, ny, nz], dim=-1)
    ok = (
        (live.depth > config.depth_min)
        & (live.depth < config.depth_max)
        & inb
        & okn
        & (p_m[..., 2] > 0.0)
    )
    return v_m, n_m, ok


def _pp_normal_eqs(live: FrameMaps, v_m, n_m, assoc_ok, pose: SE3,
                   config: Config, live_normals: bool = False,
                   reduce: Reducer = LOCAL):
    """Point-to-plane 6x6 normal equations from planar rows.  Returns
    (H (6,6), b (6,), err, cnt).  ``live_normals=True`` builds J from the
    LIVE normals over the same gated set (the degeneracy detector)."""
    v_w = pose.apply(live.vertices)
    n_w = pose.rotate(live.normals)
    dx = v_w[..., 0] - v_m[..., 0]
    dy = v_w[..., 1] - v_m[..., 1]
    dz = v_w[..., 2] - v_m[..., 2]
    nx, ny, nz = n_m[..., 0], n_m[..., 1], n_m[..., 2]
    dist2 = dx * dx + dy * dy + dz * dz
    n_dot = n_w[..., 0] * nx + n_w[..., 1] * ny + n_w[..., 2] * nz
    gate = (
        assoc_ok
        & (dist2 < config.icp_dist_thresh**2)
        & (n_dot > config.icp_normal_thresh)
    )
    if live_normals:
        nx, ny, nz = n_w[..., 0], n_w[..., 1], n_w[..., 2]
    r = nx * dx + ny * dy + nz * dz
    w = torch.where(gate, _huber_weight(r, config.icp_huber_delta), 0.0)

    vx, vy, vz = v_w[..., 0], v_w[..., 1], v_w[..., 2]
    j = (
        vy * nz - vz * ny,          # [v x n]
        vz * nx - vx * nz,
        vx * ny - vy * nx,
        nx, ny, nz,                 # [n]
    )
    return _fused_normal_eqs(j, r, w, reduce)


def _sum_positions(n: int = 6):
    """Positions of the n(n+1)/2 upper-triangle entries of an n x n
    normal matrix and the n right-hand-side entries in stacked sums laid
    out row by row (row a's triangle, then its rhs entry): the matrix's
    positions row-major, then the rhs's."""
    pos, k = {}, 0
    for a in range(n):
        for c in range(a, n):
            pos[(a, c)] = k
            k += 1
        k += 1
    hmap = [pos[(min(a, c), max(a, c))] for a in range(n) for c in range(n)]
    return hmap, [pos[(a, n - 1)] + 1 for a in range(n)]


_HMAP, _BMAP = _sum_positions()


def _fused_normal_eqs(j, r, w, reduce: Reducer = LOCAL):
    """(H, b, err, cnt) from planar Jacobian components: all 29 scalars
    from ONE stacked reduction (``reduce`` adds other processes' rows), H
    assembled by a static gather."""
    parts = []
    for a in range(6):
        wj = w * j[a]
        for c in range(a, 6):
            parts.append(wj * j[c])
        parts.append(wj * r)
    parts.append(w * r * r)
    parts.append((w > 0.0).to(torch.float32))
    sums = reduce(torch.sum(torch.stack(parts).reshape(len(parts), -1), dim=1))
    # Assembled from views of the sums: a host-built index tensor would be
    # a host->device copy, which PyTorch follows with a stream sync.
    H = torch.stack([sums[i] for i in _HMAP]).reshape(6, 6)
    b = torch.stack([sums[i] for i in _BMAP])
    return H, b, sums[-2], sums[-1]


def intensity_grads(intensity: torch.Tensor):
    """Central-difference gradient images of the model intensity, once a
    level (pose-independent)."""
    gx = 0.5 * (_shift2d(intensity, 0, 1) - _shift2d(intensity, 0, -1))
    gy = 0.5 * (_shift2d(intensity, 1, 0) - _shift2d(intensity, -1, 0))
    return gx, gy


_PHOTO_SCALE = 65535.0  # 16-bit fixed point of the packed photometric words


def color_assoc(live: FrameMaps, model: ModelMaps, grads, pose: SE3,
                config: Config):
    """The gather half of photometric tracking: sample the model intensity
    and its gradients bilinearly at the current warp, once a round.

    (I, gx, gy, valid) ride two packed int32 words, ``iq<<16 | gxq`` and
    ``gyq<<16 | valid`` at 1/65535, built and decoded as the reference
    does.  Returns fixed samples (i_m0, gu, gv, u0, v0, ok) for
    ``color_rows_fixed``; validity is the tap nearest the warp point."""
    gx_img, gy_img = grads
    s = _PHOTO_SCALE

    def q(x):
        return torch.clamp(torch.round(x * s), 0, 65535).to(torch.int32)

    wa = (q(model.intensity) << 16) | q(gx_img + 0.5)  # may wrap negative
    wb = (q(gy_img + 0.5) << 16) | model.valid.to(torch.int32)

    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)
    uc, vc, fu, fv, inb = _bilinear_taps(uv, *model.intensity.shape)
    a00, a01 = wa[vc, uc], wa[vc, uc + 1]
    a10, a11 = wa[vc + 1, uc], wa[vc + 1, uc + 1]
    b00, b01 = wb[vc, uc], wb[vc, uc + 1]
    b10, b11 = wb[vc + 1, uc], wb[vc + 1, uc + 1]

    w00 = (1.0 - fu) * (1.0 - fv)
    w01 = fu * (1.0 - fv)
    w10 = (1.0 - fu) * fv
    w11 = fu * fv
    inv = 1.0 / s

    def blend(x00, x01, x10, x11, shift, lo):
        def d(x):
            return ((x >> shift) & 0xFFFF).to(torch.float32) * inv + lo

        return w00 * d(x00) + w01 * d(x01) + w10 * d(x10) + w11 * d(x11)

    i_m0 = blend(a00, a01, a10, a11, 16, 0.0)
    gu = blend(a00, a01, a10, a11, 0, -0.5)
    gv = blend(b00, b01, b10, b11, 16, -0.5)
    vb = torch.where(
        fv >= 0.5,
        torch.where(fu >= 0.5, b11, b10),
        torch.where(fu >= 0.5, b01, b00),
    )
    ok = inb & ((vb & 1) > 0) & (p_m[..., 2] > 0.0)
    return i_m0, gu, gv, uv[..., 0], uv[..., 1], ok


def color_rows_fixed(live: FrameMaps, samples, model: ModelMaps, pose: SE3,
                     config: Config):
    """Photometric planar rows from fixed samples: the first-order image
    model ``i_m0 + gu (u - u0) + gv (v - v0)`` around each sample point,
    the projection and its Jacobian re-evaluated at the current pose.  A
    warp that drifted over 4 pixels from its sample is gated out until the
    next round.  Returns (j 6-tuple, r, w), scaled by ``rgb_weight``."""
    i_m0, gu, gv, u0, v0, ok0 = samples
    live_ok = (live.depth > config.depth_min) & (live.depth < config.depth_max)
    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)
    u, v = uv[..., 0], uv[..., 1]

    r = i_m0 + gu * (u - u0) + gv * (v - v0) - live.intensity

    x, y, z = p_m[..., 0], p_m[..., 1], p_m[..., 2]
    zc = torch.clamp(z, min=1e-6)
    fx, fy = model.camera.fx, model.camera.fy
    # dI/dp_m through the pinhole Jacobian, rotated back to world by R_m^T.
    gpx = gu * fx / zc
    gpy = gv * fy / zc
    gpz = -(gu * fx * x + gv * fy * y) / (zc * zc)
    Rm = model.world_to_cam.rotation
    gwx = Rm[0, 0] * gpx + Rm[1, 0] * gpy + Rm[2, 0] * gpz
    gwy = Rm[0, 1] * gpx + Rm[1, 1] * gpy + Rm[2, 1] * gpz
    gwz = Rm[0, 2] * gpx + Rm[1, 2] * gpy + Rm[2, 2] * gpz

    drift2 = (u - u0) ** 2 + (v - v0) ** 2
    gate = live_ok & ok0 & (z > 0.0) & (drift2 < 16.0)
    w = torch.where(gate, _huber_weight(r, config.rgb_huber_delta), 0.0)

    s = config.rgb_weight
    vx, vy, vz = v_w[..., 0], v_w[..., 1], v_w[..., 2]
    j = (
        s * (vy * gwz - vz * gwy),           # [v x g]
        s * (vz * gwx - vx * gwz),
        s * (vx * gwy - vy * gwx),
        s * gwx, s * gwy, s * gwz,           # [g]
    )
    return j, s * r, w


def _min_eig_normalized(H: torch.Tensor) -> torch.Tensor:
    """Observability score: smallest eigenvalue of D^-1/2 H D^-1/2, by
    eight steps of inverse power iteration with a 1e-6 ridge, exactly as
    the reference (``degen_min_eig`` and ``auto_photo_enter`` are
    calibrated on this estimator, not on ``eigvalsh``).  A zero or
    indefinite H fails the Cholesky and scores 0; ``cholesky_ex`` reports
    that through ``info`` without raising or syncing."""
    dev = H.device
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-20))
    Hn = H / (d[:, None] * d[None, :])
    ridge = 1e-6
    L, info = torch.linalg.cholesky_ex(Hn + ridge * torch.eye(6, device=dev))
    x = torch.full((6, 1), 6.0**-0.5, device=dev)
    for _ in range(8):
        y = torch.cholesky_solve(x, L)
        x = y * torch.rsqrt(torch.clamp(torch.sum(y * y), min=1e-38))
    inv_lam = torch.sum(x * torch.cholesky_solve(x, L))
    lam = 1.0 / torch.clamp(inv_lam, min=1e-30) - ridge
    ok = (info == 0) & torch.isfinite(lam)
    return torch.where(ok, torch.clamp(lam, min=0.0), 0.0)


def solve_gn(H: torch.Tensor, b: torch.Tensor, damping: float) -> torch.Tensor:
    """Damped Gauss-Newton step by Cholesky on the device; a failed
    factorization (``info`` != 0) or a non-finite step gives zero."""
    dev = H.device
    d = torch.diagonal(H)
    Hd = (
        H
        + damping * torch.diag(torch.clamp(d, min=1e-12))
        + 1e-12 * torch.eye(6, device=dev)
    )
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
    finite = torch.all(torch.isfinite(delta)) & (info == 0)
    return torch.where(finite, delta, 0.0)


def _level_strides(config: Config) -> tuple[int, ...]:
    strides = config.icp_stride
    if isinstance(strides, int):  # scalar legacy form: finest only
        strides = (strides,) + (1,) * (config.pyramid_levels - 1)
    return tuple(strides)


def _photo_here(mode: str, level: int, config: Config) -> bool:
    """Photometric rows on the ``photo_levels`` coarsest levels (every
    level in mode="color", which has no geometric term)."""
    return mode == "color" or (
        mode != "depth" and (config.pyramid_levels - level) <= config.photo_levels
    )


def track(
    live_pyramid: tuple[FrameMaps, ...],
    model_pyr: tuple[ModelMaps, ...],
    init_pose: SE3,
    config: Config,
    mode: str = "depth",
    reduce: Reducer = LOCAL,
) -> TrackResult:
    """Coarse-to-fine GN over the pyramid, all on the device.

    ``mode``: "depth" (point-to-plane), "color" (photometric), "combined"
    (both normal equations summed) or "light" (combined, with the model
    intensity scaled by an SH gain field refitted every round).  Per level:
    ``icp_assoc[level]`` association rounds, each followed by
    ``ceil(iters / rounds)`` GN steps on the fixed correspondences and
    samples; then the level's observability score from the LIVE normals
    (plus the photometric rows where present) over the last round's
    correspondences.  ``geo_degen`` is the geometric-only score, taken
    before the photometric rows are added.  Per-level inlier floors
    invalidate a track whose coarse level starved.

    ``reduce`` picks the live rows this process sums at every level and
    combines the stacked sums before every solve (``Reducer``); the model
    maps stay whole.
    """
    from . import light as light_ops

    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    dev = init_pose.translation.device
    pose = init_pose
    levels = config.pyramid_levels
    strides = _level_strides(config)
    geometric = mode != "color"
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    err, inl = zero, zero
    lvl_err = [zero] * levels
    lvl_inl = [zero] * levels
    lvl_deg = [one] * levels
    lvl_deg_geo = [one] * levels
    for level in range(levels - 1, -1, -1):
        live = live_pyramid[level]
        model = model_pyr[level]
        iters = config.icp_iters[level]
        st = strides[level]
        live = FrameMaps(
            depth=reduce.rows(live.depth[::st, ::st]),
            vertices=reduce.rows(live.vertices[::st, ::st]),
            normals=reduce.rows(live.normals[::st, ::st]),
            intensity=(
                reduce.rows(live.intensity[::st, ::st])
                if live.intensity is not None else None
            ),
            camera=live.camera,
        )
        photo_here = _photo_here(mode, level, config)
        grads = intensity_grads(model.intensity) if photo_here else None
        rounds = max(1, min(config.icp_assoc[level], iters))
        inner = -(-iters // rounds)  # ceil
        for _round in range(rounds):
            v_m = n_m = ok = samples = None
            if geometric:
                v_m, n_m, ok = associate_depth(live, model, pose, config)
            if photo_here:
                samples = color_assoc(live, model, grads, pose, config)
                if mode == "light":
                    # Refit the gain at every round with the pose frozen,
                    # then hold it across the round's GN steps.
                    coeffs = light_ops.estimate_gain(
                        n_m, samples[0], live.intensity, samples[5] & ok,
                        reduce=reduce,
                    )
                    samples = light_ops.scale_photo_samples(samples, n_m, coeffs)
            for _ in range(inner):
                if geometric:
                    H, b, e, c = _pp_normal_eqs(live, v_m, n_m, ok, pose, config,
                                                reduce=reduce)
                else:
                    H = torch.zeros((6, 6), device=dev)
                    b = torch.zeros(6, device=dev)
                    e = c = zero
                if photo_here:
                    jc, rc, wc = color_rows_fixed(live, samples, model, pose, config)
                    Hc, bc, ec, cc = _fused_normal_eqs(jc, rc, wc, reduce)
                    H, b = H + Hc, b + bc
                    if mode == "color":
                        e, c = ec, cc
                delta = solve_gn(H, b, config.icp_damping)
                delta = torch.where(c >= 6.0, delta, 0.0)
                pose = SE3.exp(delta) @ pose
                err, inl = e / torch.clamp(c, min=1.0), c
        lvl_err[level], lvl_inl[level] = torch.sqrt(err), inl
        if config.degen_min_eig <= 0.0:
            continue
        if geometric:
            H_det, _, _, _ = _pp_normal_eqs(
                live, v_m, n_m, ok, pose, config, live_normals=True, reduce=reduce
            )
        else:
            H_det = torch.zeros((6, 6), device=dev)
        if geometric and photo_here:
            lvl_deg_geo[level] = _min_eig_normalized(H_det)
        if photo_here:
            jc, rc, wc = color_rows_fixed(live, samples, model, pose, config)
            H_det = H_det + _fused_normal_eqs(jc, rc, wc, reduce)[0]
        lvl_deg[level] = _min_eig_normalized(H_det)
        if geometric and not photo_here:
            lvl_deg_geo[level] = lvl_deg[level]

    level_inliers = torch.stack(lvl_inl).to(torch.int32)
    level_degen = torch.stack(lvl_deg)
    # Gate score: the levels that carry every configured term (all in
    # depth/color mode, the photo_levels coarsest in combined/light); with
    # photo_levels=0 the geometric-only scores keep the gate live.
    gate_scores = [
        lvl_deg[level] for level in range(levels)
        if mode in ("depth", "color") or _photo_here(mode, level, config)
    ] or lvl_deg
    floors = []
    for level in range(levels):
        rel = strides[0] ** 2 / (4**level * strides[level] ** 2)
        floors.append(max(6, int(config.icp_min_inliers * rel)))
    levels_ok = torch.all(
        torch.stack([level_inliers[i] >= f for i, f in enumerate(floors)])
    )
    return TrackResult(
        pose=pose,
        error=torch.sqrt(err),
        inliers=inl.to(torch.int32),
        valid=(inl >= float(config.icp_min_inliers)) & levels_ok,
        level_error=torch.stack(lvl_err),
        level_inliers=level_inliers,
        level_degen=level_degen,
        min_degen=torch.min(torch.stack(gate_scores)),
        geo_degen=torch.min(torch.stack(lvl_deg_geo)),
    )
