"""Frame-to-model projective ICP tracking, depth mode, flat association.

Counterpart of the depth-mode path of ``vulcan_tpu/ops/icp.py``:
coarse-to-fine point-to-plane Gauss-Newton with Huber weights; the 6x6
normal equations come from one fused reduction and are solved on the
device by Cholesky, so a whole track needs no host read.

Update convention: left-multiplicative, ``T <- exp(xi) @ T`` with twist
``xi = (omega, v)``; point-to-plane rows have ``J = [v x n, n]``.

The model maps are bit-packed exactly like the reference's (21-bit
camera-relative fixed-point vertices in two int32s, 10-bit normals + a
valid bit in one), so association reads the same quantized geometry.
The photometric rows, the one-hot patch association and the light model
are still to be ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import FrameMaps
from ..core.se3 import SE3
from .dense import round_to_int
from .raycast import Render


@dataclasses.dataclass(frozen=True)
class ModelMaps:
    """Model-side maps for one pyramid level (world space, bit-packed)."""

    vpack1: torch.Tensor      # (H, W) int32: qx<<11 | qy[20:10]
    vpack2: torch.Tensor      # (H, W) int32: qy[9:0]<<22 | qz<<1
    npack: torch.Tensor       # (H, W) int32: valid<<30 | 3x 10-bit normal
    origin: torch.Tensor      # (3,) snapped model camera centre
    camera: PinholeCamera
    world_to_cam: SE3


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
    geo_degen: torch.Tensor      # () geometric-only score (= min_degen here)


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


def model_pyramid(render: Render, levels: int) -> tuple[ModelMaps, ...]:
    """Model map pyramid from a render by nearest subsampling (the
    reference's ``model_pyramid(with_intensity=False)``)."""
    origin = _snap_origin(render.pose.translation)
    vp1, vp2 = _pack_vertices(render.vx, render.vy, render.vz, origin)
    npack = _pack_normals(render.nx, render.ny, render.nz, render.valid)
    cam = render.camera
    w2c = render.pose.inverse()
    maps = []
    for level in range(levels):
        if level > 0:
            vp1, vp2, npack = vp1[::2, ::2], vp2[::2, ::2], npack[::2, ::2]
            cam = cam.subsampled(2)
        maps.append(ModelMaps(vp1, vp2, npack, origin, cam, w2c))
    return tuple(maps)


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
                   config: Config, live_normals: bool = False):
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
    return _fused_normal_eqs(j, r, w)


def _sum_positions():
    """Positions of the 21 upper-triangle H entries and the 6 b entries in
    the stacked sums (row a's triangle, then its b entry), row-major."""
    pos, k = {}, 0
    for a in range(6):
        for c in range(a, 6):
            pos[(a, c)] = k
            k += 1
        k += 1
    hmap = [pos[(min(a, c), max(a, c))] for a in range(6) for c in range(6)]
    return hmap, [pos[(a, 5)] + 1 for a in range(6)]


_HMAP, _BMAP = _sum_positions()


def _fused_normal_eqs(j, r, w):
    """(H, b, err, cnt) from planar Jacobian components: all 29 scalars
    from ONE stacked reduction, H assembled by a static gather."""
    parts = []
    for a in range(6):
        wj = w * j[a]
        for c in range(a, 6):
            parts.append(wj * j[c])
        parts.append(wj * r)
    parts.append(w * r * r)
    parts.append((w > 0.0).to(torch.float32))
    sums = torch.sum(torch.stack(parts).reshape(len(parts), -1), dim=1)
    # Assembled from views of the sums: a host-built index tensor would be
    # a host->device copy, which PyTorch follows with a stream sync.
    H = torch.stack([sums[i] for i in _HMAP]).reshape(6, 6)
    b = torch.stack([sums[i] for i in _BMAP])
    return H, b, sums[-2], sums[-1]


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


def track(
    live_pyramid: tuple[FrameMaps, ...],
    model_pyr: tuple[ModelMaps, ...],
    init_pose: SE3,
    config: Config,
) -> TrackResult:
    """Coarse-to-fine depth-mode GN over the pyramid, all on the device.

    Per level: ``icp_assoc[level]`` association rounds, each followed by
    ``ceil(iters / rounds)`` GN steps on the fixed correspondences; then
    the level's observability score from the LIVE normals over the last
    round's correspondences.  Per-level inlier floors invalidate a track
    whose coarse level starved.
    """
    dev = init_pose.translation.device
    pose = init_pose
    levels = config.pyramid_levels
    strides = _level_strides(config)
    zero = torch.zeros((), device=dev)
    err, inl = zero, zero
    lvl_err = [zero] * levels
    lvl_inl = [zero] * levels
    lvl_deg = [torch.ones((), device=dev)] * levels
    for level in range(levels - 1, -1, -1):
        live = live_pyramid[level]
        model = model_pyr[level]
        iters = config.icp_iters[level]
        st = strides[level]
        if st > 1:
            live = FrameMaps(
                depth=live.depth[::st, ::st],
                vertices=live.vertices[::st, ::st],
                normals=live.normals[::st, ::st],
                intensity=None,
                camera=live.camera,
            )
        rounds = max(1, min(config.icp_assoc[level], iters))
        inner = -(-iters // rounds)  # ceil
        for _round in range(rounds):
            v_m, n_m, ok = associate_depth(live, model, pose, config)
            for _ in range(inner):
                H, b, e, c = _pp_normal_eqs(live, v_m, n_m, ok, pose, config)
                delta = solve_gn(H, b, config.icp_damping)
                delta = torch.where(c >= 6.0, delta, 0.0)
                pose = SE3.exp(delta) @ pose
                err, inl = e / torch.clamp(c, min=1.0), c
        lvl_err[level], lvl_inl[level] = torch.sqrt(err), inl
        if config.degen_min_eig <= 0.0:
            continue
        H_det, _, _, _ = _pp_normal_eqs(
            live, v_m, n_m, ok, pose, config, live_normals=True
        )
        lvl_deg[level] = _min_eig_normalized(H_det)

    level_inliers = torch.stack(lvl_inl).to(torch.int32)
    level_degen = torch.stack(lvl_deg)
    min_degen = torch.min(level_degen)
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
        min_degen=min_degen,
        geo_degen=min_degen,
    )
