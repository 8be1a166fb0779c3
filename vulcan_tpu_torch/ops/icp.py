"""Frame-to-model projective ICP tracking, flat association.

Counterpart of ``vulcan_tpu/ops/icp.py`` in all four tracking modes:
coarse-to-fine point-to-plane Gauss-Newton with Huber weights ("depth"),
photometric rows on the model intensity ("color"), both summed
("combined"), and both with the model intensity scaled by a spherical-
harmonics gain field refitted every association round ("light",
``ops/light.py``).  The Gauss-Newton loop runs on ``icp_associate`` (H1a,
one launch a round) and ``icp_rows_solve`` (one launch a GN step: H1b's
rows and H1c's solve and pose update), or, where a ``Reducer`` adds other
processes' sums between the two, ``icp_rows`` (H1b) and ``icp_solve``
(H1c): on the card the hand kernels of ``csrc/icp.cu``, on the CPU their
plain versions; the pose stays on the device, so a whole track needs no
host read.

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
from . import cuda_kernels
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


def _bilinear_taps(u: torch.Tensor, v: torch.Tensor, h: int, w: int):
    """The 2x2 bilinear footprint of each point (u, v) in an (h, w)
    image: its top-left tap (int64, clamped into the image), the
    fractional offsets (fu, fv) and whether all four taps lie inside."""
    u0f, v0f = torch.floor(u), torch.floor(v)
    u0 = torch.clamp(u0f, -COORD_CLAMP, COORD_CLAMP).to(torch.int64)
    v0 = torch.clamp(v0f, -COORD_CLAMP, COORD_CLAMP).to(torch.int64)
    inb = (u0 >= 0) & (u0 + 1 < w) & (v0 >= 0) & (v0 + 1 < h)
    uc = torch.clamp(u0, 0, w - 2)
    vc = torch.clamp(v0, 0, h - 2)
    return uc, vc, u - u0f, v - v0f, inb


def _sample_bilinear(img: torch.Tensor, uv: torch.Tensor):
    """Bilinear sample of an (H, W) image; returns (value, in_bounds)."""
    uc, vc, fu, fv, inb = _bilinear_taps(uv[..., 0], uv[..., 1], *img.shape)
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
    correspondences (v_m, n_m, ok) for the GN iterations that follow.
    H1a's plain version (``_associate_plain``) at stride 1."""
    lv = level_inputs(live, model, 1, LOCAL, photo=False)
    corr, _ = _associate_plain(lv, _pose_vector(pose), config, True, False)
    return corr


def _pp_normal_eqs(live: FrameMaps, v_m, n_m, assoc_ok, pose: SE3,
                   config: Config, live_normals: bool = False,
                   reduce: Reducer = LOCAL):
    """Point-to-plane 6x6 normal equations from planar rows.  Returns
    (H (6,6), b (6,), err, cnt).  ``live_normals=True`` builds J from the
    LIVE normals over the same gated set (the degeneracy detector)."""
    p = _pose_vector(pose)
    v_w = _affine(p, *live.vertices.unbind(-1))
    j, r, w = _geo_rows(p, v_w, live.normals, (v_m, n_m, assoc_ok), config, live_normals)
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


def _stacked_sums(j, r, w, magnitudes: bool = False) -> torch.Tensor:
    """The 29 stacked sums of planar rows (``_sum_positions``' layout: row
    a's triangle ``w j_a j_c``, then ``w j_a r``; then ``w r r`` and the
    count of weighted rows), one reduction over the pixels.  ``magnitudes``
    sums the products' absolute values instead: the scale of the sums'
    rounding error, which a check of another summation order divides by."""
    if magnitudes:
        j, r = tuple(torch.abs(x) for x in j), torch.abs(r)
    parts = []
    for a in range(6):
        wj = w * j[a]
        for c in range(a, 6):
            parts.append(wj * j[c])
        parts.append(wj * r)
    parts.append(w * r * r)
    parts.append((w > 0.0).to(torch.float32))
    return torch.sum(torch.stack(parts).reshape(len(parts), -1), dim=1)


def _assemble(sums: torch.Tensor):
    """(H (6, 6), b (6,)) from 29 stacked sums.  Assembled from views of
    the sums: a host-built index tensor would be a host->device copy, which
    PyTorch follows with a stream sync."""
    H = torch.stack([sums[i] for i in _HMAP]).reshape(6, 6)
    b = torch.stack([sums[i] for i in _BMAP])
    return H, b


def _fused_normal_eqs(j, r, w, reduce: Reducer = LOCAL):
    """(H, b, err, cnt) from planar Jacobian components: all 29 scalars
    from ONE stacked reduction (``reduce`` adds other processes' rows), H
    assembled by a static gather."""
    sums = reduce(_stacked_sums(j, r, w))
    H, b = _assemble(sums)
    return H, b, sums[-2], sums[-1]


def intensity_grads(intensity: torch.Tensor):
    """Central-difference gradient images of the model intensity, once a
    level (pose-independent)."""
    gx = 0.5 * (_shift2d(intensity, 0, 1) - _shift2d(intensity, 0, -1))
    gy = 0.5 * (_shift2d(intensity, 1, 0) - _shift2d(intensity, -1, 0))
    return gx, gy


_PHOTO_SCALE = 65535.0  # 16-bit fixed point of the packed photometric words


def _photo_words(intensity: torch.Tensor, valid: torch.Tensor, grads):
    """The two packed photometric words of a level, ``iq<<16 | gxq`` and
    ``gyq<<16 | valid`` at 1/65535 (pose-independent: once a level)."""
    gx_img, gy_img = grads

    def q(x):
        return torch.clamp(torch.round(x * _PHOTO_SCALE), 0, 65535).to(torch.int32)

    wa = (q(intensity) << 16) | q(gx_img + 0.5)  # may wrap negative
    wb = (q(gy_img + 0.5) << 16) | valid.to(torch.int32)
    return wa.contiguous(), wb.contiguous()


def _photo_samples(wa, wb, u, v, z):
    """The flat bilinear decode of the two packed words at the warp points
    (u, v) of camera depth z: (i_m0, gu, gv, u0, v0, ok), validity from the
    tap nearest the warp point."""
    uc, vc, fu, fv, inb = _bilinear_taps(u, v, *wa.shape)
    a00, a01 = wa[vc, uc], wa[vc, uc + 1]
    a10, a11 = wa[vc + 1, uc], wa[vc + 1, uc + 1]
    b00, b01 = wb[vc, uc], wb[vc, uc + 1]
    b10, b11 = wb[vc + 1, uc], wb[vc + 1, uc + 1]

    w00 = (1.0 - fu) * (1.0 - fv)
    w01 = fu * (1.0 - fv)
    w10 = (1.0 - fu) * fv
    w11 = fu * fv
    inv = 1.0 / _PHOTO_SCALE

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
    ok = inb & ((vb & 1) > 0) & (z > 0.0)
    return i_m0, gu, gv, u, v, ok


def color_assoc(live: FrameMaps, model: ModelMaps, grads, pose: SE3,
                config: Config):
    """The gather half of photometric tracking: sample the model intensity
    and its gradients bilinearly at the current warp, once a round.

    (I, gx, gy, valid) ride two packed int32 words, ``iq<<16 | gxq`` and
    ``gyq<<16 | valid`` at 1/65535, built and decoded as the reference
    does.  Returns fixed samples (i_m0, gu, gv, u0, v0, ok) for
    ``color_rows_fixed``; validity is the tap nearest the warp point.
    The decode is H1a's (``_photo_samples``); the warp is ``SE3.apply``'s,
    whose rounding stays within an ulp of the reference's fused one (the
    kernels' unfused warp, ``_affine``, parts from it by a few ulps)."""
    wa, wb = _photo_words(model.intensity, model.valid, grads)
    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)
    return _photo_samples(wa, wb, uv[..., 0], uv[..., 1], p_m[..., 2])


def color_rows_fixed(live: FrameMaps, samples, model: ModelMaps, pose: SE3,
                     config: Config):
    """Photometric planar rows from fixed samples: the first-order image
    model ``i_m0 + gu (u - u0) + gv (v - v0)`` around each sample point,
    the projection and its Jacobian re-evaluated at the current pose.  A
    warp that drifted over 4 pixels from its sample is gated out until the
    next round.  Returns (j 6-tuple, r, w), scaled by ``rgb_weight``."""
    v_w = _affine(_pose_vector(pose), *live.vertices.unbind(-1))
    return _photo_rows(v_w, live.depth, live.intensity, _model_vector(model),
                       model.camera, samples, config)


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


# --- the Gauss-Newton loop's entry points (H1a-H1c, the fused step) ------
#
# ``track`` runs every association round through ``icp_associate`` (H1a)
# and every GN step (and level score) through ``icp_rows_solve`` (H1b and
# H1c in one launch) where its reducer is ``LOCAL``, or through ``icp_rows``
# (H1b), the reducer, then ``icp_solve`` (H1c) with any other reducer, on
# either device: a CPU tensor takes the plain PyTorch version beside each,
# a CUDA tensor launches the kernel of ``csrc/icp.cu`` (every launch is
# counted on the card: ``cuda_kernels.launch_counts``) or raises.  The pose
# travels as a (16,) vector, ``[R row-major (9), t (3), err, inliers, level
# score, geometric score]``, that H1c (or the fused step) writes and H1a/H1b
# read on the device.
# The plain versions write each per-pixel operation out element by element
# in the order the kernels repeat it, one rounding each, so that the card
# checks kernel against plain version bit for bit up to the sums' order.


@dataclasses.dataclass(frozen=True)
class LevelInputs:
    """What the three entry points read at one pyramid level, built once a
    level: this process's live rows at the level's stride and the model
    maps, all contiguous, the photometric words where the level has the
    photometric term, and the model side as one (15,) vector."""

    depth: torch.Tensor               # (h, w) live
    vertices: torch.Tensor            # (h, w, 3) live, camera space
    normals: torch.Tensor             # (h, w, 3)
    intensity: torch.Tensor | None    # (h, w), with the photometric term
    vpack1: torch.Tensor              # (hm, wm) int32 model maps
    vpack2: torch.Tensor
    npack: torch.Tensor
    words: tuple[torch.Tensor, torch.Tensor] | None  # (hm, wm) int32 x2
    model: torch.Tensor               # (15,) world-to-camera R, t; origin
    camera: PinholeCamera             # the model camera


def _model_vector(model: ModelMaps) -> torch.Tensor:
    """(15,) model side: world-to-camera R row-major and t, then the origin
    of the packed vertices."""
    w2c = model.world_to_cam
    return torch.cat([w2c.rotation.reshape(9), w2c.translation, model.origin])


def level_inputs(live: FrameMaps, model: ModelMaps, stride: int,
                 reduce: Reducer, photo: bool) -> LevelInputs:
    """A level's inputs.  The model vector is made last: the level's first
    ``icp_associate`` reads the live maps before the kernel just ahead of
    it has finished (``cuda_kernels.icp_associate``), so that kernel must
    not be one that writes them."""
    def rows(x):
        return reduce.rows(x[::stride, ::stride]).contiguous()

    return LevelInputs(
        depth=rows(live.depth),
        vertices=rows(live.vertices),
        normals=rows(live.normals),
        intensity=rows(live.intensity) if photo else None,
        vpack1=model.vpack1.contiguous(),
        vpack2=model.vpack2.contiguous(),
        npack=model.npack.contiguous(),
        words=(_photo_words(model.intensity, model.valid,
                            intensity_grads(model.intensity)) if photo else None),
        model=_model_vector(model),
        camera=model.camera,
    )


def _pose_vector(pose: SE3) -> torch.Tensor:
    """(16,) pose vector of ``pose``: R, t, then err, inliers and the two
    scores at 0."""
    t = pose.translation
    return torch.cat([pose.rotation.reshape(9), t, t.new_zeros(4)])


def _pose_of(vec: torch.Tensor) -> SE3:
    return SE3(vec[:9].reshape(3, 3), vec[9:12])


def _affine(p: torch.Tensor, x, y, z, translate: bool = True):
    """The 3x4 transform at ``p[:12]`` (rotation row-major, translation)
    on planar channels, each row's products summed left to right."""
    out = []
    for k in range(3):
        row = p[3 * k] * x + p[3 * k + 1] * y + p[3 * k + 2] * z
        out.append(row + p[9 + k] if translate else row)
    return out


def _project(cam: PinholeCamera, x, y, z):
    """``PinholeCamera.project`` on planar channels (contiguous u, v, as
    the kernels write them)."""
    bad = z <= 1e-12
    sz = torch.where(bad, 1.0, z)
    u = torch.where(bad, -1e9, cam.fx * x / sz + cam.cx)
    v = torch.where(bad, -1e9, cam.fy * y / sz + cam.cy)
    return u, v


def _associate_plain(lv: LevelInputs, pose: torch.Tensor, config: Config,
                     geometric: bool, photo: bool):
    """H1a's plain version: ``associate_depth``'s correspondences (v_m,
    n_m, ok) and ``color_assoc``'s samples (i_m0, gu, gv, u0, v0, ok), each
    None without its term."""
    wx, wy, wz = _affine(pose, *lv.vertices.unbind(-1))
    mx, my, mz = _affine(lv.model, wx, wy, wz)
    u, v = _project(lv.camera, mx, my, mz)
    corr = samples = None
    if geometric:
        hm, wm = lv.npack.shape
        ui, vi = round_to_int(u), round_to_int(v)
        inb = (ui >= 0) & (ui < wm) & (vi >= 0) & (vi < hm)
        idx = torch.clamp(vi, 0, hm - 1) * wm + torch.clamp(ui, 0, wm - 1)
        v_m = torch.stack(_unpack_vertices(
            lv.vpack1.reshape(-1)[idx], lv.vpack2.reshape(-1)[idx], lv.model[12:15]), dim=-1)
        nx, ny, nz, okn = _unpack_normals(lv.npack.reshape(-1)[idx])
        ok = (
            (lv.depth > config.depth_min)
            & (lv.depth < config.depth_max)
            & inb
            & okn
            & (mz > 0.0)
        )
        corr = (v_m, torch.stack([nx, ny, nz], dim=-1), ok)
    if photo:
        samples = _photo_samples(*lv.words, u, v, mz)
    return corr, samples


def _camera4(cam: PinholeCamera) -> tuple[float, float, float, float]:
    return cam.fx, cam.fy, cam.cx, cam.cy


def icp_associate(lv: LevelInputs, pose: torch.Tensor, config: Config,
                  geometric: bool, photo: bool):
    """H1a, one association round: ``(corr, samples)`` as
    ``_associate_plain`` returns them; kernel ``icp_associate`` of
    ``csrc/icp.cu`` on a CUDA tensor."""
    if lv.depth.is_cpu:
        return _associate_plain(lv, pose, config, geometric, photo)
    return cuda_kernels.icp_associate(
        lv.depth, lv.vertices, pose, lv.model, (lv.vpack1, lv.vpack2, lv.npack),
        lv.words, _camera4(lv.camera), config.depth_min, config.depth_max,
        geometric, photo)


def _geo_rows(pose: torch.Tensor, v_w, normals: torch.Tensor, corr, config: Config,
              live_normals: bool = False):
    """Point-to-plane planar rows (j 6-tuple, r, w) at the world points
    ``v_w`` (planar channels) of live pixels with camera-space ``normals``,
    on fixed correspondences ``corr``; ``live_normals``: J and r from the
    live normals (the degeneracy detector)."""
    vx, vy, vz = v_w
    v_m, n_m, ok = corr
    nwx, nwy, nwz = _affine(pose, *normals.unbind(-1), translate=False)
    mx, my, mz = v_m.unbind(-1)
    dx, dy, dz = vx - mx, vy - my, vz - mz
    nx, ny, nz = n_m.unbind(-1)
    dist2 = dx * dx + dy * dy + dz * dz
    n_dot = nwx * nx + nwy * ny + nwz * nz
    gate = (
        ok
        & (dist2 < config.icp_dist_thresh**2)
        & (n_dot > config.icp_normal_thresh)
    )
    if live_normals:
        nx, ny, nz = nwx, nwy, nwz
    r = nx * dx + ny * dy + nz * dz
    w = torch.where(gate, _huber_weight(r, config.icp_huber_delta), 0.0)
    j = (vy * nz - vz * ny, vz * nx - vx * nz, vx * ny - vy * nx, nx, ny, nz)
    return j, r, w


def _photo_rows(v_w, depth: torch.Tensor, intensity: torch.Tensor,
                model: torch.Tensor, cam: PinholeCamera, samples, config: Config):
    """Photometric planar rows (j 6-tuple, r, w), scaled by ``rgb_weight``,
    at the world points ``v_w`` of live pixels with ``depth`` and
    ``intensity``, from fixed ``samples``; ``model`` is the (15,) model
    side (``_model_vector``), ``cam`` the model camera."""
    vx, vy, vz = v_w
    i_m0, gu, gv, u0, v0, ok0 = samples
    px, py, pz = _affine(model, vx, vy, vz)
    u, v = _project(cam, px, py, pz)
    du, dv = u - u0, v - v0
    r = i_m0 + gu * du + gv * dv - intensity
    zc = torch.clamp(pz, min=1e-6)
    # dI/dp_m through the pinhole Jacobian, rotated back to world by R_m^T.
    gufx, gvfy = gu * cam.fx, gv * cam.fy
    gpx, gpy = gufx / zc, gvfy / zc
    gpz = -(gufx * px + gvfy * py) / (zc * zc)
    m = model
    gwx = m[0] * gpx + m[3] * gpy + m[6] * gpz
    gwy = m[1] * gpx + m[4] * gpy + m[7] * gpz
    gwz = m[2] * gpx + m[5] * gpy + m[8] * gpz
    drift2 = du * du + dv * dv
    gate = (
        (depth > config.depth_min)
        & (depth < config.depth_max)
        & ok0
        & (pz > 0.0)
        & (drift2 < 16.0)
    )
    w = torch.where(gate, _huber_weight(r, config.rgb_huber_delta), 0.0)
    s = config.rgb_weight
    j = (s * (vy * gwz - vz * gwy), s * (vz * gwx - vx * gwz),
         s * (vx * gwy - vy * gwx), s * gwx, s * gwy, s * gwz)
    return j, s * r, w


def _rows_plain(lv: LevelInputs, pose: torch.Tensor, corr, samples,
                config: Config, geometric: bool, photo: bool,
                live_normals: bool = False, magnitudes: bool = False) -> torch.Tensor:
    """H1b's plain version: the (2, 29) stacked sums of ``_pp_normal_eqs``'
    rows (``live_normals``: the detector's) and of ``color_rows_fixed``'s,
    zeros for an absent term; ``magnitudes``: the sums of the products'
    absolute values (``_stacked_sums``)."""
    v_w = _affine(pose, *lv.vertices.unbind(-1))
    geo = pho = lv.depth.new_zeros(29)
    if geometric:
        geo = _stacked_sums(*_geo_rows(pose, v_w, lv.normals, corr, config, live_normals),
                            magnitudes)
    if photo:
        pho = _stacked_sums(*_photo_rows(v_w, lv.depth, lv.intensity, lv.model, lv.camera,
                                         samples, config), magnitudes)
    return torch.stack([geo, pho])


def _rows_scalars(config: Config) -> tuple[float, ...]:
    """The rows kernels' per-level scalars (``cuda_kernels.icp_rows``)."""
    return (config.depth_min, config.depth_max, config.icp_dist_thresh**2,
            config.icp_normal_thresh, config.icp_huber_delta,
            config.rgb_huber_delta, config.rgb_weight)


def icp_rows(lv: LevelInputs, pose: torch.Tensor, corr, samples, config: Config,
             geometric: bool, photo: bool, live_normals: bool = False) -> torch.Tensor:
    """H1b, one GN step's rows (or the detector's, ``live_normals``): the
    (2, 29) stacked sums of this process's rows, geometric then
    photometric; kernel ``icp_rows`` of ``csrc/icp.cu`` on a CUDA tensor."""
    if lv.depth.is_cpu:
        return _rows_plain(lv, pose, corr, samples, config, geometric, photo,
                           live_normals)
    return cuda_kernels.icp_rows(
        lv.depth, lv.vertices, lv.normals, lv.intensity, pose, lv.model, corr,
        samples, _camera4(lv.camera), _rows_scalars(config), geometric, photo,
        live_normals)


def _solve_plain(sums: torch.Tensor, pose: torch.Tensor, damping: float,
                 geometric: bool, photo: bool, detect: bool = False) -> torch.Tensor:
    """H1c's plain version on the (2, 29) sums after ``reduce``: the next
    pose vector, ``SE3.exp(solve_gn(Hg + Hc, bg + bc)) @ pose`` with a
    zero step under 6 inliers, err = e / max(c, 1) and inliers = c from
    the geometric term when there is one; with ``detect`` the pose vector
    with the level's score (the summed matrix) and geometric score (1
    without a geometric term) in its last two entries."""
    Hg, bg = _assemble(sums[0])
    Hc, bc = _assemble(sums[1])
    H = Hg + Hc
    if detect:
        deg = _min_eig_normalized(H)
        deg_geo = (
            (_min_eig_normalized(Hg) if photo else deg) if geometric
            else torch.ones_like(deg)
        )
        return torch.cat([pose[:14], deg.reshape(1), deg_geo.reshape(1)])
    e, c = sums[0 if geometric else 1, 27:29]
    delta = solve_gn(H, bg + bc, damping)
    delta = torch.where(c >= 6.0, delta, 0.0)
    new = SE3.exp(delta) @ _pose_of(pose)
    return torch.cat([new.rotation.reshape(9), new.translation,
                      (e / torch.clamp(c, min=1.0)).reshape(1), c.reshape(1), pose[14:]])


def icp_solve(sums: torch.Tensor, pose: torch.Tensor, config: Config,
              geometric: bool, photo: bool, detect: bool = False) -> torch.Tensor:
    """H1c, one GN step's solve and pose update (or the level's scores,
    ``detect``) in one thread block: kernel ``icp_solve`` of
    ``csrc/icp.cu`` on a CUDA tensor."""
    if sums.is_cpu:
        return _solve_plain(sums, pose, config.icp_damping, geometric, photo, detect)
    return cuda_kernels.icp_solve(sums, pose, config.icp_damping, geometric, photo,
                                  detect)


def icp_rows_solve(lv: LevelInputs, pose: torch.Tensor, corr, samples, config: Config,
                   geometric: bool, photo: bool, detect: bool = False):
    """H1b and H1c in one launch, for a track whose reducer is ``LOCAL``:
    ``(sums, pose)``, the (2, 29) sums of ``icp_rows`` (with ``detect`` the
    detector's rows, from the live normals) and ``icp_solve``'s next pose
    vector from them; kernel ``icp_rows_solve`` of ``csrc/icp.cu`` on a
    CUDA tensor, ``_solve_plain(_rows_plain(...))`` on a CPU one."""
    if lv.depth.is_cpu:
        sums = _rows_plain(lv, pose, corr, samples, config, geometric, photo, detect)
        return sums, _solve_plain(sums, pose, config.icp_damping, geometric, photo, detect)
    return cuda_kernels.icp_rows_solve(
        lv.depth, lv.vertices, lv.normals, lv.intensity, pose, lv.model, corr, samples,
        _camera4(lv.camera), _rows_scalars(config), config.icp_damping, geometric,
        photo, detect)


def _gn_step(lv: LevelInputs, pose: torch.Tensor, corr, samples, config: Config,
             geometric: bool, photo: bool, reduce: Reducer, detect: bool = False):
    """One GN step's next pose vector (``detect``: the level's scores).
    A local reducer takes the fused launch; another one adds its
    processes' sums between the rows and the solve."""
    if reduce is LOCAL:
        return icp_rows_solve(lv, pose, corr, samples, config, geometric, photo, detect)[1]
    sums = reduce(icp_rows(lv, pose, corr, samples, config, geometric, photo,
                           live_normals=detect))
    return icp_solve(sums, pose, config, geometric, photo, detect)


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
    ``icp_assoc[level]`` association rounds (``icp_associate``), each
    followed by ``ceil(iters / rounds)`` GN steps on the fixed
    correspondences and samples (``_gn_step``); then
    the level's observability score from the LIVE normals (plus the
    photometric rows where present) over the last round's correspondences.
    ``geo_degen`` is the geometric-only score, taken before the
    photometric rows are added.  Per-level inlier floors invalidate a
    track whose coarse level starved.

    ``reduce`` picks the live rows this process sums at every level and
    combines the stacked sums before every solve (``Reducer``); the model
    maps stay whole.  ``LOCAL`` has nothing to combine, so each step is one
    ``icp_rows_solve``; any other reducer runs ``icp_rows``, ``reduce``,
    ``icp_solve``.
    """
    from . import light as light_ops

    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    levels = config.pyramid_levels
    strides = _level_strides(config)
    geometric = mode != "color"
    state = _pose_vector(init_pose)
    one = torch.ones((), device=state.device)
    lvl_err, lvl_inl = [one] * levels, [one] * levels
    lvl_deg, lvl_deg_geo = [one] * levels, [one] * levels
    for level in range(levels - 1, -1, -1):
        photo_here = _photo_here(mode, level, config)
        lv = level_inputs(live_pyramid[level], model_pyr[level], strides[level],
                          reduce, photo_here)
        iters = config.icp_iters[level]
        rounds = max(1, min(config.icp_assoc[level], iters))
        inner = -(-iters // rounds)  # ceil
        for _round in range(rounds):
            corr, samples = icp_associate(lv, state, config, geometric, photo_here)
            if photo_here and mode == "light":
                # Refit the gain at every round with the pose frozen,
                # then hold it across the round's GN steps.
                _, n_m, ok = corr
                coeffs = light_ops.estimate_gain(
                    n_m, samples[0], lv.intensity, samples[5] & ok, reduce=reduce
                )
                samples = light_ops.scale_photo_samples(samples, n_m, coeffs)
            for _ in range(inner):
                state = _gn_step(lv, state, corr, samples, config, geometric, photo_here,
                                 reduce)
        lvl_err[level], lvl_inl[level] = torch.sqrt(state[12]), state[13]
        if config.degen_min_eig <= 0.0:
            continue
        state = _gn_step(lv, state, corr, samples, config, geometric, photo_here, reduce,
                         detect=True)
        lvl_deg[level], lvl_deg_geo[level] = state[14], state[15]

    err, inl = state[12], state[13]
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
        pose=_pose_of(state),
        error=torch.sqrt(err),
        inliers=inl.to(torch.int32),
        valid=(inl >= float(config.icp_min_inliers)) & levels_ok,
        level_error=torch.stack(lvl_err),
        level_inliers=level_inliers,
        level_degen=level_degen,
        min_degen=torch.min(torch.stack(gate_scores)),
        geo_degen=torch.min(torch.stack(lvl_deg_geo)),
    )
