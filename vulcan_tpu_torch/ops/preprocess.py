"""Depth preprocessing: bilateral filter, vertex/normal lift, pyramids.

Counterpart of ``vulcan_tpu/ops/preprocess.py``.  Invalid depth is 0.0
everywhere; every op preserves that convention.  The reference's
``subsample_stride`` (a TPU lane-layout workaround) is a plain strided
slice here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import Frame, FrameMaps
from . import cuda_kernels


def _shift2d(img: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """Shift an (H, W[, C]) image so out[y, x] = img[y+dy, x+dx]; fill OOB."""
    h, w = img.shape[0], img.shape[1]
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    # F.pad pads the LAST dims first: (C..., W, H) order, channels unpadded.
    pad = (0, 0) * (img.ndim - 2) + pad_x + pad_y
    if img.dtype == torch.bool:
        padded = F.pad(img.to(torch.uint8), pad, value=int(fill)).bool()
    else:
        padded = F.pad(img, pad, value=fill)
    y0 = pad_y[0] + dy
    x0 = pad_x[0] + dx
    return padded[y0:y0 + h, x0:x0 + w]


def _bilateral_math(depth: torch.Tensor, config: Config) -> torch.Tensor:
    """Plain PyTorch version of kernel K1 (shifted adds, dy-outer/dx-inner,
    exactly the reference's ``_bilateral_math``)."""
    r = config.bilateral_radius
    inv_2ss = 1.0 / (2.0 * config.bilateral_sigma_space**2)
    inv_2sd = 1.0 / (2.0 * config.bilateral_sigma_depth**2)
    valid_center = depth > 0.0

    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d = _shift2d(depth, dy, dx)
            w_space = math.exp(-(dy * dy + dx * dx) * inv_2ss)
            diff = d - depth
            w = w_space * torch.exp(-(diff * diff) * inv_2sd)
            w = torch.where(d > 0.0, w, 0.0)
            acc = acc + w * d
            wacc = wacc + w
    out = torch.where(wacc > 0.0, acc / torch.clamp(wacc, min=1e-12), 0.0)
    return torch.where(valid_center, out, 0.0)


def _bilateral_constants(config: Config) -> cuda_kernels.BilateralConstants:
    return cuda_kernels.bilateral_constants(
        config.bilateral_radius, config.bilateral_sigma_space,
        config.bilateral_sigma_depth,
    )


def _bilateral_math_folded(depth: torch.Tensor, config: Config) -> torch.Tensor:
    """Kernel K1's own arithmetic in plain PyTorch, for the tests of its
    error budget (nothing on the main path calls it): the weight of a tap
    is one power of two, ``exp2(diff^2 * neg_a + neg_s[dy, dx])``; an
    invalid or off-image depth is a far negative value, whose weight that
    power drives to 0; the centre weighs exactly 1."""
    k = _bilateral_constants(config)
    r = k.radius
    staged = torch.where(depth > 0.0, depth, cuda_kernels.BILATERAL_INVALID)
    acc = depth.clone()
    wacc = torch.ones_like(depth)
    taps = iter(k.neg_s)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            neg_s = next(taps)
            if dy == 0 and dx == 0:
                continue
            d = _shift2d(staged, dy, dx, fill=cuda_kernels.BILATERAL_INVALID)
            diff = d - depth
            w = torch.exp2(diff * diff * k.neg_a + neg_s)
            acc = acc + w * d
            wacc = wacc + w
    return torch.where(depth > 0.0, acc / wacc, 0.0)


def bilateral_filter(depth: torch.Tensor, config: Config) -> torch.Tensor:
    """Edge-preserving depth denoise (reference component #8).

    A CPU tensor takes the plain version (``_bilateral_math``); a CUDA
    tensor launches kernel K1 (``csrc/bilateral.cu``) with the constants
    cached for this ``Config``; every launch is counted on the card:
    ``cuda_kernels.launch_counts``.  Anything the kernel does not take
    (dtype, ndim, contiguity) raises.
    """
    if depth.is_cpu:
        return _bilateral_math(depth, config)
    return cuda_kernels.bilateral(depth, _bilateral_constants(config))


def compute_vertex_map(depth: torch.Tensor, camera: PinholeCamera) -> torch.Tensor:
    """Back-project depth -> camera-space vertex map (H, W, 3); 0 invalid."""
    h, w = depth.shape
    uv = camera.pixel_grid(h, w, depth.device)
    verts = camera.unproject(uv, depth)
    return torch.where((depth > 0.0)[..., None], verts, 0.0)


def compute_normal_map(vertices: torch.Tensor) -> torch.Tensor:
    """Normals from forward differences of the vertex map, facing the
    camera (n . v < 0); zero where any participating vertex is invalid."""
    v = vertices
    valid = torch.any(v != 0.0, dim=-1)
    vr = _shift2d(v, 0, 1)
    vd = _shift2d(v, 1, 0)
    valid_r = torch.any(vr != 0.0, dim=-1)
    valid_d = torch.any(vd != 0.0, dim=-1)
    n = torch.linalg.cross(vr - v, vd - v, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * v, dim=-1, keepdim=True) > 0.0
    n = torch.where(flip, -n, n)
    ok = valid & valid_r & valid_d & (norm[..., 0] > 1e-12)
    return torch.where(ok[..., None], n, 0.0)


def downsample_depth(depth: torch.Tensor, config: Config) -> torch.Tensor:
    """Half-resolution depth: 2x2 average of valid pixels near the top-left
    reference value (discontinuity-aware subsampling)."""
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    d = d.permute(0, 2, 1, 3).reshape(h // 2, w // 2, 4)
    ref = d[..., 0]
    thresh = 3.0 * config.bilateral_sigma_depth
    ok = (d > 0.0) & (torch.abs(d - ref[..., None]) < thresh)
    s = torch.sum(torch.where(ok, d, 0.0), dim=-1)
    c = torch.sum(ok, dim=-1)
    return torch.where(
        (ref > 0.0) & (c > 0), s / torch.clamp(c, min=1), 0.0
    )


def intensity_from_color(color: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] -> (H, W) luma for photometric tracking."""
    return 0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]


def downsample_intensity(img: torch.Tensor) -> torch.Tensor:
    """Half-resolution plain 2x2 box average (photometric pyramids).  The
    four pixels are summed in the reference's order, row by row."""
    h, w = img.shape
    x = img[: h - h % 2, : w - w % 2]
    return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) / 4.0


def build_frame_maps(
    depth: torch.Tensor,
    intensity,
    camera: PinholeCamera,
    config: Config,
    filter_depth: bool = True,
) -> FrameMaps:
    d = bilateral_filter(depth, config) if filter_depth else depth
    verts = compute_vertex_map(d, camera)
    normals = compute_normal_map(verts)
    return FrameMaps(d, verts, normals, intensity, camera)


def build_pyramid(
    frame: Frame, config: Config, with_intensity: bool = True
) -> tuple[FrameMaps, ...]:
    """Coarse-to-fine pyramid of FrameMaps; index 0 = full resolution.

    The bilateral filter runs once at full resolution; coarser levels
    subsample the filtered depth.  ``with_intensity=False`` (geometric-only
    tracking) skips the luma image and its pyramid.
    """
    depth = (
        bilateral_filter(frame.depth, config)
        if config.bilateral_enabled
        else frame.depth
    )
    intensity = intensity_from_color(frame.color) if with_intensity else None
    camera = frame.camera
    levels = []
    for level in range(config.pyramid_levels):
        if level > 0:
            depth = downsample_depth(depth, config)
            if intensity is not None:
                intensity = downsample_intensity(intensity)
            camera = camera.scaled(0.5)
        levels.append(
            build_frame_maps(depth, intensity, camera, config, filter_depth=False)
        )
    return tuple(levels)
