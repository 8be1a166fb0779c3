"""The fused volume's reference: voxel-block TSDF fusion of the frames the
system was given, at the poses it fused them at, recomputed in plain
PyTorch for a sample of blocks.

The semantics the reference holds the program to (``vulcan_tpu_torch``'s
``pipeline/fusion.py`` step, ``ops/allocate.py``, ``ops/sparse.py``,
``ops/dense.py``; written here again, nothing imported):

* a frame is fused unless its track was distrusted or degenerate (the
  caller says which frames were: ``fused``); a frame that is not fused
  touches nothing;
* the frame's truncation band is made of the blocks that the samples
  ``d + linspace(-mu, mu, alloc_samples)`` along the ray of every
  ``alloc_subsample``-th pixel of the bilateral-filtered depth fall in;
  only the band's blocks are fused;
* a voxel of a band block projects to the nearest pixel (half to even) of
  the raw depth (metres, the sensor's units) and of the colour (rgb565);
  where that depth lies in (depth_min, depth_max), the voxel is in front
  of the camera and ``sdf = depth - z > -mu``, the TSDF takes a running
  average of ``clamp(sdf / mu, -1, 1)`` with weight 1 a frame, capped at
  ``max_weight``; inside ``|sdf| < mu`` so does the colour, stored as
  8-bit channels and an 8-bit weight after every frame.

``dtype`` is the precision the arithmetic runs in: float32 as the
configuration states; bfloat16 makes the control.
"""
from __future__ import annotations

import numpy as np
import torch

COORD_BOUND = 512


def bilateral(depth: torch.Tensor, radius: int, sigma_space: float,
              sigma_depth: float) -> torch.Tensor:
    """Edge-preserving filter of (H, W) depth, 0 = invalid: the weighted
    mean of the valid neighbours within ``radius``, weights
    ``exp(-r^2 / 2 s^2) exp(-dd^2 / 2 sd^2)``; invalid pixels stay 0."""
    h, w = depth.shape
    k = 2 * radius + 1
    taps = torch.nn.functional.unfold(depth[None, None], k, padding=radius)[0]  # (k*k, H*W)
    taps = taps.reshape(k * k, h, w)
    r = torch.arange(-radius, radius + 1, dtype=torch.float64)
    r2 = (r[:, None] ** 2 + r[None, :] ** 2).reshape(-1)
    ws = torch.exp(-r2 / (2.0 * sigma_space**2)).to(depth.dtype).to(depth.device)
    diff = taps - depth
    wt = ws[:, None, None] * torch.exp(-(diff * diff) / (2.0 * sigma_depth**2))
    wt = torch.where(taps > 0.0, wt, 0.0)
    acc = torch.sum(wt * taps, dim=0)
    wacc = torch.sum(wt, dim=0)
    out = torch.where(wacc > 0.0, acc / torch.clamp(wacc, min=1e-12), 0.0)
    return torch.where(depth > 0.0, out, 0.0)


def block_key(coords: torch.Tensor) -> torch.Tensor:
    """One int64 a block coordinate triple (any integer dtype)."""
    c = coords.to(torch.int64) + COORD_BOUND
    return (c[..., 0] * 2 * COORD_BOUND + c[..., 1]) * 2 * COORD_BOUND + c[..., 2]


def band_keys(filtered: torch.Tensor, cam: dict, R: torch.Tensor,
              t: torch.Tensor, s: dict) -> torch.Tensor:
    """Keys of the blocks in the truncation band of the filtered depth
    (H, W) seen from camera-to-world (R, t)."""
    ss = s["alloc_subsample"]
    dt = R.dtype
    d = filtered[::ss, ::ss]
    h, w = filtered.shape
    v = torch.arange(0, h, ss, dtype=dt, device=d.device)
    u = torch.arange(0, w, ss, dtype=dt, device=d.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rays = torch.stack([(uu - cam["cx"]) / cam["fx"], (vv - cam["cy"]) / cam["fy"],
                        torch.ones_like(uu)], dim=-1)
    rays_w = torch.einsum("ij,...j->...i", R, rays)
    mu = s["trunc_dist"]
    k = s["alloc_samples"]
    offs = torch.linspace(-mu, mu, k, dtype=dt, device=d.device)
    ts = d[..., None] + offs
    pts = t + ts[..., None] * rays_w[:, :, None, :]
    coords = torch.floor(pts / (s["block_size"] * s["voxel_size"])).to(torch.int64)
    ok = (((d > s["depth_min"]) & (d < s["depth_max"]))[..., None] & (ts > 0.0)
          & torch.all((coords >= -COORD_BOUND) & (coords < COORD_BOUND), dim=-1))
    return torch.unique(block_key(coords[ok]))


def surface_keys(depth: torch.Tensor, valid: torch.Tensor, config: dict, R: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Keys of the blocks that hold the points of a rendered z-depth map
    (H, W), valid where ``valid``, seen from camera-to-world (R, t)."""
    s, sen = config["settings"], config["sensor"]
    cam = {k: float(np.float32(sen[k])) for k in ("fx", "fy", "cx", "cy")}
    v, u = torch.nonzero(valid, as_tuple=True)
    z = depth[v, u].to(torch.float32)
    pts = torch.stack([(u.float() - cam["cx"]) / cam["fx"] * z,
                       (v.float() - cam["cy"]) / cam["fy"] * z, z], -1)
    world = pts @ R.to(torch.float32).T + t.to(torch.float32)
    coords = torch.floor(world / (s["block_size"] * s["voxel_size"])).to(torch.int64)
    return torch.unique(block_key(coords))


def key_coords(keys: torch.Tensor) -> torch.Tensor:
    """The block coordinates (N, 3) int64 of ``block_key`` values."""
    n = 2 * COORD_BOUND
    return torch.stack([keys // (n * n), (keys // n) % n, keys % n], -1) - COORD_BOUND


def frame_band(frames, i: int, R, t, config: dict, dtype=torch.float32):
    """Frame ``i``'s depth in metres and the keys of its truncation band
    at the camera-to-world pose (R, t), in ``dtype``."""
    s, sen = config["settings"], config["sensor"]
    cam = {k: float(np.float32(sen[k])) for k in ("fx", "fy", "cx", "cy")}
    raw, _ = frames(i)
    depth = raw.to(torch.int32).to(dtype) * (1.0 / float(sen["depth_units_per_m"]))
    filt = depth
    if s["bilateral_enabled"]:
        filt = bilateral(depth, s["bilateral_radius"], s["bilateral_sigma_space"],
                         s["bilateral_sigma_depth"])
    return depth, band_keys(filt, cam, R.to(dtype), t.to(dtype), s)


def local_grid(device) -> torch.Tensor:
    """(512, 3) local voxel coordinates in the flat order (lx*8+ly)*8+lz."""
    r = torch.arange(8, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def fuse_history(frames, rot, trans, fused, blocks: torch.Tensor, config: dict,
                 dtype=torch.float32):
    """The TSDF (K, 512), weight (K, 512), colour (K, 512, 3) 0..255 and
    colour weight (K, 512) of the blocks ``blocks`` (K, 3) after fusing
    frames ``0 .. len(fused) - 1`` at the camera-to-world poses ``rot``
    (n, 3, 3) / ``trans`` (n, 3), where ``fused`` (n,) is True, in
    ``dtype``.  ``frames(i)`` gives frame i's raw depth (H, W) and rgb
    (H, W, 3) as integer tensors on the blocks' device."""
    s = config["settings"]
    sen = config["sensor"]
    f32 = np.float32
    cam = {k: float(f32(sen[k])) for k in ("fx", "fy", "cx", "cy")}
    dev = blocks.device
    vs, mu, wmax = s["voxel_size"], s["trunc_dist"], s["max_weight"]
    keys = block_key(blocks)
    world = ((blocks[:, None, :] * 8 + local_grid(dev)).to(dtype) * vs)  # (K, 512, 3)
    K = blocks.shape[0]
    tsdf = torch.ones((K, 512), dtype=dtype, device=dev)
    weight = torch.zeros((K, 512), dtype=dtype, device=dev)
    col = torch.zeros((K, 512, 3), dtype=torch.int32, device=dev)   # 0..255
    cw = torch.zeros((K, 512), dtype=torch.int32, device=dev)       # 0..255
    h, w = sen["height"], sen["width"]
    for i in np.flatnonzero(np.asarray(fused)):
        R = torch.from_numpy(rot[i]).to(dev, dtype)
        t = torch.from_numpy(trans[i]).to(dev, dtype)
        depth, band = frame_band(frames, int(i), R, t, config, dtype)
        c8 = frames(int(i))[1]
        in_band = torch.isin(keys, band)                                  # (K,)
        Rt = R.transpose(0, 1)
        cam_pts = torch.einsum("ij,...j->...i", Rt, world) - torch.einsum("ij,j->i", Rt, t)
        z = cam_pts[..., 2]
        safe = torch.where(z > 1e-12, z, 1.0)
        u = torch.round(cam["fx"] * cam_pts[..., 0] / safe + cam["cx"]).float()
        v = torch.round(cam["fy"] * cam_pts[..., 1] / safe + cam["cy"]).float()
        inb = (z > 1e-12) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        ui = torch.clamp(u, 0, w - 1).long()
        vi = torch.clamp(v, 0, h - 1).long()
        dd = depth[vi, ui]
        c = c8.to(torch.int32)[vi, ui]       # (K, 512, 3)
        rgb = torch.stack([(c[..., 0] >> 3) * 255 / 31.0, (c[..., 1] >> 2) * 255 / 63.0,
                           (c[..., 2] >> 3) * 255 / 31.0], dim=-1).to(dtype)
        valid = (in_band[:, None] & inb & (dd > s["depth_min"]) & (dd < s["depth_max"])
                 & (z > 0.0))
        sdf = dd - z
        upd = valid & (sdf > -mu)
        obs = torch.clamp(sdf / mu, -1.0, 1.0)
        nw = weight + upd.to(dtype)
        tsdf = torch.where(upd, (weight * tsdf + obs) / torch.clamp(nw, min=1e-12), tsdf)
        weight = torch.clamp(nw, max=wmax)
        cup = upd & (torch.abs(sdf) < mu)
        ncw = cw + cup.to(torch.int32)
        mean = (cw[..., None].to(dtype) * col.to(dtype) + rgb) / torch.clamp(
            ncw, min=1)[..., None].to(dtype)
        col = torch.where(cup[..., None], torch.clamp(torch.round(mean), 0, 255).to(
            torch.int32), col)
        cw = torch.clamp(ncw, max=min(int(wmax), 255))
    return tsdf.float(), weight.float(), col, cw
