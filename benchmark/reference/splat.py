"""The surfel splat's reference: the model maps a volume renders to, from
its TSDF, weights and colours, in plain PyTorch.

The semantics (``vulcan_tpu_torch/ops/splat.py`` ``render_splat`` on its
default path: surfels, luma colour, cross-product normals, no polish;
``ops/allocate.py`` ``update_visibility``; ``ops/blocks.py``
``pack_surfels``), written here again:

* a block is visible when its centre, in front of the camera by at least
  ``ray_near`` less the block's radius, projects inside the image grown
  by the block's projected radius; the first ``max_visible`` by index;
* a voxel of a visible block is a surfel when observed and
  ``|tsdf| < band``; a block keeps ``surfel_slots`` of them, the inner
  half band first, each in flat index order; its outward orientation is
  the sign pattern of the block's TSDF central differences, quantised;
* a surfel lies at ``z_voxel + tsdf * mu`` on its voxel's pixel (rounded
  half to even); surfels facing away from the camera are culled; the
  nearest depth bin (``ray_far / (2^19 - 1)``) wins each pixel, ties to
  the darker 12-bit luma of the voxel's colour;
* two rounds of hole fill where the 3x3 neighbourhood agrees within
  ``2 mu``, then the mean of the neighbours within ``mu / 2``;
* cross-product normals of the vertex map, turned to face the camera and
  averaged over 3x3; the luma diffused into the filled pixels.

The program's surfel lists are a cache of the TSDF; the reference works
them out again from the TSDF.  ``dtype`` is the precision of the
geometry: float32 as the configuration states; bfloat16 makes the
control.
"""
from __future__ import annotations

import numpy as np
import torch

ZQ_MAX = (1 << 19) - 1
LUMA_EMPTY = 0x7FFFFFFF
CHUNK = 2048


def shift2d(img, dy: int, dx: int, fill=0.0):
    """out[y, x] = img[y + dy, x + dx], ``fill`` outside."""
    h, w = img.shape[0], img.shape[1]
    out = torch.full_like(img, fill)
    ys, yd = (slice(dy, h), slice(0, h - dy)) if dy >= 0 else (slice(0, h + dy), slice(-dy, h))
    xs, xd = (slice(dx, w), slice(0, w - dx)) if dx >= 0 else (slice(0, w + dx), slice(-dx, w))
    out[yd, xd] = img[ys, xs]
    return out


def camera(sensor: dict) -> dict:
    f32 = np.float32
    return {k: float(f32(sensor[k])) for k in ("fx", "fy", "cx", "cy")}


def visible_blocks(coords, free_count: int, R, t, s: dict, sensor: dict):
    """Indices (ascending) of the allocated blocks (1 .. free_count - 1)
    whose bounds are in view."""
    cam = camera(sensor)
    be = s["block_size"] * s["voxel_size"]
    ids = torch.arange(1, free_count, device=coords.device)
    centers = (coords[ids].to(R.dtype) + 0.5) * be
    Rt = R.transpose(0, 1)
    p = torch.einsum("ij,...j->...i", Rt, centers) - torch.einsum("ij,j->i", Rt, t)
    z = p[:, 2]
    radius = 0.87 * be
    r_px = float(np.float32(max(cam["fx"], cam["fy"])) * np.float32(radius)) / torch.clamp(
        z, min=1e-3)
    safe = torch.where(z > 1e-12, z, 1.0)
    u = torch.where(z > 1e-12, cam["fx"] * p[:, 0] / safe + cam["cx"], -1e9)
    v = torch.where(z > 1e-12, cam["fy"] * p[:, 1] / safe + cam["cy"], -1e9)
    w, h = sensor["width"], sensor["height"]
    vis = ((z > s["ray_near"] - radius) & (z < s["ray_far"] + radius)
           & (u > -r_px) & (u < w - 1 + r_px) & (v > -r_px) & (v < h - 1 + r_px))
    return ids[vis][: s["max_visible"]]


def orientation(tsdf):
    """Quantised outward orientation (C, 512) x3 in {-1, 0, 1}: central
    differences inside the block, one-sided at its faces; components under
    a quarter of the largest are 0."""
    t3 = tsdf.reshape(-1, 8, 8, 8)

    def grad(axis):
        lo = torch.cat([t3.narrow(axis, 0, 1), t3.narrow(axis, 0, 7)], dim=axis)
        hi = torch.cat([t3.narrow(axis, 1, 7), t3.narrow(axis, 7, 1)], dim=axis)
        return (hi - lo).reshape(tsdf.shape)

    g = [grad(1), grad(2), grad(3)]
    m = 0.25 * torch.maximum(torch.abs(g[0]), torch.maximum(torch.abs(g[1]), torch.abs(g[2])))
    return [torch.where(x > m, 1.0, torch.where(x < -m, -1.0, 0.0)) for x in g]


def zbuffer(tsdf, weight, colorpack, coords, ids, R, t, s: dict, sensor: dict, dtype):
    """The packed (depth bin << 12 | luma) z-buffer (H*W,) int32 of the
    surfels of blocks ``ids``."""
    cam = camera(sensor)
    h, w = sensor["height"], sensor["width"]
    dev = tsdf.device
    vs, mu = s["voxel_size"], s["trunc_dist"]
    band = min(1.0, max(s["splat_band"], 1.5 * vs / mu))
    slots = s["surfel_slots"]
    Rt = R.transpose(0, 1)
    tr = -torch.einsum("ij,j->i", Rt, t)
    lidx = torch.arange(512, device=dev)
    l3 = torch.stack([lidx // 64, (lidx // 8) % 8, lidx % 8], dim=-1).to(dtype)
    buf = torch.full((h * w + 1,), LUMA_EMPTY, dtype=torch.int32, device=dev)
    for s0 in range(0, ids.shape[0], CHUNK):
        b = ids[s0:s0 + CHUNK]
        ts, wt, cp = tsdf[b], weight[b], colorpack[b]
        a = torch.abs(ts)
        live = (a < band) & (wt > 0.0)
        inner = live & (a < 0.5 * band)
        outer = live & ~inner
        pos = torch.where(inner, torch.cumsum(inner, 1) - 1,
                          inner.sum(1, keepdim=True) + torch.cumsum(outer, 1) - 1)
        keep = live & (pos < slots)
        mag = torch.clamp(torch.round(a * 16383.0), 0, 16383)
        tq = torch.where(ts < 0.0, -1.0, 1.0) * mag * (1.0 / 16383.0)
        g = orientation(ts)
        world = (coords[b][:, None, :].to(dtype) * 8 + l3) * vs          # (C, 512, 3)
        cx = Rt[0, 0] * world[..., 0] + Rt[0, 1] * world[..., 1] + Rt[0, 2] * world[..., 2] + tr[0]
        cy = Rt[1, 0] * world[..., 0] + Rt[1, 1] * world[..., 1] + Rt[1, 2] * world[..., 2] + tr[1]
        cz = Rt[2, 0] * world[..., 0] + Rt[2, 1] * world[..., 1] + Rt[2, 2] * world[..., 2] + tr[2]
        z = cz + tq.to(dtype) * mu
        back = (g[0] * (world[..., 0] - t[0]) + g[1] * (world[..., 1] - t[1])
                + g[2] * (world[..., 2] - t[2])) > 0.0
        ok = keep & ~back & (z > s["ray_near"]) & (z < s["ray_far"]) & (cz > 1e-6)
        zc = torch.clamp(cz, min=1e-6)
        u = torch.round(cam["fx"] * cx / zc + cam["cx"]).float()
        v = torch.round(cam["fy"] * cy / zc + cam["cy"]).float()
        ok = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = torch.where(ok, v.long() * w + u.long(), h * w)
        r, gg, bb = (cp >> 16) & 0xFF, (cp >> 8) & 0xFF, cp & 0xFF
        lum = (0.299 * r + 0.587 * gg + 0.114 * bb) * (1.0 / 255.0)
        i12 = torch.clamp(torch.round(lum * 4095.0), 0, 4095).to(torch.int32)
        zq = torch.clamp(torch.round(z * (ZQ_MAX / s["ray_far"])), 0, ZQ_MAX - 1).to(torch.int32)
        word = torch.where(ok, (zq << 12) | i12, LUMA_EMPTY)
        buf.scatter_reduce_(0, pix.reshape(-1), word.reshape(-1), "amin")
    return buf[: h * w]


def fill_smooth(d, mu: float, rounds: int):
    inf = float("inf")
    for _ in range(rounds):
        best = d
        worst = torch.where(torch.isfinite(d), d, -inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                n = shift2d(d, dy, dx, inf)
                best = torch.minimum(best, n)
                worst = torch.maximum(worst, torch.where(torch.isfinite(n), n, -inf))
        d = torch.where(torch.isfinite(d) | ~((worst - best) < 2.0 * mu), d, best)
    fin = torch.isfinite(d)
    acc = torch.where(fin, d, 0.0)
    cnt = fin.to(d.dtype)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n = shift2d(d, dy, dx, inf)
            ok = torch.isfinite(n) & (torch.abs(n - d) < 0.5 * mu)
            acc = acc + torch.where(ok, n, 0.0)
            cnt = cnt + ok
    return torch.where(fin, acc / torch.clamp(cnt, min=1.0), d)


def cross_normals(px, py, pz, hit):
    e1 = [shift2d(c, 0, 1) - c for c in (px, py, pz)]
    e2 = [shift2d(c, 1, 0) - c for c in (px, py, pz)]
    nx = e1[1] * e2[2] - e1[2] * e2[1]
    ny = e1[2] * e2[0] - e1[0] * e2[2]
    nz = e1[0] * e2[1] - e1[1] * e2[0]
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    hf = hit.to(px.dtype)
    ok = hit & (shift2d(hf, 0, 1) > 0.5) & (shift2d(hf, 1, 0) > 0.5) & (norm > 1e-12)
    inv = 1.0 / torch.clamp(norm, min=1e-12)
    return nx * inv, ny * inv, nz * inv, ok


def rays(R, sensor: dict, dtype):
    cam = camera(sensor)
    h, w = sensor["height"], sensor["width"]
    v = torch.arange(h, dtype=dtype, device=R.device)
    u = torch.arange(w, dtype=dtype, device=R.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    r = torch.stack([(uu - cam["cx"]) / cam["fx"] * 1.0, (vv - cam["cy"]) / cam["fy"] * 1.0,
                     torch.ones_like(uu)], dim=-1)
    return torch.einsum("ij,...j->...i", R, r)


def oriented_smoothed(nx, ny, nz, n_ok, d):
    flip = nx * d[..., 0] + ny * d[..., 1] + nz * d[..., 2] > 0.0
    sign = torch.where(flip, -1.0, 1.0)
    nx, ny, nz = nx * sign, ny * sign, nz * sign
    a = [torch.where(n_ok, c, 0.0) for c in (nx, ny, nz)]
    sm = [c.clone() for c in a]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            sm = [s_ + shift2d(c, dy, dx) for s_, c in zip(sm, a)]
    nrm = torch.sqrt(sm[0] * sm[0] + sm[1] * sm[1] + sm[2] * sm[2])
    good = (nrm > 1e-6) & n_ok
    inv = 1.0 / torch.clamp(nrm, min=1e-6)
    return [torch.where(good, s_ * inv, c) for s_, c in zip(sm, (nx, ny, nz))]


def diffuse(value, ok, rounds: int):
    for _ in range(rounds):
        okf = ok.to(value.dtype)
        acc = value * okf
        cnt = okf
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                acc = acc + shift2d(value * okf, dy, dx)
                cnt = cnt + shift2d(okf, dy, dx)
        grown = cnt > 0.0
        value = torch.where(~ok & grown, acc / torch.clamp(cnt, min=1.0), value)
        ok = ok | grown
    return value


def render(volume: dict, R, t, config: dict, dtype=torch.float32) -> dict:
    """Model maps of ``volume`` (``tsdf``, ``weight``, ``colorpack``,
    ``block_coords``, ``free_count``) seen from camera-to-world (R, t):
    ``depth``, ``valid``, ``normal`` (H, W, 3) and ``intensity``."""
    s, sensor = config["settings"], config["sensor"]
    h, w = sensor["height"], sensor["width"]
    R, t = R.to(dtype), t.to(dtype)
    ids = visible_blocks(volume["block_coords"], volume["free_count"], R, t, s, sensor)
    word = zbuffer(volume["tsdf"].to(dtype), volume["weight"], volume["colorpack"],
                   volume["block_coords"], ids, R, t, s, sensor, dtype).reshape(h, w)
    has = word != LUMA_EMPTY
    depth = torch.where(has, (word >> 12).to(dtype) * (s["ray_far"] / ZQ_MAX), float("inf"))
    inten = torch.where(has, (word & 0xFFF).to(dtype) * (1.0 / 4095.0), 0.0)
    d = fill_smooth(depth, s["trunc_dist"], s["splat_fill_rounds"])
    depth = torch.where(torch.isfinite(d), d, 0.0)
    hit = depth > 0.0
    dirs = rays(R, sensor, dtype)
    p = [t[k] + depth * dirs[..., k] for k in range(3)]
    nx, ny, nz, n_ok = cross_normals(*p, hit)
    n = oriented_smoothed(nx, ny, nz, n_ok, dirs)
    inten = diffuse(inten, has, s["splat_fill_rounds"])
    valid = hit & n_ok
    return {"depth": torch.where(valid, depth, 0.0).float(), "valid": valid,
            "normal": torch.stack([torch.where(valid, c, 0.0) for c in n], -1).float(),
            "intensity": torch.where(valid, inten, 0.0).float()}
