"""The hierarchical TSDF march's reference: the model depth a volume
renders to along each pixel's ray, in plain PyTorch.

The semantics (``vulcan_tpu_torch/ops/raycast.py`` ``raycast`` with
``compute_range_image`` and ``_march``, ``ops/render_cache.py``), written
here again; the program's survivor compaction is a way to run the same
rounds on fewer rays and has no counterpart here:

* the range image: each visible block's 8 corners, in camera space, give
  a depth range widened by ``mu`` and a footprint in ``range_scale``
  cells; a footprint of at most ``range_stamp`` cells a side is stamped
  into its cells (the nearest entry, the nearest exit, the farthest
  exit), a larger one or one behind the camera widens every pixel's range;
* the march texture: each observed voxel's TSDF in steps of 1/127 (a
  sentinel where unobserved), read at the nearest voxel; only the visible
  blocks (of a ``render_grid_size``-block grid from their least
  coordinate) are present; the trilinear TSDF reads a block and the
  faces of its +x/+y/+z neighbours;
* a coarse march at 1/``raycast_coarse`` resolution over the pooled
  range, then a fine march inside a window around the coarse hit, each in
  rounds of data-independent samples, stopping at the first positive to
  non-positive observed pair;
* the depth: the secant of the bracket's quantised values, then
  ``refine_steps`` secant steps on the trilinear TSDF; the hit is valid
  where its right and lower neighbours hit too (cross-product normals).

``dtype`` is the precision of the geometry: float32 as the configuration
states; bfloat16 makes the control.
"""
from __future__ import annotations

import torch

from .splat import camera, cross_normals, rays, shift2d, visible_blocks

UNSEEN = -128


def keys_of(coords: torch.Tensor) -> torch.Tensor:
    c = coords.to(torch.int64) + 512
    return (c[..., 0] * 1024 + c[..., 1]) * 1024 + c[..., 2]


class Texture:
    """The volume's voxels by integer voxel coordinates, as the render
    cache holds them for the visible blocks."""

    def __init__(self, volume: dict, vis: torch.Tensor, grid_size: int):
        n = volume["free_count"]
        coords = volume["block_coords"]
        self.all_keys, order = torch.sort(keys_of(coords[1:n]))
        self.all_rows = order + 1
        vc = coords[vis].to(torch.int64)
        gmin = vc.min(0).values if vc.numel() else torch.zeros(3, dtype=torch.int64,
                                                                device=coords.device)
        inside = torch.all((vc - gmin >= 0) & (vc - gmin < grid_size), -1)
        self.vis_keys = torch.sort(keys_of(vc[inside])).values
        self.tsdf = volume["tsdf"]
        self.weight = volume["weight"]

    @staticmethod
    def _find(keys, key):
        if keys.numel() == 0:
            return torch.zeros_like(key, dtype=torch.bool), torch.zeros_like(key)
        pos = torch.clamp(torch.searchsorted(keys, key), max=keys.numel() - 1)
        return keys[pos] == key, pos

    def _voxel(self, g):
        """(row of the volume or 0, flat local index) of voxel coords g."""
        b = [x >> 3 for x in g]
        li = ((g[0] - (b[0] << 3)) * 8 + (g[1] - (b[1] << 3))) * 8 + (g[2] - (b[2] << 3))
        key = ((b[0] + 512) * 1024 + (b[1] + 512)) * 1024 + (b[2] + 512)
        return b, key, li

    def visible(self, b):
        key = ((b[0] + 512) * 1024 + (b[1] + 512)) * 1024 + (b[2] + 512)
        return self._find(self.vis_keys, key)[0]

    def value(self, g):
        """(tsdf, observed) of any allocated voxel; (1, False) elsewhere."""
        _, key, li = self._voxel(g)
        if self.all_keys.numel() == 0:
            return torch.ones(key.shape, device=key.device), torch.zeros_like(key, dtype=torch.bool)
        found, pos = self._find(self.all_keys, key)
        row = torch.where(found, self.all_rows[pos], 0)
        return torch.where(found, self.tsdf[row, li], 1.0), found & (self.weight[row, li] > 0.0)

    def march(self, g):
        """The quantised TSDF (int) at voxel coords g: UNSEEN where the
        voxel is unobserved or its block is not in the texture."""
        b, _, _ = self._voxel(g)
        v, seen = self.value(g)
        q = torch.round(torch.clamp(v.float(), -1.0, 1.0) * 127.0).to(torch.int32)
        return torch.where(seen & self.visible(b), q, UNSEEN)

    def trilinear(self, px, py, pz, inv_vs):
        q = [p * inv_vs for p in (px, py, pz)]
        f = [torch.floor(x) for x in q]
        g0 = [torch.clamp(x, -2**30, 2**30).to(torch.int64) for x in f]
        w1 = [x - y for x, y in zip(q, f)]
        base = self.visible([x >> 3 for x in g0])
        val = torch.zeros_like(px)
        for dx in (0, 1):
            wx = w1[0] if dx else 1.0 - w1[0]
            for dy in (0, 1):
                wy = w1[1] if dy else 1.0 - w1[1]
                for dz in (0, 1):
                    wz = w1[2] if dz else 1.0 - w1[2]
                    v, _ = self.value((g0[0] + dx, g0[1] + dy, g0[2] + dz))
                    v = torch.where(base, v, 1.0).to(px.dtype)
                    val = val + (wx * wy * wz) * v
        return val


def range_image(volume, vis, R, t, s, sensor, dtype):
    cam = camera(sensor)
    h, w = sensor["height"], sensor["width"]
    sc, st = s["range_scale"], s["range_stamp"]
    hc, wc = -(-h // sc), -(-w // sc)
    dev = vis.device
    be = s["block_size"] * s["voxel_size"]
    coords = volume["block_coords"][vis].to(dtype)
    a = torch.arange(2.0, device=dev, dtype=dtype)
    corner = torch.stack(torch.meshgrid(a, a, a, indexing="ij"), -1).reshape(8, 3)
    pts = (coords[:, None, :] + corner) * be
    Rt = R.transpose(0, 1)
    p = torch.einsum("ij,...j->...i", Rt, pts) - torch.einsum("ij,j->i", Rt, t)
    z = p[..., 2]
    bad = z <= 1e-12
    safe = torch.where(bad, 1.0, z)
    u = torch.where(bad, -1e9, cam["fx"] * p[..., 0] / safe + cam["cx"])
    v = torch.where(bad, -1e9, cam["fy"] * p[..., 1] / safe + cam["cy"])
    mu = s["trunc_dist"]
    z_min = torch.clamp(z.amin(1) - mu, s["ray_near"], s["ray_far"])
    z_max = torch.clamp(z.amax(1) + mu, s["ray_near"], s["ray_far"])
    behind = torch.any(z <= 1e-3, 1)

    def fl(x):
        return torch.floor(torch.clamp(x, -2**30, 2**30)).to(torch.int64)

    u0, u1 = fl(u.amin(1) / sc), fl(u.amax(1) / sc)
    v0, v1 = fl(v.amin(1) / sc), fl(v.amax(1) / sc)
    over = behind | (u1 - u0 >= st) | (v1 - v0 >= st)
    inf = float("inf")
    t_min = torch.full((hc, wc), inf, dtype=dtype, device=dev)
    t_fmax = torch.full((hc, wc), inf, dtype=dtype, device=dev)
    t_max = torch.full((hc, wc), -inf, dtype=dtype, device=dev)
    du = torch.arange(st, device=dev)
    cu = u0[:, None, None] + du[None, :, None]
    cv = v0[:, None, None] + du[None, None, :]
    inside = ((~over)[:, None, None] & (cu <= u1[:, None, None]) & (cv <= v1[:, None, None])
              & (cu >= 0) & (cu < wc) & (cv >= 0) & (cv < hc))
    flat = (cv * wc + cu)[inside]
    zb = torch.broadcast_to(z_min[:, None, None], inside.shape)[inside]
    zx = torch.broadcast_to(z_max[:, None, None], inside.shape)[inside]
    t_min = t_min.reshape(-1).scatter_reduce(0, flat, zb, "amin").reshape(hc, wc)
    t_fmax = t_fmax.reshape(-1).scatter_reduce(0, flat, zx, "amin").reshape(hc, wc)
    t_max = t_max.reshape(-1).scatter_reduce(0, flat, zx, "amax").reshape(hc, wc)
    if bool(over.any()):
        t_min = torch.minimum(t_min, z_min[over].min())
        t_fmax = torch.minimum(t_fmax, z_max[over].max())
        t_max = torch.maximum(t_max, z_max[over].max())

    def up(x):
        return x.repeat_interleave(sc, 0).repeat_interleave(sc, 1)[:h, :w]

    return up(t_min), up(t_fmax), up(t_max)


def pool(a, k: int, amax: bool):
    h, w = a.shape
    ph, pw = (-h) % k, (-w) % k
    if ph:
        a = torch.cat([a, a[-1:].expand(ph, w)], 0)
    if pw:
        a = torch.cat([a, a[:, -1:].expand(h + ph, pw)], 1)
    r = a.reshape((h + ph) // k, k, (w + pw) // k, k)
    return torch.amax(r, dim=(1, 3)) if amax else torch.amin(r, dim=(1, 3))


def dilate3(a, op):
    fill = float("inf") if op is torch.minimum else -float("inf")
    out = a
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = op(out, shift2d(a, dy, dx, fill))
    return out


def secant(t_lo, t_hi, f_lo, f_hi):
    denom = f_lo - f_hi
    alpha = torch.where(torch.abs(denom) > 1e-12, f_lo / denom, 0.5)
    return t_lo + torch.clamp(alpha, 0.0, 1.0) * (t_hi - t_lo)


def march_level(tex, inv_vs, o, d, t0, spacing, t_limit, active, S, rounds):
    """The first +-to- crossing of the march texture along each ray, in
    ``rounds`` rounds of ``S`` samples: (t_hit, t_before, q_before, q_hit)."""
    offs = torch.arange(S, dtype=t0.dtype, device=t0.device)
    t_cur = t0
    last = torch.full(t0.shape, 127, dtype=torch.int32, device=t0.device)
    t_hit = torch.zeros_like(t0)
    t_bef = torch.zeros_like(t0)
    qb = torch.full_like(last, 127)
    qh = torch.full_like(last, 127)
    done = ~active
    for _ in range(rounds):
        ts = t_cur[..., None] + spacing[..., None] * offs
        g = [torch.round(torch.clamp((o[i] + ts * d[i][..., None]) * inv_vs, -2**30, 2**30))
             .to(torch.int64) for i in range(3)]
        m = tex.march(g)
        prev = torch.cat([last[..., None], m[..., :-1]], -1)
        cross = (prev > 0) & (m <= 0) & (m != UNSEEN) & (prev != UNSEEN)
        found = cross.any(-1) & ~done
        first = torch.argmax(cross.to(torch.uint8), -1)
        th = t_cur + spacing * first.to(t0.dtype)
        t_hit = torch.where(found, th, t_hit)
        t_bef = torch.where(found, th - spacing, t_bef)
        qb = torch.where(found, torch.gather(prev, -1, first[..., None])[..., 0], qb)
        qh = torch.where(found, torch.gather(m, -1, first[..., None])[..., 0], qh)
        done = done | found
        t_cur = t_cur + spacing * S
        done = done | (t_cur > t_limit)
        last = m[..., -1]
    return t_hit, t_bef, qb, qh


def render(volume: dict, R, t, config: dict, dtype=torch.float32) -> dict:
    """``depth`` (H, W) and ``valid`` of the march of ``volume`` from
    camera-to-world (R, t)."""
    s, sensor = config["settings"], config["sensor"]
    h, w = sensor["height"], sensor["width"]
    R, t = R.to(dtype), t.to(dtype)
    vs, mu = s["voxel_size"], s["trunc_dist"]
    inv_vs = 1.0 / vs
    vis = visible_blocks(volume["block_coords"], volume["free_count"], R, t, s, sensor)
    tex = Texture(volume, vis, s["render_grid_size"])
    dirs = rays(R, sensor, dtype)
    d = [dirs[..., i] for i in range(3)]
    inv_dn = 1.0 / torch.clamp(torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]), min=1e-9)
    t_min, t_fmax, t_max = range_image(volume, vis, R, t, s, sensor, dtype)
    has = t_min <= t_max
    inf = float("inf")
    S = s["raycast_chunk"]
    rounds = -(-s["raycast_steps"] // S)
    k = s["raycast_coarse"]
    cd = [x[::k, ::k] for x in d]
    c_inv = inv_dn[::k, ::k]
    c_tmin = pool(t_min, k, False)
    c_tfmax = pool(torch.where(has, t_fmax, -inf), k, True)
    c_tmax = pool(torch.where(has, t_max, -inf), k, True)
    c_act = c_tmin <= c_tmax
    c_span = torch.clamp(c_tfmax - c_tmin, min=0.0)
    c_sp = torch.minimum(torch.maximum(c_span / S, 0.75 * vs * c_inv),
                         2.0 * s["raycast_step_scale"] * mu * c_inv)
    ct, _, _, _ = march_level(tex, inv_vs, t, cd, torch.where(c_act, c_tmin, s["ray_far"]),
                              c_sp, c_tmax, c_act, S, rounds)
    c_hit = ct > 0.0
    pad = 2.0 * c_sp
    c_lo = dilate3(torch.where(c_hit, ct - pad, c_tmin), torch.minimum)
    c_hi = dilate3(torch.where(c_hit, ct + pad, c_tfmax), torch.maximum)

    def up(x):
        return x.repeat_interleave(k, 0).repeat_interleave(k, 1)[:h, :w]

    lo = torch.maximum(up(c_lo), t_min)
    hi = torch.minimum(torch.maximum(up(c_hi), lo), t_max)
    Sf = s["raycast_fine_chunk"]
    sp = torch.minimum(torch.maximum(torch.clamp(hi - lo, min=0.0) / Sf, 0.5 * vs * inv_dn),
                       s["raycast_step_scale"] * mu * inv_dn)
    t_hit, t_bef, qb, qh = march_level(tex, inv_vs, t, d, torch.where(has, lo, s["ray_far"]),
                                       sp, hi, has, Sf, rounds)
    hit = t_hit > 0.0
    fl, fh = qb.to(dtype) / 127.0, qh.to(dtype) / 127.0
    ts = secant(t_bef, t_hit, fl, fh)
    t_lo, t_hi = t_bef, t_hit
    for _ in range(s["refine_steps"]):
        fm = tex.trilinear(t[0] + ts * d[0], t[1] + ts * d[1], t[2] + ts * d[2], inv_vs)
        pos = fm > 0.0
        t_lo, fl = torch.where(pos, ts, t_lo), torch.where(pos, fm, fl)
        t_hi, fh = torch.where(pos, t_hi, ts), torch.where(pos, fh, fm)
        ts = secant(t_lo, t_hi, fl, fh)
    p = [t[i] + ts * d[i] for i in range(3)]
    valid = cross_normals(*p, hit)[3]
    return {"depth": torch.where(valid, ts, 0.0).float(), "valid": valid}
