"""The track's reference: the pose at which a live frame's finest level
fits the model maps, by plain point-to-plane Gauss-Newton, in PyTorch.

The semantics (``vulcan_tpu_torch/ops/icp.py`` ``track`` at its finest
pyramid level, which carries only the geometric rows in every mode but
"color"; ``ops/preprocess.py`` ``build_pyramid``), written here again:

* the live side: the bilateral-filtered depth (metres), its vertex map
  through the pinhole and its normals from forward differences facing
  the camera, every ``icp_stride[0]``-th pixel;
* association: each live point, moved to the world by the pose, is
  projected into the model camera and takes the model vertex and normal
  of the nearest pixel (half to even) where the model is valid, the live
  depth in range and the point in front of the model camera;
* a pair counts when closer than ``icp_dist_thresh`` and its normals
  agree beyond ``icp_normal_thresh``; its residual is the point-to-plane
  distance, Huber-weighted at ``icp_huber_delta``;
* each step solves the damped 6x6 normal equations for the twist
  (rotation first) and updates ``T <- exp(xi) T``; association is redone
  every few steps until the pose stops moving.

The program runs a pyramid, and its finest level a few steps; the
reference, started from the previous frame's pose, iterates the finest
level to its fixed point.  ``dtype`` is the precision of the geometry and
of the pose: float32 as the configuration states; bfloat16 makes the
control (its 6x6 solve runs in float32, which bfloat16 lacks).
"""
from __future__ import annotations

import numpy as np
import torch

from .integrate import bilateral
from .splat import camera, shift2d

ROUNDS = 12          # association rounds
STEPS = 3            # Gauss-Newton steps a round


def live_maps(depth, sensor: dict, s: dict, dtype):
    """(depth, camera-space vertices, normals) of the filtered depth, every
    stride-th pixel."""
    cam = camera(sensor)
    if s["bilateral_enabled"]:
        depth = bilateral(depth, s["bilateral_radius"], s["bilateral_sigma_space"],
                          s["bilateral_sigma_depth"])
    h, w = depth.shape
    v = torch.arange(h, dtype=dtype, device=depth.device)
    u = torch.arange(w, dtype=dtype, device=depth.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    verts = torch.stack([(uu - cam["cx"]) / cam["fx"] * depth,
                         (vv - cam["cy"]) / cam["fy"] * depth, depth], -1)
    verts = torch.where((depth > 0.0)[..., None], verts, 0.0)
    valid = torch.any(verts != 0.0, -1)
    vr, vd = shift2d(verts, 0, 1), shift2d(verts, 1, 0)
    n = torch.linalg.cross(vr - verts, vd - verts, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    n = torch.where(torch.sum(n * verts, -1, keepdim=True) > 0.0, -n, n)
    ok = valid & torch.any(vr != 0.0, -1) & torch.any(vd != 0.0, -1) & (norm[..., 0] > 1e-12)
    n = torch.where(ok[..., None], n, 0.0)
    st = s["icp_stride"][0] if isinstance(s["icp_stride"], list) else s["icp_stride"]
    return depth[::st, ::st], verts[::st, ::st], n[::st, ::st]


def exp_se3(xi):
    """Twist (omega, v) -> (R, t), in xi's dtype."""
    w, v = xi[:3], xi[3:]
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2)
    K = torch.zeros((3, 3), dtype=xi.dtype, device=xi.device)
    K[0, 1], K[0, 2], K[1, 0], K[1, 2], K[2, 0], K[2, 1] = -w[2], w[1], w[2], -w[0], -w[1], w[0]
    small = bool(th2 < 1e-8)
    a = 1.0 - th2 / 6.0 if small else torch.sin(th) / th
    b = 0.5 - th2 / 24.0 if small else (1.0 - torch.cos(th)) / th2
    c = 1.0 / 6.0 - th2 / 120.0 if small else (th - torch.sin(th)) / (th2 * th)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    KK = K @ K
    return eye + a * K + b * KK, (eye + b * K + c * KK) @ v


def fit(depth, model: dict, R0, t0, config: dict, dtype=torch.float32):
    """The camera-to-world (R, t) at which the frame's finest level fits the
    model maps (``vertex`` (H, W, 3) and ``normal`` world, ``valid``,
    the model's camera-to-world ``R``, ``t``), iterated from (R0, t0);
    and the last step's paired live points (camera space) with their
    model normals, (N, 3) each."""
    s, sensor = config["settings"], config["sensor"]
    cam = camera(sensor)
    h, w = sensor["height"], sensor["width"]
    d, vc, nc = live_maps(depth.to(dtype), sensor, s, dtype)
    vc, nc = vc.reshape(-1, 3), nc.reshape(-1, 3)
    d = d.reshape(-1)
    live_ok = (d > s["depth_min"]) & (d < s["depth_max"])
    mR, mt = model["R"].to(dtype), model["t"].to(dtype)
    mRt = mR.transpose(0, 1)
    mtr = -(mRt @ mt)
    mv = model["vertex"].to(dtype).reshape(-1, 3)
    mn = model["normal"].to(dtype).reshape(-1, 3)
    mvalid = model["valid"].reshape(-1)
    R, t = R0.to(dtype), t0.to(dtype)
    damp = s["icp_damping"]
    for _ in range(ROUNDS):
        pw = vc @ R.transpose(0, 1) + t
        pm = pw @ mRt.transpose(0, 1) + mtr
        z = pm[:, 2]
        safe = torch.where(z > 1e-12, z, 1.0)
        u = torch.round(cam["fx"] * pm[:, 0] / safe + cam["cx"]).float()
        v = torch.round(cam["fy"] * pm[:, 1] / safe + cam["cy"]).float()
        inb = (z > 1e-12) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        idx = torch.clamp(v, 0, h - 1).long() * w + torch.clamp(u, 0, w - 1).long()
        ok = live_ok & inb & mvalid[idx] & (z > 0.0)
        vm, nm = mv[idx], mn[idx]
        for _ in range(STEPS):
            pw = vc @ R.transpose(0, 1) + t
            nw = nc @ R.transpose(0, 1)
            diff = pw - vm
            gate = (ok & (torch.sum(diff * diff, -1) < s["icp_dist_thresh"] ** 2)
                    & (torch.sum(nw * nm, -1) > s["icp_normal_thresh"]))
            r = torch.sum(nm * diff, -1)
            a = torch.abs(r)
            wt = torch.where(a <= s["icp_huber_delta"], 1.0,
                             s["icp_huber_delta"] / torch.clamp(a, min=1e-12))
            wt = torch.where(gate, wt, 0.0).to(dtype)
            J = torch.cat([torch.linalg.cross(pw, nm, dim=-1), nm], -1)       # (N, 6)
            H = (J[:, :, None] * J[:, None, :] * wt[:, None, None]).sum(0)
            b = (J * (wt * r)[:, None]).sum(0)
            H32, b32 = H.float(), b.float()
            Hd = H32 + damp * torch.diag(torch.clamp(torch.diagonal(H32), min=1e-12))
            xi = -torch.linalg.solve(Hd + 1e-12 * torch.eye(6, device=H.device), b32)
            if not bool(torch.isfinite(xi).all()) or int(gate.sum()) < 6:
                break
            dR, dt = exp_se3(xi.to(dtype))
            R, t = dR @ R, dR @ t + dt
    return R, t, (vc[gate].float(), nm[gate].float())


def normal_gap_mm(R, t, R_ref, t_ref, pairs) -> float:
    """The root mean square, over the paired live points, of the distance
    along their model normals between each point placed by (R, t) and by
    (R_ref, t_ref), in mm: the part of a pose gap the point-to-plane
    geometry can see (a slide along a plane it cannot is left out)."""
    p, n = (np.asarray(x.cpu(), np.float64) for x in pairs)
    if len(p) == 0:
        return float("inf")
    d = p @ (np.asarray(R, np.float64) - np.asarray(R_ref, np.float64)).T \
        + (np.asarray(t, np.float64) - np.asarray(t_ref, np.float64))
    return float(np.sqrt(np.mean(np.sum(d * n, axis=1) ** 2))) * 1e3


def pose_gap(R, t, R_ref, t_ref) -> tuple[float, float]:
    """(translation gap mm, rotation gap degrees) of two poses."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    R_ref, t_ref = np.asarray(R_ref, np.float64), np.asarray(t_ref, np.float64)
    rel = R_ref.T @ R
    w = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0], rel[1, 0] - rel[0, 1]])
    ang = np.degrees(np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(rel) - 1.0)))
    return float(np.linalg.norm(t - t_ref)) * 1e3, float(ang)
