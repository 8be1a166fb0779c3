"""The per-voxel TSDF update rule and nearest-pixel image sampling.

Part of ``vulcan_tpu/ops/dense.py``: only what the sparse integrator of
the online step uses (``voxel_update``, ``_sample_nearest``).  The
dense-grid backend itself is still to be ported (ROADMAP.md).

    sdf = depth(project(voxel)) - z_voxel
    if sdf > -mu:  F <- (W*F + w*clamp(sdf/mu)) / (W + w);  W <- min(W+w, Wmax)
"""
from __future__ import annotations

import torch

from ..config import Config

# Pixel coordinates are clamped to this before the float->int32 cast: an
# out-of-range cast gives INT_MIN on the CPU but saturates on CUDA.  Both
# are out of bounds anyway; the clamp makes the two devices agree.
COORD_CLAMP = 1e7


def round_to_int(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (like jnp.round) and cast to int64 indices."""
    return torch.round(torch.clamp(x, -COORD_CLAMP, COORD_CLAMP)).to(torch.int64)


def _sample_nearest(img: torch.Tensor, uv: torch.Tensor):
    """Nearest-neighbour image sample. Returns (values, valid_mask)."""
    h, w = img.shape[0], img.shape[1]
    u = round_to_int(uv[..., 0])
    v = round_to_int(uv[..., 1])
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc = torch.clamp(u, 0, w - 1)
    vc = torch.clamp(v, 0, h - 1)
    return img[vc, uc], ok


def voxel_update(
    tsdf, weight, color, color_weight, sdf, sample_color, valid, config: Config
):
    """Shared per-voxel TSDF + colour running-average update.  Only voxels
    with sdf > -mu are touched; colour is updated inside |sdf| < mu."""
    mu = config.trunc_dist
    update = valid & (sdf > -mu)
    tsdf_obs = torch.clamp(sdf / mu, -1.0, 1.0)
    w_obs = update.to(torch.float32)

    new_weight = weight + w_obs
    new_tsdf = torch.where(
        update,
        (weight * tsdf + w_obs * tsdf_obs) / torch.clamp(new_weight, min=1e-12),
        tsdf,
    )
    new_weight = torch.clamp(new_weight, max=config.max_weight)

    cupdate = update & (torch.abs(sdf) < mu)
    cw_obs = cupdate.to(torch.float32)
    new_cweight = color_weight + cw_obs
    new_color = torch.where(
        cupdate[..., None],
        (color_weight[..., None] * color + cw_obs[..., None] * sample_color)
        / torch.clamp(new_cweight[..., None], min=1e-12),
        color,
    )
    new_cweight = torch.clamp(new_cweight, max=config.max_weight)
    return new_tsdf, new_weight, new_color, new_cweight
