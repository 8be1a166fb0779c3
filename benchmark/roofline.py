"""Peaks of the card and the bytes and operations of the track's hand
kernels: a frozen copy of ``chip_smoke.py``'s ``bound`` and
``icp_bytes_ops`` (the per-pixel operation counts were taken from the
plain versions in ``vulcan_tpu_torch/ops/icp.py``), with the launches a
tracked frame makes at each pyramid level worked out from the
configuration as ``ops/icp.py`` ``track`` makes them.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations a live pixel, (geometric, photometric).
ICP_OPS = {"associate": (70, 55), "rows": (133, 146)}
ICP_SOLVE_OPS = 400      # one 6x6 step: the factor, two solves, exp, product


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def icp_bytes_ops(kind: str, n: int, model: int, geometric: bool,
                  photo: bool) -> tuple[int, int]:
    """Bytes in + out and f32 operations of one H1a (``associate``) or
    fused GN step (``rows_solve``) on a level of ``n`` live pixels and a
    model map of ``model`` pixels: each input read once, each output
    written once."""
    if kind == "rows_solve":
        nbytes, ops = icp_bytes_ops("rows", n, model, geometric, photo)
        return nbytes + 64, ops + ICP_SOLVE_OPS
    if kind == "associate":
        nbytes = 12 * n + (4 * n + min(12 * n, 12 * model) + 25 * n if geometric else 0) \
            + (min(32 * n, 8 * model) + 21 * n if photo else 0)
    else:
        nbytes = 4 * 2 * 29 + (49 * n if geometric else 0) + (29 * n if photo else 0)
    geo_ops, photo_ops = ICP_OPS[kind]
    return nbytes + 124, n * (geo_ops * geometric + photo_ops * photo)


def track_launches(settings: dict, mode: str, height: int, width: int):
    """[(kind, n, model, geometric, photo, launches)] of one tracked frame:
    per level, ``rounds`` H1a launches and ``rounds * ceil(iters / rounds)``
    GN steps plus the level's score, each a fused-step launch."""
    levels = settings["pyramid_levels"]
    strides = settings["icp_stride"]
    if isinstance(strides, int):
        strides = [strides] + [1] * (levels - 1)
    out = []
    for level in range(levels):
        h, w = height >> level, width >> level
        s = strides[level]
        n = (-(-h // s)) * (-(-w // s))
        photo = mode == "color" or (mode != "depth"
                                    and levels - level <= settings["photo_levels"])
        geometric = mode != "color"
        iters = settings["icp_iters"][level]
        rounds = max(1, min(settings["icp_assoc"][level], iters))
        steps = rounds * math.ceil(iters / rounds) + 1
        out.append(("associate", n, h * w, geometric, photo, rounds))
        out.append(("rows_solve", n, h * w, geometric, photo, steps))
    return out


def track_bound_s(settings: dict, mode: str, height: int, width: int) -> float:
    """The least seconds one tracked frame's H1a and fused-step launches
    could take on the card."""
    return sum(k * bound_s(*icp_bytes_ops(kind, n, m, g, p))
               for kind, n, m, g, p, k in track_launches(settings, mode, height, width))
