"""The comparison that decides ``correct``: what the timed path produced,
held against the plain references of ``benchmark/reference``.

Each number below is compared with its limit (``limits/<workload>.json``;
the configuration states ``ate_m`` and ``overflows``):

* ``ate_m``: the trajectory's RMSE after Horn alignment against the true
  poses, every frame of the run (warm-up, window and traced frames);
* ``track_gap_mm``, ``track_gap_deg``: for each of the frames tracked
  just after the window, the gap between the pose the program tracked and
  the reference's fit of the same frame to the model maps the program
  tracked it against (its state, copied before the frame): the RMS
  distance along the model normals between the paired live points placed
  by either pose (what the point-to-plane geometry can see), and the
  rotation; the widest over the frames;
* ``volume_mismatch``: the share of the observed voxels of a sample of
  blocks (drawn from the seed, from the program's allocated blocks, the
  reference's last band and the blocks the last render sees) whose TSDF (by more than 1e-3), weight,
  colour (by more than one level) or colour weight differs from the
  reference's fusion of the same frames at the poses the program fused
  them at;
* ``render_mismatch``: the share of the pixels valid on either side where
  the last frame's model maps differ from the reference's render of the
  program's final volume at the last pose: validity, or the depth (by more
  than ``RENDER_DEPTH_TOL``), the normal (surfel splat,
  by more than 1e-3 a component) or the luma (by more than 2/4095);
* ``overflows``: the volume's dropped allocations and visible-list
  entries, exactly 0.

``control_numbers`` computes the same numbers with the references in
bfloat16 put in the program's place (the true trajectory worked out in
bfloat16), the control that has to come out not correct.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import scene
from .reference import integrate, march, splat, track, trajectory

SAMPLE_BLOCKS = 384
RENDER_DEPTH_TOL = 1e-4   # m


def fused_frames(failures: np.ndarray, degenerate: np.ndarray) -> np.ndarray:
    """(n,) whether each frame was fused: its track neither distrusted nor
    degenerate (the counters after each frame did not move)."""
    prev_f = np.concatenate([[0], failures[:-1]])
    prev_d = np.concatenate([[0], degenerate[:-1]])
    return (failures == prev_f) & (degenerate == prev_d)


def sample_blocks(inp, seed: int, rendered: dict) -> torch.Tensor:
    """Block coordinates (K, 3) drawn from the seed, a third from each of:
    the blocks the program allocated; the reference's truncation band of
    the last fused frame (so that blocks the program failed to allocate
    are sampled too); and the blocks that hold the surface points of
    ``rendered``, the reference's render of the program's final volume
    (so that the volume the render check reads is itself checked)."""
    rng = np.random.default_rng(seed)
    part = SAMPLE_BLOCKS // 3

    def draw(keys: torch.Tensor) -> torch.Tensor:
        pick = rng.choice(keys.numel(), size=min(part, keys.numel()), replace=False)
        return keys[torch.from_numpy(pick).to(keys.device)]

    vol = inp.volume
    prog = integrate.block_key(vol["block_coords"][1:vol["free_count"]])
    i = int(np.flatnonzero(inp.fused)[-1])
    R = torch.from_numpy(inp.run["rot"][i]).to(inp.device)
    t = torch.from_numpy(inp.run["trans"][i]).to(inp.device)
    band = integrate.frame_band(inp.frames, i, R, t, inp.config)[1]
    seen = integrate.surface_keys(rendered["depth"], rendered["valid"], inp.config,
                                  *inp.last_pose())
    return integrate.key_coords(torch.unique(torch.cat([draw(prog), draw(band), draw(seen)])))


def program_blocks(vol: dict, blocks: torch.Tensor):
    """The program's TSDF, weight, colour and colour weight of the blocks
    ``blocks`` (K, 3); a block it never allocated reads as unobserved."""
    n = vol["free_count"]
    keys, order = torch.sort(integrate.block_key(vol["block_coords"][1:n]))
    want = integrate.block_key(blocks)
    pos = torch.clamp(torch.searchsorted(keys, want), max=max(keys.numel() - 1, 0))
    found = (keys[pos] == want) if keys.numel() else torch.zeros_like(want, dtype=torch.bool)
    rows = torch.where(found, order[pos] + 1 if keys.numel() else pos, 0)
    col, cw = unpack_colors(vol["colorpack"][rows])
    f = found[:, None]
    return (torch.where(f, vol["tsdf"][rows], 1.0), torch.where(f, vol["weight"][rows], 0.0),
            torch.where(f[..., None], col, 0), torch.where(f, cw, 0))


def volume_mismatch(got, want) -> float:
    """Share of the voxels observed on either side that differ."""
    gt, gw, gc, gcw = got
    wt, ww, wc, wcw = want
    seen = (gw > 0) | (ww > 0)
    bad = ((torch.abs(gt - wt) > 1e-3) | (torch.abs(gw - ww) > 0.5)
           | (torch.abs(gc - wc) > 1).any(-1) | (gcw != wcw))
    n = int(seen.sum())
    return float((bad & seen).sum()) / n if n else 1.0


def unpack_colors(colorpack: torch.Tensor):
    c = torch.stack([(colorpack >> 16) & 0xFF, (colorpack >> 8) & 0xFF, colorpack & 0xFF], -1)
    return c.to(torch.int32), ((colorpack >> 24) & 0xFF).to(torch.int32)


def render_mismatch(got: dict, want: dict, mode: str) -> float:
    either = got["valid"] | want["valid"]
    both = got["valid"] & want["valid"]
    bad = (got["valid"] != want["valid"]) | (
        both & (torch.abs(got["depth"] - want["depth"]) > RENDER_DEPTH_TOL))
    if mode == "splat":
        bad |= both & ((torch.abs(got["normal"] - want["normal"]) > 1e-3).any(-1)
                       | (torch.abs(got["intensity"] - want["intensity"]) > 2.0 / 4095.0))
    n = int(either.sum())
    return float((bad & either).sum()) / n if n else 1.0


def reference_render(volume: dict, R, t, config: dict, dtype):
    mode = config["settings"]["render_mode"]
    fn = splat.render if mode == "splat" else march.render
    return fn(volume, R, t, config, dtype)


def track_fits(inp, tracked, dtype) -> list:
    """The reference's fit, in ``dtype``, of each frame of ``tracked``
    ((frame index, the model maps it was tracked against)), started from
    the model's pose: [(R, t, pairs)], R and t as float64 arrays."""
    units = 1.0 / inp.config["sensor"]["depth_units_per_m"]
    fits = []
    for i, model in tracked:
        depth = inp.frames(i)[0].to(torch.float32) * units
        fR, ft, pairs = track.fit(depth, model, model["R"], model["t"], inp.config, dtype)
        fits.append((fR.double().cpu().numpy(), ft.double().cpu().numpy(), pairs))
    return fits


def gap_numbers(poses, fits) -> tuple[dict, str]:
    """The widest gap between ``poses`` and the reference's ``fits``,
    pairwise: along the paired points' normals (mm) and in rotation
    (degrees); and every frame's gaps, the raw translation's too, as text."""
    mm = [track.normal_gap_mm(R, t, fR, ft, pairs) for (R, t), (fR, ft, pairs) in zip(poses, fits)]
    gaps = [track.pose_gap(R, t, fR, ft) for (R, t), (fR, ft, _) in zip(poses, fits)]
    text = ("track gaps: translation mm " + " ".join(f"{g[0]:.4g}" for g in gaps)
            + "; along the normals mm " + " ".join(f"{g:.4g}" for g in mm)
            + "; degrees " + " ".join(f"{g[1]:.4g}" for g in gaps))
    return {"track_gap_mm": max(mm), "track_gap_deg": max(g[1] for g in gaps)}, text


class Inputs:
    """What the references need: the run's frames on ``device`` (one turn,
    uploaded once), the true poses and the program's outputs."""

    def __init__(self, stream, run: dict, volume: dict, model: dict, config: dict,
                 traffic: dict, device):
        self.depth = torch.from_numpy(stream.depth.astype(np.int32)).to(device)
        self.color = torch.from_numpy(stream.color).to(device)
        self.turn = len(stream)
        self.run = run
        self.volume = volume
        self.model = model
        self.config = config
        self.traffic = traffic
        self.device = device
        n = len(run["rot"])
        idx = np.arange(n) % self.turn
        self.gt_rot = stream.rotation[idx]
        self.gt_trans = stream.translation[idx]
        self.fused = fused_frames(run["failures"], run["degenerate"])

    def frames(self, i):
        k = i % self.turn
        return self.depth[k], self.color[k]

    def fuse(self, blocks, dtype):
        r = self.run
        return integrate.fuse_history(self.frames, r["rot"], r["trans"], self.fused, blocks,
                                      self.config, dtype)

    def last_pose(self):
        r = self.run
        return (torch.from_numpy(r["rot"][-1]).to(self.device),
                torch.from_numpy(r["trans"][-1]).to(self.device))

    def render(self, dtype):
        return reference_render(self.volume, *self.last_pose(), self.config, dtype)


def numbers(inp: Inputs, seed: int, counters: dict, tracked) -> tuple[dict, dict]:
    """The program's numbers, and the references' intermediate results the
    control is held against."""
    r = inp.run
    out = {}
    fits = []
    if tracked:
        out["ate_m"] = trajectory.ate_rmse(r["trans"], inp.gt_trans)
        fits = track_fits(inp, tracked, torch.float32)
        gaps, text = gap_numbers([(r["rot"][i], r["trans"][i]) for i, _ in tracked], fits)
        print(text, file=sys.stderr)
        out.update(gaps)
    ref_render = inp.render(torch.float32)
    blocks = sample_blocks(inp, seed, ref_render)
    want = inp.fuse(blocks, torch.float32)
    out["volume_mismatch"] = volume_mismatch(program_blocks(inp.volume, blocks), want)
    mode = inp.config["settings"]["render_mode"]
    out["render_mismatch"] = render_mismatch(inp.model, ref_render, mode)
    out["overflows"] = counters["alloc_overflow"] + counters["visible_overflow"]
    return out, {"blocks": blocks, "volume": want, "render": ref_render, "fits": fits}


def control_numbers(inp: Inputs, refs: dict, tracked) -> dict:
    """The same numbers with the bfloat16 references in the program's
    place (the trajectory's reference, the truth, worked out in bfloat16)."""
    out = {}
    if tracked:
        rot16, trans16 = scene.trajectory(inp.traffic, dtype=torch.bfloat16)
        idx = np.arange(len(inp.run["rot"])) % inp.turn
        out["ate_m"] = trajectory.ate_rmse(trans16.double().numpy()[idx], inp.gt_trans)
        fits16 = track_fits(inp, tracked, torch.bfloat16)
        out.update(gap_numbers([f[:2] for f in fits16], refs["fits"])[0])
    out["volume_mismatch"] = volume_mismatch(inp.fuse(refs["blocks"], torch.bfloat16),
                                             refs["volume"])
    mode = inp.config["settings"]["render_mode"]
    out["render_mismatch"] = render_mismatch(inp.render(torch.bfloat16), refs["render"], mode)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; ``correct`` when every one is within."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
