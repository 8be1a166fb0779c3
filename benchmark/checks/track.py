"""track: ``track_gap_mm`` and ``track_gap_deg``.  For each of the frames
tracked just after the window, the gap between the pose the program
tracked and the reference's fit of the same frame to the model maps the
program tracked it against (copied before the frame): the RMS distance
along the model normals between the paired live points placed by either
pose (what the point-to-plane geometry can see), and the rotation; the
widest over the frames.  The reference (``reference/track.py``) is the
geometric fit of the finest level, which the program's finest level
carries in modes ``depth`` and ``combined`` alone."""
import sys

import torch

from benchmark.reference import track

NUMBERS = ("track_gap_mm", "track_gap_deg")
FOLLOWS = {"mode": ("depth", "combined"), "ablate": ("",)}
TRACK = True


def before_frame(pipe):
    """The model maps the next frame tracks against, copied before the
    frame overwrites them."""
    m = pipe.state.model
    return {"tracked": {"vertex": torch.stack([m.vx, m.vy, m.vz], -1).clone(),
                        "normal": torch.stack([m.nx, m.ny, m.nz], -1).clone(),
                        "valid": m.valid.clone(), "R": m.pose.rotation.clone(),
                        "t": m.pose.translation.clone()}}


def fits(inp, dtype) -> list:
    """The reference's fit, in ``dtype``, of each tracked frame to the
    model maps it was tracked against, started from the model's pose:
    [(R, t, pairs)], R and t as float64 arrays."""
    units = 1.0 / inp.config["sensor"]["depth_units_per_m"]
    out = []
    for i, model in inp.program["tracked"]:
        depth = inp.frames(i)[0].to(torch.float32) * units
        fR, ft, pairs = track.fit(depth, model, model["R"], model["t"], inp.config, dtype)
        out.append((fR.double().cpu().numpy(), ft.double().cpu().numpy(), pairs))
    return out


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


def numbers(inp, shared):
    r = inp.run
    shared["track.fits"] = fits(inp, torch.float32)
    gaps, text = gap_numbers([(r["rot"][i], r["trans"][i]) for i, _ in inp.program["tracked"]],
                             shared["track.fits"])
    print(text, file=sys.stderr)
    return gaps


def control(inp, shared):
    fits16 = fits(inp, torch.bfloat16)
    return gap_numbers([f[:2] for f in fits16], shared["track.fits"])[0]
