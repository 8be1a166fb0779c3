"""Where a frame's time goes, for one checkout or several compared in turns.

    python -m vulcan_tpu_torch.tools.stage_profile [--roots DIR ...]
        [--out chiprun_out/stage_profile.json]

For each checkout root, in the order given (e.g. a parent's tree unpacked
under ``build/``, then this one, this one, the parent: two versions
compared on one card in turns), a fresh process run from that root uses
that checkout's own ``chip_smoke.py`` and ``vulcan_tpu_torch`` on the
35-frame 480x640 orbit, in depth and in combined mode:

  * ms/frame, synchronized per frame (``chip_smoke.run_pipeline``), median
    over the frames after the 5 warm-up ones;
  * ``chip_smoke.profile_stages``: stage wall times with a device sync at
    each stage boundary, kernel ms a stage and the device's busy ms, idle
    share and operations a frame (torch.profiler);
  * the track stage's device operations a frame (``icp.model_pyramid`` and
    ``icp.track`` each run under a profiler of its own for 5 steady frames:
    the CUDA kernels, copies and fills they launch).

Prints a table and writes every run's report as JSON.  Needs the card; a
root without ``chip_smoke.py`` or the package raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Run inside each root's own process (cwd = the root).
_CHILD = r'''
import json, os, statistics, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
import vulcan_tpu_torch as P
from torch.profiler import ProfilerActivity, profile
from vulcan_tpu_torch.io.synthetic import orbit_poses
from vulcan_tpu_torch.ops import icp

if not torch.cuda.is_available():
    raise SystemExit("stage_profile needs the card")
dev = torch.device("cuda:0")
cam = P.PinholeCamera.tum_default()
n = cs.N_WARM + cs.N_TIMED
poses = orbit_poses(n, radius=1.6, height=0.35, span=min(6.28, n * 0.05))
frames = cs.make_frames(P, cam, poses, 480, 640, dev)
cuda = torch.autograd.DeviceType.CUDA


def track_ops(mode, n_warm=15, n_run=5):
    ops, ms = [], []
    pipe = P.Pipeline(P.Config(), cam, 480, 640, init_pose=poses[0], mode=mode, device=dev)
    for d16, c8 in frames[:n_warm]:
        pipe.process(d16, c8)
    originals = {name: getattr(icp, name) for name in ("model_pyramid", "track")}

    def profiled(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages() if e.device_type == cuda]
            ops.append(sum(e.count for e in evs))
            ms.append(sum(cs.dev_us(e, True) for e in evs) / 1e3)
            return out
        return run

    try:
        for name, fn in originals.items():
            setattr(icp, name, profiled(fn))
        for d16, c8 in frames[n_warm:n_warm + n_run]:
            pipe.process(d16, c8)
    finally:
        for name, fn in originals.items():
            setattr(icp, name, fn)
    return sum(ops) / n_run, sum(ms) / n_run


out = {"device": cs.nvidia_smi(), "root": os.getcwd()}
for mode in ("depth", "combined"):
    _, _, ms, _ = cs.run_pipeline(P, P.Config(), cam, poses, frames, 480, 640, dev,
                                  torch.cuda.synchronize, mode)
    wall = statistics.median(ms[cs.N_WARM:])
    rep = cs.profile_stages(P, torch, P.Config(), cam, poses, frames, dev, wall, mode)
    rep["track_ops_per_frame"], rep["track_kernel_ms_alone"] = track_ops(mode)
    out[mode] = rep
print("STAGE_PROFILE " + json.dumps(out), flush=True)
'''


def run_root(root: str) -> dict:
    """One root's report (its own process, cwd = the root)."""
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=root, capture_output=True,
                          text=True)
    sys.stderr.write(proc.stderr[-4000:])
    for line in proc.stdout.splitlines():
        if line.startswith("STAGE_PROFILE "):
            return json.loads(line[len("STAGE_PROFILE "):])
    raise RuntimeError(f"stage_profile: {root} gave no report (exit {proc.returncode}):\n"
                       f"{proc.stdout[-4000:]}")


def summary(label: str, rep: dict) -> str:
    rows = []
    for mode in ("depth", "combined"):
        r = rep[mode]
        track = r["stages"]["track"]
        rows.append(
            f"{label:>14s} {mode:8s} frame {r['wall_ms_per_frame_unprofiled_median']:8.3f} "
            f"ms (synced per stage {r['wall_ms_per_frame_stage_synced']:8.3f}), busy "
            f"{r['device_busy_ms_per_frame']:7.3f}, idle {r['device_idle_share']:.3f}, "
            f"{r['device_ops_per_frame']:7.0f} ops; track synced {track['synced_wall_ms']:8.3f}"
            f" ms, kernels {track['kernel_ms']:7.3f} ms, {r['track_ops_per_frame']:7.0f} ops")
    return "\n".join(rows)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--roots", nargs="+", default=["."],
                        help="checkout roots, run in this order")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "stage_profile.json"))
    args = parser.parse_args(argv)
    reports = []
    for k, root in enumerate(args.roots):
        rep = run_root(os.path.abspath(root))
        reports.append(rep)
        print(f"run {k}: {root} on {rep['device']}", flush=True)
        print(summary(os.path.basename(os.path.abspath(root)) or root, rep), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(reports, f, indent=1)


if __name__ == "__main__":
    main()
