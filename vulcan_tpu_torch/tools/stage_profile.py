"""Where a frame's time goes, for one checkout or several compared in turns.

    python -m vulcan_tpu_torch.tools.stage_profile [--roots DIR ...]
        [--cells CELL ...] [--out chiprun_out/stage_profile.json]

For each checkout root, in the order given (e.g. a parent's tree unpacked
under ``build/``, then this one, this one, the parent: two versions
compared on one card in turns), a fresh process run from that root uses
that checkout's own ``chip_smoke.py`` and ``vulcan_tpu_torch``:

  * the cells orbit/depth, orbit/combined, orbit/depth armed
    (``auto_photo_enter=0.99``) and desk/combined (245 frames) through
    ``Pipeline`` as a user calls it (a captured graph where the checkout
    captures one): ms a frame synchronized per frame, median and p90 over
    the frames after the 5 warm-up ones and before the last 10; the host
    reads a frame over those frames; the last 10 frames under
    torch.profiler for the device's busy ms (the union of the kernels',
    copies' and fills' intervals: this tool's own ``timing.busy_ms`` in
    every root) and operations a frame, and the idle share (1 - busy /
    median ms), with each counted kernel's launches a frame on the card
    over those frames (the root's ``chip_smoke.launch_counts``, its
    conditional nodes' set kernels and iterations among them) and in the
    trace (by the root's ``chip_smoke.KERNEL_NAMES``): a busy reading above
    the median frame, or from a trace that holds fewer of a counted
    kernel than the card launched (CUPTI drops the kernels of conditional
    bodies in some processes), is discarded; the graph's capture ms and
    memory pool MiB (``Pipeline.graph_stats``);

and, on the 35-frame 480x640 orbit in depth and in combined mode, through
the eager step:

  * ``chip_smoke.profile_stages``: stage wall times with a device sync at
    each stage boundary, kernel ms a stage and the device's busy ms, idle
    share and operations a frame (torch.profiler);
  * the track stage's device operations a frame (``icp.model_pyramid`` and
    ``icp.track`` each run under a profiler of its own for 5 steady frames:
    the CUDA kernels, copies and fills they launch);

and the track's kernels at every level in depth and combined mode, on
chip_smoke phase 2's inputs, through the checkout's own entry points
(``timing.device_and_host``): H1a, H1b, H1c (a step and the scores) and,
where the checkout has it, the fused step ``icp_rows_solve``; a level's
whole launch sequence at the default ``Config`` (its association rounds,
each followed by its GN steps, each step's pose read by the next launch,
then the level score: the fused step, or H1b + H1c) between CUDA events,
and their sum, H1's device ms a frame; the solve's outputs (H1c's step
and scores on the plain sums, and the checkout's step and scores from
the rows), compared bit for bit with the first root's.

Beside each root, the registers, stack and spills of every function of
its ``csrc/icp.cu`` (``nvcc -Xptxas -v``, built here for the purpose).

``--cells`` profiles the cells it names, in that order, in each root's
process, and nothing else: no eager step, track kernels or registers.
It also takes the render settings off the default, through ``Pipeline``
like the rest (a checkout that runs them eagerly is measured eagerly):
orbit/march and orbit/march-combined (``render_mode="march"`` in depth
and combined mode), orbit/direct (``splat_source="direct"``) and
orbit/polish (``splat_polish=2``).  The first cell a process profiles
can be misread (CUPTI), so name a throwaway cell first.

Prints a table and writes every run's report as JSON.  Needs the card; a
root without ``chip_smoke.py`` or the package raises.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile

from . import timing

# Run inside each root's own process (cwd = the root), after this tool's own
# busy-time helpers (``_helpers``), with which every root is measured.
_CHILD = r'''
import json, os, statistics, sys, time
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


def track_ops(mode, n_warm=15, n_run=5):
    ops, ms = [], []
    pipe = eager(P.Config(), cam, 480, 640, init_pose=poses[0], mode=mode, device=dev)
    for d16, c8 in frames[:n_warm]:
        pipe.process(d16, c8)
    originals = {name: getattr(icp, name) for name in ("model_pyramid", "track")}

    def profiled(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            spans = device_spans(prof)
            ops.append(len(spans))
            ms.append(busy_ms(spans))
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


def cell(config, mode, cell_poses, cell_frames, k_profile=10):
    from vulcan_tpu_torch.utils.sync import read_int

    n = len(cell_frames)
    pipe = P.Pipeline(config, cam, 480, 640, init_pose=cell_poses[0], mode=mode, device=dev)
    ms, reads, armed = [], [], 0
    for d16, c8 in cell_frames[:n - k_profile]:
        armed += int(pipe.state.photo_cnt) > 0
        r0 = read_int.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process(d16, c8)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(read_int.count - r0)
    torch.cuda.synchronize()
    before = cs.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for d16, c8 in cell_frames[n - k_profile:]:
            pipe.process(d16, c8)
            torch.cuda.synchronize()
    after = cs.launch_counts()
    spans = device_spans(prof)
    timed = ms[cs.N_WARM:]
    busy = busy_ms(spans) / k_profile
    med = statistics.median(timed)
    card = {k: (after[k] - before[k]) / k_profile for k in after}
    traced = {k: sum(pat in s[0] for s in spans) / k_profile
              for k, pat in cs.KERNEL_NAMES.items()}
    complete = all(traced[k] >= v for k, v in card.items() if k in traced)
    valid = complete and busy <= med
    return dict(ms_median=med, ms_p90=statistics.quantiles(timed, n=10)[-1],
                host_reads_per_frame=sum(reads[cs.N_WARM:]) / len(timed),
                device_busy_ms=busy if valid else None, device_busy_ms_read=busy,
                idle_share=1.0 - busy / med if valid else None,
                device_ops_per_frame=len(spans) / k_profile,
                armed_frames=armed, captured=getattr(pipe, "captured", False),
                graph=getattr(pipe, "graph_stats", {}), launches_per_frame=card,
                traced_launches_per_frame=traced, trace_complete=complete)


def h1_ms():
    """The track's kernels at every level, depth and combined mode: the
    orbit's first frame fused at its pose is the model, its own pyramid
    the live side at a pose moved 2 cm and 1 degree (chip_smoke phase 2's
    inputs), through the checkout's own entry points.  Each kernel's
    device ms; the level's launch sequence at the default Config; the
    solve's outputs as exact hex strings."""
    from vulcan_tpu_torch.core.frame import Frame
    from vulcan_tpu_torch.core.se3 import SE3
    from vulcan_tpu_torch.ops import preprocess
    from vulcan_tpu_torch.pipeline import fusion
    from vulcan_tpu_torch.tools.timing import device_and_host

    cfg = P.Config()
    d, c = (torch.from_numpy(x).to(dev) for x in frames[0])
    state = fusion.step_known_pose(fusion.init_state(cfg, cam, 480, 640, poses[0], dev),
                                   d, c, poses[0].to(dev), cfg)
    depth, color = fusion._to_metric(d, c, cfg)
    live = preprocess.build_pyramid(Frame(depth, color, cam, poses[0]), cfg)
    model = icp.model_pyramid(state.model, cfg.pyramid_levels,
                              flat_thresh=max(0.05, 6.0 * cfg.voxel_size))
    moved = SE3.exp(torch.tensor([0.0, 0.0174533, 0.0, 0.02, 0.0, 0.0], device=dev))
    pv = icp._pose_vector(moved @ poses[0].to(dev))
    fused = getattr(icp, "icp_rows_solve", None)

    def step(lv, pose, corr, samples, photo, detect=False):
        if fused is not None:
            return fused(lv, pose, corr, samples, cfg, True, photo, detect)[1]
        sums = icp.icp_rows(lv, pose, corr, samples, cfg, True, photo, live_normals=detect)
        return icp.icp_solve(sums, pose, cfg, True, photo, detect)

    def hexes(x):
        return [float(v).hex() for v in x.tolist()]

    out, solve = {}, {}
    for mode in ("depth", "combined"):
        for level in range(cfg.pyramid_levels):
            photo = icp._photo_here(mode, level, cfg)
            lv = icp.level_inputs(live[level], model[level], icp._level_strides(cfg)[level],
                                  icp.LOCAL, photo)
            corr, samples = icp._associate_plain(lv, pv, cfg, True, photo)
            sums = icp._rows_plain(lv, pv, corr, samples, cfg, True, photo)
            det_sums = icp._rows_plain(lv, pv, corr, samples, cfg, True, photo, True)
            iters = cfg.icp_iters[level]
            rounds = max(1, min(cfg.icp_assoc[level], iters))
            inner = -(-iters // rounds)

            def sequence(lv=lv, photo=photo, rounds=rounds, inner=inner):
                pose = pv
                for _ in range(rounds):
                    c_, s_ = icp.icp_associate(lv, pose, cfg, True, photo)
                    for _ in range(inner):
                        pose = step(lv, pose, c_, s_, photo)
                return step(lv, pose, c_, s_, photo, True)

            def dah(fn):
                return device_and_host(fn)[0]

            key = f"{mode}/level {level}"
            out[key] = dict(
                live=list(lv.depth.shape), rounds=rounds, steps=rounds * inner,
                associate=dah(lambda: icp.icp_associate(lv, pv, cfg, True, photo)),
                rows=dah(lambda: icp.icp_rows(lv, pv, corr, samples, cfg, True, photo)),
                solve=dah(lambda: icp.icp_solve(sums, pv, cfg, True, photo)),
                solve_scores=dah(lambda: icp.icp_solve(det_sums, pv, cfg, True, photo, True)),
                fused=dah(lambda: fused(lv, pv, corr, samples, cfg, True, photo))
                if fused else None,
                fused_scores=dah(lambda: fused(lv, pv, corr, samples, cfg, True, photo, True))
                if fused else None,
                sequence=device_and_host(sequence, reps=20)[0])
            solve[key] = dict(
                h1c_step=hexes(icp.icp_solve(sums, pv, cfg, True, photo)),
                h1c_scores=hexes(icp.icp_solve(det_sums, pv, cfg, True, photo, True)),
                step=hexes(step(lv, pv, corr, samples, photo)),
                scores=hexes(step(lv, pv, corr, samples, photo, True)))
    frame = {mode: sum(v["sequence"] for k, v in out.items() if k.startswith(mode))
             for mode in ("depth", "combined")}
    return dict(by_level=out, frame_ms=frame, fused=fused is not None), solve


def desk():
    desk_poses = orbit_poses(245, center=(0.0, 0.0, -0.25), radius=1.5, height=0.55,
                             span=2.0 * 3.141592653589793)
    return cell(P.Config(), "combined", desk_poses,
                cs.make_desk_frames(P, cam, desk_poses, 480, 640, dev))


cells = {
    "orbit/depth": lambda: cell(P.Config(), "depth", poses, frames),
    "orbit/combined": lambda: cell(P.Config(), "combined", poses, frames),
    "orbit/depth armed": lambda: cell(P.Config(auto_photo_enter=0.99), "depth", poses, frames),
    "desk/combined": desk,
    "orbit/march": lambda: cell(P.Config(render_mode="march"), "depth", poses, frames),
    "orbit/march-combined": lambda: cell(P.Config(render_mode="march"), "combined", poses,
                                         frames),
    "orbit/direct": lambda: cell(P.Config(splat_source="direct"), "depth", poses, frames),
    "orbit/polish": lambda: cell(P.Config(splat_polish=2), "depth", poses, frames),
}
# The render settings off the default run with --cells only.
only = sys.argv[1:] or [name for name in cells if name not in RENDER_CELLS]
out = {"device": cs.nvidia_smi(), "root": os.getcwd(),
       "cells": {name: cells[name]() for name in only}}
if sys.argv[1:]:
    print("STAGE_PROFILE " + json.dumps(out), flush=True)
    raise SystemExit(0)
out["h1"], out["solve_outputs"] = h1_ms()
eager = getattr(cs, "eager_pipeline", lambda P: P.Pipeline)(P)
for mode in ("depth", "combined"):
    res = cs.run_pipeline(P, P.Config(), cam, poses, frames, 480, 640, dev,
                          torch.cuda.synchronize, mode, **(
                              {"eager": True} if eager is not P.Pipeline else {}))
    wall = statistics.median(res[2][cs.N_WARM:])
    rep = cs.profile_stages(P, torch, P.Config(), cam, poses, frames, dev, wall, mode)
    rep["track_ops_per_frame"], rep["track_kernel_ms_alone"] = track_ops(mode)
    out[mode] = rep
print("STAGE_PROFILE " + json.dumps(out), flush=True)
'''


CELLS = ("orbit/depth", "orbit/combined", "orbit/depth armed", "desk/combined")
# The render settings off the default (``--cells`` only): the march in depth
# and combined mode, the direct and the polished splat, in depth mode.
RENDER_CELLS = ("orbit/march", "orbit/march-combined", "orbit/direct", "orbit/polish")


def _helpers() -> str:
    return "\n".join(["import torch", f"DEVICE_WORK = {timing.DEVICE_WORK!r}",
                      f"RENDER_CELLS = {RENDER_CELLS!r}",
                      inspect.getsource(timing._device_work),
                      inspect.getsource(timing.device_spans),
                      inspect.getsource(timing.busy_ms)])


def ptxas_report(root: str) -> dict:
    """{function: registers, stack frame, spill stores and loads} of every
    function in ``root``'s ``csrc/icp.cu``, from ``nvcc -Xptxas -v`` with
    the build's flags (an object file thrown away)."""
    from ..ops import cuda_kernels

    src = os.path.join(root, "vulcan_tpu_torch", "csrc", "icp.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-I", os.path.dirname(src),
             "-c", "-o", os.path.join(tmp, "icp.o"), src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    out, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = _demangle(m.group(1))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _demangle(name: str) -> str:
    """A mangled name made readable with ``c++filt`` where the machine has
    it (as is otherwise)."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              check=True).stdout.strip() or name
    except (OSError, subprocess.CalledProcessError):
        return name


def compare_solves(first: dict, other: dict) -> dict:
    """Each solve output of ``other`` against ``first``'s: entries that
    differ, and the largest difference."""
    out = {}
    for key, outputs in first.items():
        for what, want in outputs.items():
            got = other[key][what]
            diffs = [abs(float.fromhex(a) - float.fromhex(b))
                     for a, b in zip(got, want) if a != b]
            out[f"{key} {what}"] = dict(differ=len(diffs), max_abs=max(diffs, default=0.0))
    return out


def run_root(root: str, cells=()) -> dict:
    """One root's report (its own process, cwd = the root); with ``cells``,
    those cells alone, in that order."""
    proc = subprocess.run([sys.executable, "-c", _helpers() + _CHILD, *cells], cwd=root,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    for line in proc.stdout.splitlines():
        if line.startswith("STAGE_PROFILE "):
            return json.loads(line[len("STAGE_PROFILE "):])
    raise RuntimeError(f"stage_profile: {root} gave no report (exit {proc.returncode}):\n"
                       f"{proc.stdout[-4000:]}")


def _ms(x) -> str:
    return "discarded" if x is None else f"{x:7.3f}"


def _node_launches(cell: dict) -> dict:
    """A cell's launches a frame of the conditional nodes' kernels (the
    counters named ``graph_*``, whatever the root's design)."""
    return {k: v for k, v in cell.get("launches_per_frame", {}).items()
            if k.startswith("graph")}


def summary(label: str, rep: dict) -> str:
    rows = []
    for name, c in rep["cells"].items():
        rows.append(
            f"{label:>14s} {name:18s} {'graph' if c['captured'] else 'eager'} frame "
            f"{c['ms_median']:8.3f} ms (p90 {c['ms_p90']:8.3f}), busy "
            f"{_ms(c['device_busy_ms'])} (read {c['device_busy_ms_read']:.3f}, trace "
            f"complete {c.get('trace_complete')}), idle {_ms(c['idle_share'])}, "
            f"{c['device_ops_per_frame']:7.0f} ops, reads {c['host_reads_per_frame']:.2f}, "
            f"armed {c['armed_frames']}, graph {c['graph']}, conditional-node kernels a "
            f"frame {_node_launches(c)}")
    if "h1" not in rep:
        return "\n".join(rows)
    for mode in ("depth", "combined"):
        r = rep[mode]
        track = r["stages"]["track"]
        rows.append(
            f"{label:>14s} {mode:8s} eager frame {r['wall_ms_per_frame_unprofiled_median']:8.3f} "
            f"ms (synced per stage {r['wall_ms_per_frame_stage_synced']:8.3f}), busy "
            f"{_ms(r['device_busy_ms_per_frame'])}, idle {_ms(r['device_idle_share'])}, "
            f"{r['device_ops_per_frame']:7.0f} ops; track synced {track['synced_wall_ms']:8.3f}"
            f" ms, kernels {track['kernel_ms']:7.3f} ms, {r['track_ops_per_frame']:7.0f} ops")
    h1 = rep["h1"]
    for key, v in h1["by_level"].items():
        fused = ("" if v["fused"] is None else
                 f", fused step {v['fused']:.6f} / scores {v['fused_scores']:.6f}")
        rows.append(
            f"{label:>14s} {key:17s} {v['live'][0]}x{v['live'][1]}: H1a {v['associate']:.6f}, "
            f"H1b {v['rows']:.6f}, H1c step {v['solve']:.6f} / scores "
            f"{v['solve_scores']:.6f}{fused} ms; the level's {v['rounds']} rounds, "
            f"{v['steps']} steps and score {v['sequence']:.6f} ms")
    rows.append(f"{label:>14s} H1 device ms a frame: " + ", ".join(
        f"{k} {v:.6f}" for k, v in h1["frame_ms"].items())
        + f" ({'fused step' if h1['fused'] else 'H1b + H1c'})")
    for fn, r in rep["registers"].items():
        if any(k in fn for k in ("kernel", "gn_solve")):
            rows.append(f"{label:>14s} {fn[:90]}: {r.get('registers')} registers, stack "
                        f"{r.get('stack')}, spills {r.get('spill_stores')} / "
                        f"{r.get('spill_loads')} B")
    return "\n".join(rows)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--roots", nargs="+", default=["."],
                        help="checkout roots, run in this order")
    parser.add_argument("--cells", nargs="+", default=[], choices=CELLS + RENDER_CELLS,
                        help="profile these cells alone, in this order, and nothing else")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "stage_profile.json"))
    args = parser.parse_args(argv)
    reports = []
    for k, root in enumerate(args.roots):
        rep = run_root(os.path.abspath(root), args.cells)
        if not args.cells:
            rep["registers"] = ptxas_report(os.path.abspath(root))
        if reports and not args.cells:
            rep["solve_vs_run_0"] = compare_solves(reports[0]["solve_outputs"],
                                                   rep["solve_outputs"])
        reports.append(rep)
        print(f"run {k}: {root} on {rep['device']}", flush=True)
        print(summary(os.path.basename(os.path.abspath(root)) or root, rep), flush=True)
        if "solve_vs_run_0" in rep:
            print(f"run {k} against run 0, the solve's outputs: " + ", ".join(
                f"{key} {v['differ']} differ (max {v['max_abs']:.3e})"
                for key, v in rep["solve_vs_run_0"].items()), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(reports, f, indent=1)


if __name__ == "__main__":
    main()
