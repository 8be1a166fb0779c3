"""Command-line app of the port: dataset in, per-frame track + fuse +
render, timing, mesh out.  The counterpart of ``vulcan_tpu/cli.py``, with
its flags, defaults, exit codes and report keys, plus ``--device``.

Usage examples:
  vulcan-tpu-torch run --synthetic 100 --mesh-out scene.ply --verbose
  vulcan-tpu-torch run --dataset /data/rgbd_dataset_freiburg1_desk \\
      --mesh-out desk.ply --eval-ate --profile
  vulcan-tpu-torch run --dataset ... --known-poses   # fusion-only
  vulcan-tpu-torch run --synthetic 6 --preset tiny --width 160 \\
      --height 120 --voxel-size 0.02 --device cpu   # no card needed
  python -m vulcan_tpu_torch.cli ...                # the same entry point

Everything runs on ``--device`` (default: the CUDA card; without one the
run raises rather than moving to the CPU).  The loop reads nothing from
the device per frame beyond the step's own counted reads
(``utils.sync.read_int``): the estimated poses stay on the device and
are copied to the host once, after the last frame; only ``--verbose``
log frames read the diagnostics.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="vulcan-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run the online reconstruction pipeline")
    r.add_argument("--dataset", help="TUM RGB-D sequence directory")
    r.add_argument(
        "--synthetic",
        type=int,
        default=0,
        metavar="N",
        help="run N synthetic orbit frames instead of a dataset",
    )
    r.add_argument("--width", type=int, default=640)
    r.add_argument("--height", type=int, default=480)
    r.add_argument("--frames", type=int, default=0, help="frame limit (0=all)")
    r.add_argument("--preset", default="default",
                   choices=["default", "tiny"],
                   help="tiny = small capacities for CPU smoke runs")
    r.add_argument("--voxel-size", type=float, default=None)
    r.add_argument("--trunc", type=float, default=None)
    r.add_argument("--mode", default="combined",
                   choices=["depth", "color", "combined", "light"],
                   help="tracking mode (default: combined -- geometric + "
                        "photometric, the robust choice: depth-only ICP can "
                        "slide into a wrong basin on plane-dominated scenes "
                        "such as the cluttered desk at healthy conditioning "
                        "scores, a failure no online statistic flags.  "
                        "'depth' is the fastest mode, for well-conditioned "
                        "geometry")
    r.add_argument("--known-poses", action="store_true",
                   help="fusion-only with ground-truth poses")
    r.add_argument("--mesh-out", help="write final mesh PLY here")
    r.add_argument("--mesh-every", type=int, default=0, metavar="N",
                   help="extract a colored mesh every N frames during the "
                        "online run (BASELINE.json config 5; the periodic "
                        "extraction cost is part of the reported FPS). "
                        "The latest mesh replaces the previous one; with "
                        "--mesh-out the final mesh is written as usual. "
                        "Uses the INCREMENTAL per-block triangle cache "
                        "(only re-integrated blocks re-mesh).")
    r.add_argument("--mesh-full", action="store_true",
                   help="with --mesh-every: re-extract the FULL volume "
                        "each time instead of the incremental cache "
                        "(slower; for comparison/verification)")
    r.add_argument("--snapshot-out", help="write volume .npz snapshot here")
    r.add_argument("--resume", help="resume from a volume snapshot")
    r.add_argument("--eval-ate", action="store_true",
                   help="report ATE RMSE against ground truth")
    r.add_argument("--verbose", action="store_true")
    r.add_argument("--log-every", type=int, default=10)
    r.add_argument("--profile", action="store_true",
                   help="per-stage timing, the device synchronized at the "
                        "end of each stage")
    r.add_argument("--trace-dir",
                   help="write a torch.profiler chrome trace of frames 2-4 "
                        "into this directory (trace.json)")
    r.add_argument("--traj-out",
                   help="write the estimated trajectory here "
                        "(TUM format: ts tx ty tz qx qy qz qw)")
    r.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")

    m = sub.add_parser(
        "mesh", help="extract a mesh from a saved volume snapshot"
    )
    m.add_argument("snapshot", help="volume .npz written by --snapshot-out")
    m.add_argument("--out", required=True, help="output PLY path")
    m.add_argument("--preset", default="default",
                   choices=["default", "tiny"])
    m.add_argument("--voxel-size", type=float, default=None)
    m.add_argument("--trunc", type=float, default=None)
    m.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    return p


def _make_config(args):
    from .config import TINY, Config

    cfg = TINY if args.preset == "tiny" else Config()
    updates = {}
    if args.voxel_size:
        updates["voxel_size"] = args.voxel_size
    if args.trunc:
        updates["trunc_dist"] = args.trunc
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _synthetic_camera(args):
    from .core.camera import PinholeCamera

    w = args.width
    return PinholeCamera.create(0.8 * w, 0.8 * w, w / 2 - 0.5, args.height / 2 - 0.5)


def _synthetic_frames(args, device):
    """Orbit around a cluster of spheres + floor, rendered on ``device``;
    ground-truth poses on the CPU."""
    from .io.synthetic import orbit_poses, render_scene_depth

    h, w = args.height, args.width
    camera = _synthetic_camera(args)
    spheres = (
        ((0.0, 0.0, 0.0), 0.5),
        ((0.6, 0.3, 0.2), 0.25),
        ((-0.5, 0.4, -0.1), 0.3),
    )
    # ~3 deg/frame: realistic handheld-camera motion (a full-2pi orbit over
    # few frames would exceed any ICP convergence basin).
    span = min(2 * np.pi, args.synthetic * 0.05)
    poses = orbit_poses(args.synthetic, radius=1.6, height=0.35, span=span)
    for pose in poses:
        depth, color = render_scene_depth(camera, pose, h, w, spheres, -0.6,
                                          device=device)
        yield depth, color, pose


# --trace-dir's window: frames [TRACE_FIRST, TRACE_FIRST + TRACE_FRAMES).
# A 640x480 frame is ~14000 device operations; a whole run's chrome trace
# would be gigabytes.
TRACE_FIRST, TRACE_FRAMES = 2, 3


def _write_trace(prof, trace_dir: str) -> float:
    """Stop the profiler and write its trace; returns the seconds taken
    (kept off the FPS clock)."""
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return time.perf_counter() - t0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesher(config, device, full: bool):
    """``mesh_fn(state) -> (state, mesh)``: a full extraction, or the
    incremental per-block triangle cache (only the blocks integration
    dirtied since the last call re-mesh)."""
    from .ops import mcubes

    if full:
        def mesh_fn(state):
            return state, mcubes.extract_mesh(state.volume, config)
        return mesh_fn

    cache = mcubes.create_mesh_cache(config, device)

    def mesh_fn(state):
        nonlocal cache
        vol, cache = mcubes.update_mesh_cache(state.volume, cache, config)
        state = dataclasses.replace(state, volume=vol)
        return state, mcubes.cache_to_mesh(vol, cache, config)
    return mesh_fn


def cmd_run(args):
    import torch

    from .pipeline.api import Pipeline
    from .utils.device import resolve_device
    from .utils.runtime import prefetch_to_device
    from .utils.timing import StageTimer

    device = resolve_device(args.device)
    config = _make_config(args)

    frame_ts = None
    if args.synthetic:
        import itertools

        # Stream, don't materialize: long runs must not hold every frame.
        frame_iter = _synthetic_frames(args, device)
        first = next(frame_iter)
        frames = itertools.chain([first], frame_iter)
        camera = _synthetic_camera(args)
        h, w = args.height, args.width
    elif args.dataset:
        from .io.tum import TumDataset

        try:
            ds = TumDataset(args.dataset)
        except FileNotFoundError as e:
            print(
                f"error: not a TUM sequence directory "
                f"(missing {e.filename})",
                file=sys.stderr,
            )
            return 1
        camera = ds.camera
        frames = ds
        first = ds.load(0)
        h, w = first[0].shape
        # Real sensor timestamps: TUM evaluation tools associate estimate
        # vs groundtruth.txt by timestamp.
        frame_ts = [f.timestamp for f in ds.frames]
    else:
        print("need --dataset or --synthetic N", file=sys.stderr)
        return 2

    pipe = Pipeline(config, camera, h, w, init_pose=first[2], mode=args.mode,
                    device=device)
    if args.resume:
        from .pipeline.api import Volume

        vol = Volume(config, device=device)
        vol.load(args.resume)
        pipe.state = dataclasses.replace(pipe.state, volume=vol.state)

    # --profile times what each stage took (the device synchronized at its
    # end: one sync a frame); otherwise the timer only dispatches, as the
    # reference's does, and syncs nothing.
    timer = StageTimer(device if args.profile else None)
    poses, gt_traj = [], []     # gt_traj: (frame, ground-truth SE3 on the host)
    n_done = 0
    t_loop = None
    prof = None
    trace_s = 0.0
    last_mesh = None
    n_meshed = 0
    mesh_fn = _mesher(config, device, args.mesh_full) if args.mesh_every else None

    for i, (depth, color, gt_pose) in enumerate(
        prefetch_to_device(frames, device)
    ):
        if args.frames and i >= args.frames:
            break
        if args.trace_dir and i == TRACE_FIRST:  # past the first frames
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        elif prof is not None and i == TRACE_FIRST + TRACE_FRAMES:
            _sync(device)
            trace_s += _write_trace(prof, args.trace_dir)
            prof = None
        pose = gt_pose if (args.known_poses and gt_pose is not None) else None
        with timer.stage("step"):
            pipe.process(depth, color, pose=pose)
        if i == 0:
            _sync(device)
            if mesh_fn is not None:
                # The first extraction's one-time costs stay off the clock.
                pipe.state, _ = mesh_fn(pipe.state)
                _sync(device)
            t_loop = time.perf_counter()  # exclude the first frame from FPS
        n_done += 1
        if mesh_fn is not None and n_done % args.mesh_every == 0:
            pipe.state, last_mesh = mesh_fn(pipe.state)
            n_meshed += 1
        # Kept on the device: one copy to the host after the loop.
        poses.append(torch.cat([pipe.pose.rotation.reshape(9),
                                pipe.pose.translation]))
        if gt_pose is not None:
            gt_traj.append((len(poses) - 1, gt_pose))
        if args.verbose and i % args.log_every == 0:
            d = pipe.diagnostics()
            d["stage_ms"] = timer.last_ms
            print(json.dumps(d))

    _sync(device)
    if prof is not None:
        trace_s += _write_trace(prof, args.trace_dir)
    elapsed = time.perf_counter() - (t_loop or time.perf_counter()) - trace_s
    fps = (n_done - 1) / elapsed if n_done > 1 and elapsed > 0 else 0.0
    est = (torch.stack(poses).cpu().numpy() if poses
           else np.zeros((0, 12), np.float32))
    est_R, est_t = est[:, :9].reshape(-1, 3, 3), est[:, 9:]

    report = {"frames": n_done, "fps": round(fps, 2)}
    report.update(pipe.diagnostics())
    if mesh_fn is not None:
        report["mesh_extractions"] = n_meshed
        if last_mesh is not None:
            report["mesh_triangles_online"] = int(last_mesh.count)
    if args.eval_ate and len(gt_traj) > 2:
        from .utils.evaluate import ate_rmse

        report["ate_rmse_m"] = round(ate_rmse(
            est_t[[k for k, _ in gt_traj]],
            np.stack([g.translation.numpy() for _, g in gt_traj]),
        ), 5)
    if args.mesh_out:
        report["mesh_triangles"] = pipe.export_ply(args.mesh_out)
    if args.snapshot_out:
        from .pipeline.api import Volume

        vol = Volume(config, device=device)
        vol.state = pipe.state.volume
        vol.save(args.snapshot_out)
        report["snapshot"] = args.snapshot_out
    if args.traj_out:
        from .utils.evaluate import write_tum_trajectory

        stamps = frame_ts[:n_done] if frame_ts is not None else range(n_done)
        write_tum_trajectory(args.traj_out, stamps, est_R, est_t)
        report["trajectory"] = args.traj_out
    if args.profile:
        report["stage_ms"] = timer.summary()
    print(json.dumps(report))
    return 0


def cmd_mesh(args):
    from .pipeline.api import Extractor, Volume

    config = _make_config(args)
    vol = Volume(config, device=args.device)
    try:
        vol.load(args.snapshot)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: cannot load snapshot: {e}", file=sys.stderr)
        return 1
    n = Extractor(vol).export_ply(args.out)
    print(json.dumps({
        "snapshot": args.snapshot,
        "allocated_blocks": vol.num_allocated,
        "mesh_triangles": n,
        "mesh": args.out,
    }))
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "mesh":
        return cmd_mesh(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
