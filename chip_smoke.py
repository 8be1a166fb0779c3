#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vulcan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as it runs:

  0. device: nvidia-smi name/power limit, compute capability;
     no CUDA device -> exit 1, no result printed;
  1. build: nvcc builds the CUDA kernels from csrc/ (build/ is the cache);
  2. kernels: each hand-written kernel against its plain PyTorch version
     on the card at the main path's shape (640x480), max abs error against
     the stated tolerance, and both timed with CUDA events;
  3. main path: Pipeline(Config(), tum_default(), 480, 640) in depth mode
     over the 35-frame synthetic orbit (uint16 depth / uint8 colour in),
     5 warm-up + 30 timed frames; the kernels must have launched once per
     frame, with zero overflows, zero track failures and ATE < 0.01 m;
  4. agreement: the same port on the card and on the CPU (plain kernel
     versions) over a small orbit must track the same trajectory;
  5. (only with --profile) where a steady frame's time goes: stage wall
     times with a device sync at each stage boundary, kernel time per stage
     and the top kernels from torch.profiler (the step's ``vulcan.<stage>``
     ranges), and the device's idle share; printed and written to
     chiprun_out/profile_stages.json.

Every failed phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# The bench orbit scene (bench.py make_scene): four spheres over a floor.
SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
    ((0.2, -0.5, 0.3), 0.2),
)
FLOOR = -0.6
N_WARM, N_TIMED = 5, 30
K1_TOL = 1e-5    # m: expf and the reduction's rounding differ by ulps
K2_TOL = 1e-6    # m: fill is min/max (exact); smoothing sums in one order
AGREE_TOL = 1e-3  # m: card vs CPU per-frame translation (float reassociation)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def time_cuda(fn, torch, reps: int = 25, warm: int = 5) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def make_frames(P, camera, poses, h, w, device):
    """Rendered on the device, handed over as raw sensor dtypes (uint16
    depth at 1/5000 m, uint8 colour) like bench.py's frame cache."""
    from vulcan_tpu_torch.io.synthetic import render_scene_depth

    frames = []
    for pose in poses:
        d, c = render_scene_depth(camera, pose, h, w, SPHERES, FLOOR, device=device)
        d16 = np.clip(d.cpu().numpy() * 5000.0, 0, 65535).astype(np.uint16)
        c8 = np.clip(c.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        frames.append((d16, c8))
    return frames


def run_pipeline(P, config, camera, poses, frames, h, w, device, sync):
    pipe = P.Pipeline(config, camera, h, w, init_pose=poses[0], device=device)
    est, ms = [], []
    for d16, c8 in frames:
        t0 = time.perf_counter()
        pipe.process(d16, c8)
        if sync:
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        est.append(pipe.pose.translation.cpu().numpy())
    return pipe, np.stack(est), ms


def profile_stages(P, torch, config, camera, poses, frames, dev, out_dir,
                   wall_ms):
    """Phase 5: where a steady frame's time goes, over 10 frames each of
    (a) stage wall times with a device sync at every stage boundary (no
    profiler), and (b) torch.profiler kernel times per stage range.
    ``wall_ms`` is phase 3's unprofiled median, the base of the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from vulcan_tpu_torch.ops import allocate, icp, sparse, splat
    from vulcan_tpu_torch.pipeline import fusion

    n_warm, n_run = 15, 10
    sync_ms: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sync_ms[name] = sync_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    stage_fns = [
        (fusion, "build_pyramid", "preprocess"), (icp, "model_pyramid", "track"),
        (icp, "track", "track"), (fusion, "_gate", "gate"),
        (allocate, "allocate_for_frame", "allocate"),
        (allocate, "update_visibility", "visibility"),
        (sparse, "integrate_sparse", "integrate"), (splat, "render_splat", "render"),
    ]
    pipe = P.Pipeline(config, camera, 480, 640, init_pose=poses[0], device=dev)
    for d16, c8 in frames[:n_warm]:
        pipe.process(d16, c8)
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in stage_fns]
    try:
        for mod, attr, name in stage_fns:
            setattr(mod, attr, timed(name, getattr(mod, attr)))
        t0 = time.perf_counter()
        for d16, c8 in frames[n_warm:n_warm + n_run]:
            pipe.process(d16, c8)
        torch.cuda.synchronize()
        synced_frame_ms = (time.perf_counter() - t0) * 1e3 / n_run
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)

    pipe = P.Pipeline(config, camera, 480, 640, init_pose=poses[0], device=dev)
    for d16, c8 in frames[:n_warm]:
        pipe.process(d16, c8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for d16, c8 in frames[n_warm:n_warm + n_run]:
            pipe.process(d16, c8)
            torch.cuda.synchronize()

    def dev_us(e, self_only):
        names = (("self_device_time_total", "self_cuda_time_total") if self_only
                 else ("device_time_total", "cuda_time_total"))
        for a in names:
            if hasattr(e, a):
                return float(getattr(e, a))
        return 0.0

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    # Host-side stage ranges carry their kernels' device time; the
    # device-side copies of the ranges (GPU annotations) are left out, so
    # no kernel counts twice.
    kernel_ms = {
        e.key[len("vulcan."):]: dev_us(e, False) / 1e3 / n_run
        for e in events if e.key.startswith("vulcan.") and e.device_type != cuda
    }
    kernels = sorted(
        ((e.key, dev_us(e, True) / 1e3 / n_run, e.count / n_run)
         for e in events
         if e.device_type == cuda and not e.key.startswith("vulcan.")
         and dev_us(e, True) > 0),
        key=lambda k: -k[1],
    )
    busy_ms = sum(k[1] for k in kernels)
    report = {
        "frames": n_run,
        "wall_ms_per_frame_unprofiled_median": wall_ms,
        "wall_ms_per_frame_stage_synced": synced_frame_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_frame": sum(k[2] for k in kernels),
        "stages": {
            name: {"synced_wall_ms": sync_ms.get(name, 0.0) / n_run,
                   "kernel_ms": kernel_ms.get(name, 0.0)}
            for name in dict.fromkeys(n for _, _, n in stage_fns)
        },
        "top_device_ops": [
            {"name": k[0][:160], "ms_per_frame": k[1], "calls_per_frame": k[2]}
            for k in kernels[:25]
        ],
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_stages.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"profile: wall {wall_ms:.3f} ms/frame unprofiled, "
          f"{synced_frame_ms:.3f} ms with stage syncs; device busy "
          f"{busy_ms:.3f} ms (idle share {report['device_idle_share']:.3f}); "
          f"{report['device_ops_per_frame']:.0f} device ops/frame", flush=True)
    for name, v in report["stages"].items():
        print(f"  {name:11s} synced wall {v['synced_wall_ms']:8.3f} ms  "
              f"kernels {v['kernel_ms']:7.3f} ms")
    for k in kernels[:12]:
        print(f"  {k[1]:7.3f} ms {k[2]:7.1f}x  {k[0][:90]}")


def main() -> None:
    want_profile = "--profile" in sys.argv[1:]
    phase("0 device")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    sys.path.insert(0, ROOT)
    try:
        import vulcan_tpu_torch as P
    except ImportError as e:
        fail(f"vulcan_tpu_torch not importable ({e}): run from a repo checkout")
    if not os.path.abspath(P.__file__).startswith(os.path.join(ROOT, "")):
        fail(f"vulcan_tpu_torch comes from {P.__file__}, not from this checkout")
    from vulcan_tpu_torch.ops import cuda_kernels, preprocess, splat
    from vulcan_tpu_torch.utils.evaluate import ate_rmse
    from vulcan_tpu_torch.utils.sync import read_int
    from vulcan_tpu_torch.io.synthetic import orbit_poses

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device {name} capability {torch.cuda.get_device_capability(0)} "
          f"count {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")

    phase("1 build")
    t0 = time.perf_counter()
    path = cuda_kernels.build()
    cuda_kernels.load()
    print(f"built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in cuda_kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    phase("2 kernels against plain versions (480x640)")
    cfg = P.Config()
    rng = np.random.default_rng(0)
    d1 = rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32)
    d1[rng.random((480, 640)) < 0.10] = 0.0
    d2 = rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32)
    d2[rng.random((480, 640)) < 0.25] = np.inf
    x1 = torch.from_numpy(d1).to(dev)
    x2 = torch.from_numpy(d2).to(dev)
    kernels = []
    for kname, src, replaces, wrapper, plain, x, tol in (
        ("bilateral", "vulcan_tpu_torch/csrc/bilateral.cu",
         "vulcan_tpu/ops/preprocess.py:116", preprocess.bilateral_filter,
         preprocess._bilateral_math, x1, K1_TOL),
        ("fill_smooth", "vulcan_tpu_torch/csrc/fill_smooth.cu",
         "vulcan_tpu/ops/splat.py:606", splat._fill_and_smooth,
         splat._fill_smooth_math, x2, K2_TOL),
    ):
        got = wrapper(x, cfg)
        want = plain(x, cfg)
        torch.cuda.synchronize()
        if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
            fail(f"{kname}: finite masks differ from the plain version")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        ms =time_cuda(lambda: wrapper(x, cfg), torch)
        plain_ms = time_cuda(lambda: plain(x, cfg), torch)
        print(f"{kname}: max_abs_err {err:.3e} (tol {tol:g}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms", flush=True)
        if not err <= tol:
            fail(f"{kname}: max abs error {err} above {tol}")
        kernels.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms))

    phase("3 main path: Pipeline.process, default Config, depth mode, 480x640")
    n = N_WARM + N_TIMED
    cam = P.PinholeCamera.tum_default()
    poses = orbit_poses(n, radius=1.6, height=0.35, span=min(6.28, n * 0.05))
    frames = make_frames(P, cam, poses, 480, 640, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preprocess.bilateral_filter.launches = 0
    splat._fill_and_smooth.launches = 0
    read_int.count = 0
    pipe, est, ms = run_pipeline(
        P, cfg, cam, poses, frames, 480, 640, dev, torch.cuda.synchronize
    )
    launches = {
        "bilateral": preprocess.bilateral_filter.launches,
        "fill_smooth": splat._fill_and_smooth.launches,
    }
    reads = read_int.count
    for k in kernels:
        k["launches"] = launches[k["name"]]
    gt = np.stack([p.translation.numpy() for p in poses])
    ate = ate_rmse(est, gt)
    diag = pipe.diagnostics()
    timed = np.asarray(ms[N_WARM:])
    depth = pipe.state.model.depth
    print(f"ms/frame median {np.median(timed):.3f} p90 {np.percentile(timed, 90):.3f} "
          f"(first frame {ms[0]:.1f} ms, warm-up {N_WARM}, timed {N_TIMED}, "
          "synchronized per frame)", flush=True)
    print(f"host reads/frame {reads / n:.2f}; kernel launches {launches}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    print("diagnostics", json.dumps(diag), flush=True)
    print(f"ATE {ate:.6f} m over {n} frames", flush=True)
    if launches["bilateral"] != n or launches["fill_smooth"] != n:
        fail(f"kernel launch counts {launches}, expected {n} each")
    if diag["alloc_overflow"] or diag["visible_overflow"]:
        fail("allocation or visibility overflow")
    if diag["track_failures"]:
        fail(f"{diag['track_failures']} track failures")
    if tuple(depth.shape) != (480, 640) or not bool(torch.isfinite(depth).all()):
        fail("model render is not a finite 480x640 image")
    if not float((depth > 0).float().mean()) > 0.3:
        fail("model render covers under 30% of the image")
    if not ate < 0.01:
        fail(f"ATE {ate} m not below 0.01 m")

    phase("4 card vs CPU agreement (port, 120x160, 6 frames)")
    small = P.Config(num_blocks=8192, hash_size=32768, max_visible=4096,
                     voxel_size=0.015, trunc_dist=0.06, depth_max=4.0)
    scam = P.PinholeCamera.create(130.0, 130.0, 79.5, 59.5)
    sposes = orbit_poses(6, radius=1.6, height=0.35, span=0.3)
    sframes = make_frames(P, scam, sposes, 120, 160, torch.device("cpu"))
    _, est_gpu, _ = run_pipeline(P, small, scam, sposes, sframes, 120, 160, dev,
                                 torch.cuda.synchronize)
    _, est_cpu, _ = run_pipeline(P, small, scam, sposes, sframes, 120, 160,
                                 torch.device("cpu"), None)
    diff = float(np.abs(est_gpu - est_cpu).max())
    print(f"max per-frame translation difference card vs CPU {diff:.3e} m "
          f"(tol {AGREE_TOL:g})", flush=True)
    if not diff <= AGREE_TOL:
        fail("the port on the card and on the CPU disagree")

    if want_profile:
        phase("5 profile (10 steady frames, torch.profiler)")
        profile_stages(P, torch, cfg, cam, poses, frames, dev,
                       os.path.join(ROOT, "chiprun_out"), float(np.median(timed)))

    if any(m == "jax" or m.startswith(("jax.", "vulcan_tpu.")) or m == "vulcan_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package was imported")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
