#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vulcan_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parity]

Run from the root of a checkout.  Phases, each printed as it runs:

  0. device: nvidia-smi name/power limit, compute capability;
     no CUDA device -> exit 1, no result printed;
  1. build: nvcc builds the CUDA kernels from csrc/ (build/ is the cache);
  2. kernels: each main-path kernel (K1, K2) against its plain PyTorch
     version on the card at the main path's shape (640x480), max abs error
     against the stated tolerance; its "kernel ms" (device time: 50
     back-to-back calls queued behind a spin kernel, between two CUDA
     events) and "host us" (the host clock around the same queued calls:
     the host's part of one call), both from
     ``vulcan_tpu_torch.tools.timing.device_and_host``; its kernel launches
     per call; its "call ms" (``timing.call_ms``: one wrapper call between
     two CUDA events, host work included; the kernels line's ``ms``, as in
     the first slice), the plain version's ms and the least time the card
     could take (bound ms, from bytes and operations).  Then K1 on the
     orbit's first frame (uint16 depth converted as the step converts it),
     at 121x161 (its word-by-word staging) and at radius 0, 1 and 3, each
     against its plain version; K2 at fill rounds 0, 1, 2 and 5 (5 is two
     launches) at 480x640 and 121x161 against its plain version, with its
     launches per call, and the device time a launch of an empty kernel
     takes (the launch floor).  Then the track's kernels H1a-H1c and the
     fused step (``csrc/icp.cu``; ``track_kernels``): the orbit's first
     frame fused at its true pose is the model and its own pyramid the
     live side; at the true pose and at one moved 2 cm and 1 degree, in
     depth, color and combined mode, at every level, H1a against
     ``_associate_plain`` (validity masks and correspondences bit-equal,
     samples within 1e-5), H1b against ``_rows_plain`` (step and detector
     rows: H, b and the error of each term within 1e-5 of the block's
     largest sum of magnitudes, counts equal), H1c against
     ``_solve_plain`` (rtol 1e-4, atol 1e-6), the fused step
     ``icp_rows_solve`` (a GN step and the level scores) against
     ``_solve_plain(_rows_plain(...))`` (its sums as H1b's, its pose as
     H1c's) and its pose bit-equal to H1c's on its own sums, and H1a
     launched right behind the fused step whose pose it reads (bit-equal
     to ``_associate_plain`` at that pose); each twice and bit-identical
     (OUT_DIR/track_kernels.json), and each timed like K1 at the
     finest level in depth mode (H1b and the fused step: one
     thread-block cluster of 16 CTAs, ``cluster_ctas``).  Then the
     conditional nodes' kernels (``graph_node_kernels``): WHILE and IF/ELSE
     nodes nested 3 deep against the eager form, their iterations and
     nodes counted on the card, and their own costs (a WHILE node of 1, 8
     and 32 iterations against as many IF nodes, an IF/ELSE node against
     two IF nodes, an empty kernel node the floor).  Then R1, the march's
     range image (``csrc/range_image.cu``; ``range_image_kernel``): the
     orbit's first R1_FRAMES frames fused at their true poses under
     Config(render_mode="march"), the stamps and upsample at the last pose
     bit for bit against the plain version, timed like K1, its library
     yardstick the plain version's three ``scatter_reduce_`` calls.  Then
     I1, the integrate layer (``csrc/integrate.cu``; ``integrate_kernel``):
     under each benchmark configuration, the next frame's band list after
     I1_FRAMES frames fused at their true poses, one launch bit for bit
     against the plain chunk loop on all seven outputs, timed like K1 beside
     the plain version, the band's length printed.  Then S1, the surfel
     splat's z-buffer (``csrc/splat_zbuf.cu``; ``splat_zbuf_kernel``): the
     desk's first S1_FRAMES frames fused at their true poses under
     Config(), the visible list at the next pose splatted in the depth,
     luma and rgb modes bit for bit against the plain tiers (one launch a
     call, two in rgb), the luma mode timed like K1 beside the plain
     version;
  3. main path: Pipeline(Config(), tum_default(), 480, 640) in depth mode
     over the 35-frame synthetic orbit (uint16 depth / uint8 colour in),
     5 warm-up + 30 timed frames.  The pipeline runs its first two frames
     eagerly and then replays a captured CUDA graph
     (``vulcan_tpu_torch/pipeline/graphs.py``).  Every counted kernel adds
     one to its own counter on the card at each launch, eager or replayed
     (``cuda_kernels.launch_counts``; a capture launches nothing), read
     after each frame: ``check_graph_run`` holds that the pipeline ran as
     a graph (its replays are the frames after the warm-up), that no
     replayed frame read on the host, and that every replayed frame
     launched K1 and K2
     once, H1a 12 times, the fused step 29 (H1b and H1c alone 0) and I1
     and S1 once (``want_per_frame``), no WHILE node and auto-photo's 2 IF/ELSE nodes
     (``want_nodes``); the run's
     counts are the kernels line's ``launches`` and a replayed frame's its
     ``launches_per_replayed_frame``; zero overflows, zero track failures
     and ATE < 0.01 m; then the same run with the track's entry points on
     their plain versions on the card (``plain_track``): ATE within 1e-4 m;
  3b. the photometric paths at 480x640, each run with the counts set to 0
     just before it: (a) the orbit in mode="combined" under the default
     Config; (b) the orbit in depth mode with auto_photo_enter=0.99, which
     must arm the combined-mode rescue; (c) the 245-frame desk orbit in
     mode="combined".  Each prints ms/frame median and p90, ATE, armed
     frames, host reads a frame and the K1/K2/track launches, and fails
     unless ``check_graph_run`` holds (an eager path: ``check_eager_run``,
     K1 and K2 once and the track's as ``track_launches`` every frame, on
     the card), nothing overflowed, every pose is finite and ATE < 0.01 m on
     (a) and (b), < 0.1 m on (c).  With --parity also the desk in
     mode="light" and in depth mode under the default Config (armed frames
     and ATE, recorded, not judged);
  3c. the captured graph against the eager step (``graph_against_eager``),
     each cell with the counts set to 0 just before it: the orbit in depth
     and combined mode, armed (auto_photo_enter=0.99), in color mode and at
     known poses, the desk in combined mode (with --parity also light and
     depth mode), and the render settings off the default: the orbit under
     render_mode="march" in depth and combined mode (K2 0 a frame), with
     splat_source="direct" and with splat_polish=2.  The eager
     step runs twice (whether it repeats bit for bit), then ``Pipeline``:
     poses a frame and every array of the final state must equal the
     eager ones wherever the eager runs agree (GRAPH_TOL); the replayed
     frames read nothing; every frame of each run launches exactly K1 and
     K2 once, H1a 12 times and the fused step 29 on the card, and every
     replayed frame as many WHILE iterations as the eager run took
     chunk-loop bodies on that frame and as many IF/ELSE nodes as its
     ``cond``s; the ATE of each run; the graph's capture ms and memory
     pool MiB.  Written to OUT_DIR/graph.json;
  4. agreement: the same port on the card and on the CPU (plain kernel
     versions) over a small orbit must track the same trajectory, in depth
     and in combined mode;
  6. probes: T5 at (479, 641), (2, 6) and (1, 1) in int32 and float32,
     bit for bit against its plain version; T5's host us per call step by
     step (``bench_subsample.host_breakdown``: the launch path's earlier
     and trimmed forms beside ``x[::2, ::2].contiguous()``); the kernels
     of the probe entry points (T1 fused fill+smooth, T2-T4 chained
     gather, T5 stride-2 subsample) against their plain versions at the
     tools' own shapes (T2-T5 exact, T1 within 1e-6 m of the plain version
     and of K2), timed like phase 2 (T5 also against its one-call library
     form: call ms, kernel ms and host us).  T2/T3 (the smem path) bit for
     bit at ragged heights, widths of 16 to 128 columns, short tables, 0, 1
     and 32 rounds, under every variant of its plan and on a table whose
     sums hit the most negative int; T4 twice, on its own path (two whole
     columns of the table in a block's shared memory) and forced through
     L2, then at ragged heights and a 16-column width; the variant tables
     of both paths (``bench_gather.variant_times``: columns and copies a
     block, blocks alone and thread-block clusters, each exact) and T2/T3
     by round count (``bench_gather.round_costs``), with the instructions a
     lookup and a shuffle from the machine code (``tools/sass.py``); T1 at
     0-4 rounds at 480x640 and at 121x161 and 479x641 against the plain
     version and K2; K2 and T1 one launch per round count
     (``bench_stencil.launch_costs``) and T1 by strip height
     (``bench_stencil.strip_times``); then the three probe entry points
     (``vulcan_tpu_torch.tools.bench_*.run``) with every probe count set to
     0, each kernel of them launched at least once;
  7. mesh and API at 640x480 under the default Config: (a) extract_mesh of
     phase 3's volume (its ms, the median of 3 between CUDA events, and its
     host reads), equal to the port's plain path on a CPU copy (counts
     exact, positions and colours within 1e-5); (b) the orbit again with
     mesh_dirty_eps=0 and 512 cache slots a block, update_mesh_cache +
     cache_to_mesh every 5 frames and after the last (dirty blocks, ms and
     reads of each, the triangles over the default 256 slots), the last
     decode equal to a full extraction within the cache's quantization,
     K1/K2 once a frame and 2 host reads a frame in the step; (c)
     export_ply read back face for face,
     a v4 snapshot saved from the card and loaded on the CPU (every array
     equal), both traced at one pose within the splat tolerances; (d) the
     five-class flow (Volume, Integrator, Tracer, DepthTracker, Extractor)
     over 10 frames: ATE < 0.01 m, a mesh, K1 once a track and K2 once a
     trace, on the card.  Written to chiprun_out/mesh.json;
  8. render paths at 640x480, each orbit run with the counts set to 0 just
     before it, through the replayed graph (``check_graph_run``: no host
     read a replayed frame, the WHILE and IF/ELSE nodes of ``want_nodes``
     counted on the card): (a) the orbit under render_mode="march" in
     depth and in combined mode, K1 once a frame and K2 never (the march
     has no fill/smooth step); (b) the orbit in depth mode with
     splat_source="direct" and with splat_polish=2, K1 and K2 once a
     frame; each prints ms/frame median and p90, ATE, host reads a frame,
     the graph's capture ms and memory pool MiB, and fails on ATE >= 0.01
     m, a track failure or an overflow; (c)
     Tracer.trace of phase 3's final volume under the march (cross and
     gradient normals) and the splat with gradient normals, each against
     the same call on a CPU copy of the volume (the tests' tolerances),
     and the direct z-buffer against the surfel one on the orbit's first
     10 frames fused with 512 surfel slots (equal hit masks, depths within
     the surfels' 14-bit tsdf step; on phase 3's volume, whose default 192
     slots overflow in some blocks, recorded only); (d) the dense backend at BASELINE config 2's 256^3 over
     the orbit's frames at their true poses: integrate ms and 640x480
     raycast ms (CUDA events), valid pixels, the share of the pixels whose
     true surface lies in the grid that it hits (fails under 90%) and the
     depth error against the true depth.  Written to OUT_DIR/render.json;
  9. entry points at 640x480, each a subprocess of the CLI's ``main``
     (``python -m vulcan_tpu_torch.tools.cli_counts``, which counts around
     the loop: the step's host reads, the reads and syncs the CLI's own
     code makes between two steps, K1/K2 launches, the time it waits on
     the TUM loader).  Phase 3's frames are written as a TUM sequence
     (``write_png``: standard-library zlib).  (a) Three runs at once on
     the card (their times are not measurements): ``run --synthetic 35
     --mesh-every 5`` with --mesh-out, --snapshot-out, --traj-out,
     --eval-ate, --profile and --trace-dir in combined (the default) and
     depth mode, and ``run --dataset --known-poses`` (ATE < 1e-4 m); then
     ``python -m vulcan_tpu_torch.cli mesh`` on the combined snapshot.
     (b) Alone, timed: the native decode and the prefetch loader, the same
     frames through ``Pipeline`` in memory, and ``run --dataset`` tracked
     (its trajectory against the in-memory run's, within AGREE_TOL).  Each
     run: exit 0, no failure or overflow, ATE < 0.01 m, K1 and K2 once a
     frame, the step's host reads a frame and none added by the loop, a
     PLY header from the native welder;
  10. the row-sharded step (``parallel/sharding.py``): 2 gloo ranks on the
     one card over the orbit's first 10 frames, default Config, against
     the single-process step (tests/test_parallel.py's tolerances), every
     rank's pose bit-identical, each rank's track on H1a, H1b and H1c (12
     / 29 / 29 a frame; no fused step: the ranks' sums are added between
     rows and solve).  Phases 9-10 write OUT_DIR/entry.json.

Every failed phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
K1_TOL = 1e-5    # m: ex2.approx, the folded exponent, the reduction's order
K2_TOL = 1e-6    # m: fill is min/max (exact); smoothing sums in one order
AGREE_TOL = 1e-3  # m: card vs CPU per-frame translation (float reassociation)
PLAIN_ATE_TOL = 1e-4  # m: orbit ATE through the track's kernels vs their plain versions
DESK_ATE = 0.1    # m: the desk's wrong-basin slide, which combined tracking
                  # prevents, is 0.73 m; the reference holds 0.02162 m
OUT_DIR = os.path.join(ROOT, "chiprun_out")


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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger, and which it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(spec: dict, torch) -> dict:
    """Hold one kernel against its plain version (and any other reference
    in ``spec["also"]``) on the card, time it and compute its bound; fail
    on a disagreement.  Returns the kernel's entry of the kernels line:
    ``ms`` is the call ms, as in the first slice's line, beside
    ``kernel_ms`` (device time), ``call_ms``, ``host_us`` (the host's part
    of one call) and ``launches_per_call`` (``spec["count"]``, the kernel's
    launch count, across one call)."""
    from vulcan_tpu_torch.tools.timing import call_ms, device_and_host, max_abs_err

    name, tol = spec["name"], spec["tol"]
    flat = spec.get("flat", lambda out: out)   # outputs -> one tensor to compare
    want = flat(spec["plain"]())
    torch.cuda.synchronize()
    n0 = spec["count"]()
    errs = {"plain": max_abs_err(flat(spec["call"]()), want)}
    launches_per_call = spec["count"]() - n0
    for ref_name, ref in spec.get("also", ()):
        errs[ref_name] = max_abs_err(flat(spec["call"]()), flat(ref()))
    torch.cuda.synchronize()
    kernel_ms, host_us = device_and_host(spec["call"])
    call = call_ms(spec["call"])
    plain_ms = call_ms(spec["plain"])
    library_ms = library_kernel_ms = library_host_us = None
    if spec.get("library"):
        library_ms = call_ms(spec["library"])
        library_kernel_ms, library_host_us = device_and_host(spec["library"])
    bound_ms, bound_by = bound(spec["bytes"], spec["ops"])
    err = errs["plain"]
    library = ("none" if library_ms is None else
               f"{library_ms:.4f} ms (kernel {library_kernel_ms:.4f} ms, host "
               f"{library_host_us:.2f} us)")
    print(f"{name}: max_abs_err {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
          f"(tol {tol:g}); kernel {kernel_ms:.4f} ms (device, {launches_per_call} "
          f"launch/call) host {host_us:.2f} us call {call:.4f} ms (host included) "
          f"plain {plain_ms:.4f} ms library {library} bound {bound_ms:.5f} ms "
          f"({bound_by})", flush=True)
    for k, v in errs.items():
        if not v <= tol:
            fail(f"{name}: max abs error against {k} {v} above {tol}")
    entry = dict(name=name, route="cuda", source=spec["source"],
                 replaces=spec["replaces"], launches=0, max_abs_err=err,
                 ms=call, kernel_ms=kernel_ms, call_ms=call, host_us=host_us,
                 launches_per_call=launches_per_call,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, library_kernel_ms=library_kernel_ms,
                 library_host_us=library_host_us)
    entry.update(spec.get("extra", {}))
    return entry


def fill_smooth_ops(rounds: int) -> int:
    """f32 operations per pixel of K2/T1: a fill round takes min, isfinite,
    select and max of 8 taps, then a subtract and a compare; the smoothing
    pass takes isfinite, subtract, abs, compare and two adds of 8 taps, then
    a max and a divide."""
    return rounds * (8 * 4 + 2) + 8 * 6 + 2


def k1_inputs_and_radii(P, preprocess, torch, dev, frame0) -> None:
    """Phase 2, K1 beyond the random image: the orbit's first frame (a real
    surface: the folded weights matter where neighbours lie within a few
    sigma_depth), an odd shape (word-by-word staging, ragged tiles) and
    radius 0, 1 and 3, each against the plain version within K1_TOL."""
    from vulcan_tpu_torch.tools.timing import max_abs_err

    cfg = P.Config()
    rng = np.random.default_rng(13)
    real = torch.from_numpy(frame0.astype(np.float32)).to(dev) * (1.0 / cfg.depth_raw_scale)
    odd = rng.uniform(0.5, 3.0, (121, 161)).astype(np.float32)
    odd[rng.random(odd.shape) < 0.10] = 0.0
    yy, xx = np.mgrid[0:121, 0:161].astype(np.float32)
    slope = (1.2 + 0.004 * xx + 0.5 * (xx > 80) + rng.normal(0.0, 0.002, xx.shape))
    slope = slope.astype(np.float32)
    slope[rng.random(slope.shape) < 0.05] = 0.0
    cases = [("orbit frame 0, 480x640", real, cfg.bilateral_radius),
             ("random, 121x161", torch.from_numpy(odd).to(dev), cfg.bilateral_radius),
             ("stepped slope, 121x161", torch.from_numpy(slope).to(dev), cfg.bilateral_radius)]
    cases += [(f"orbit frame 0, radius {r}", real, r) for r in (0, 1, 3)]
    cases += [(f"stepped slope, 121x161, radius {r}", cases[2][1], r) for r in (1, 3)]
    for tag, x, radius in cases:
        c = dataclasses.replace(cfg, bilateral_radius=radius)
        got = preprocess.bilateral_filter(x, c)
        want = preprocess._bilateral_math(x, c)
        err = max_abs_err(got, want)
        same_zeros = bool(torch.equal(got == 0.0, ~(x > 0.0)))
        folded = max_abs_err(got, preprocess._bilateral_math_folded(x, c))
        print(f"K1 {tag}: max_abs_err {err:.3e} (tol {K1_TOL:g}), against its own "
              f"arithmetic in PyTorch {folded:.3e}, valid fraction "
              f"{float((x > 0).float().mean()):.3f}", flush=True)
        if not err <= K1_TOL or not same_zeros:
            fail(f"K1 on {tag}: max abs error {err} above {K1_TOL}, or an invalid "
                 "pixel came out valid")


def k2_rounds_and_shapes(P, splat, torch, dev) -> None:
    """Phase 2, K2 at rounds 0, 1, 2 and 5 (5 runs as two launches) at
    480x640 and at an odd shape, each against the plain version within
    K2_TOL, with its kernel launches per call.  The input is a sloped
    surface with a step (a silhouette the fill must not cross), small
    noise, 20% single-pixel holes and hole patches up to 12 pixels wide
    that take several rounds to close."""
    from vulcan_tpu_torch.ops import cuda_kernels
    from vulcan_tpu_torch.tools.timing import max_abs_err

    count = card_count("fill_smooth")
    rng = np.random.default_rng(11)
    for h, w in ((480, 640), (121, 161)):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        d = 1.5 + 0.3 * np.sin(xx / 40.0) + 0.2 * yy / h + 0.5 * (xx > w / 2)
        d = (d + rng.normal(0.0, 0.003, (h, w))).astype(np.float32)
        d[rng.random((h, w)) < 0.2] = np.inf
        for _ in range(max(4, h * w // 4000)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            sy, sx = rng.integers(2, 13, size=2)
            d[y0:y0 + sy, x0:x0 + sx] = np.inf
        x = torch.from_numpy(d).to(dev)
        for rounds in (0, 1, 2, 5):
            cfg = dataclasses.replace(P.Config(), splat_fill_rounds=rounds)
            k0 = count()
            got = splat._fill_and_smooth(x, cfg)
            per_call = count() - k0
            err = max_abs_err(got, splat._fill_smooth_math(x, cfg))
            filled = float((torch.isfinite(got) & ~torch.isfinite(x)).float().mean())
            print(f"K2 {h}x{w} rounds {rounds}: max_abs_err {err:.3e} (tol {K2_TOL:g}), "
                  f"{per_call} kernel launch(es)/call, {filled:.4f} of pixels filled",
                  flush=True)
            if not err <= K2_TOL:
                fail(f"K2 at {h}x{w}, rounds {rounds}: max abs error {err} above {K2_TOL}")
            if per_call != len(cuda_kernels.fill_smooth_plan(rounds)):
                fail(f"K2 at rounds {rounds}: {per_call} kernel launches per call")


# The track's GN kernels (csrc/icp.cu) against their plain versions.
ICP_SUM_TOL = 1e-5      # of a block's largest sum of magnitudes: the sums' order
ICP_SOLVE_RTOL = 1e-4   # the 6x6 algebra in another order (its inputs are sums)
# f32 operations a live pixel (the plain version's, counted from ops/icp.py):
# H1a: two 3x4 transforms 36, projection 7, round/clamp/bounds 10, the
# vertex and normal decode 12, gates 5; photometric: floor/fraction 4,
# weights 6, 12 half-word decodes 24, three blends 21.  H1b: transform 18,
# normal rotation 15, residual and gates 18, Huber 3, J 9, the 29 products
# and sums 65; photometric: transform and projection 25, residual 5, the
# chain rule 25, gate and Huber 11, J 15, products and sums 65.
ICP_OPS = {"associate": (70, 55), "rows": (133, 146)}
ICP_SOLVE_OPS = 400      # one 6x6 step: the factor, two solves, exp, product


def icp_bytes_ops(kind: str, lv, geometric: bool, photo: bool) -> tuple[int, int]:
    """Bytes in + out and f32 operations of one H1a, H1b or fused step
    (``rows_solve``: H1b and a solve) call on a level: each input read
    once, each output written once.  H1a gathers model
    words for each live pixel, one vpack1/vpack2/npack triple and the four
    taps of the two photometric words: counted once a live pixel, at most
    a whole map."""
    if kind == "rows_solve":
        # H1b's work, then the solve's: the pose vector out (64 B).
        nbytes, ops = icp_bytes_ops("rows", lv, geometric, photo)
        return nbytes + 64, ops + ICP_SOLVE_OPS
    n = lv.depth.numel()
    model = lv.npack.numel()
    if kind == "associate":
        nbytes = 12 * n + (4 * n + min(12 * n, 12 * model) + 25 * n if geometric else 0) \
            + (min(32 * n, 8 * model) + 21 * n if photo else 0)
    else:
        nbytes = 4 * 2 * 29 + (49 * n if geometric else 0) + (29 * n if photo else 0)
    geo_ops, photo_ops = ICP_OPS[kind]
    return nbytes + 124, n * (geo_ops * geometric + photo_ops * photo)


# The blocks of a 29-vector that H1b's check scales apart: H's upper
# triangle, b, the error; the count (28) is held exactly.
ICP_SUM_BLOCKS = {"H": (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 13, 14, 15, 16, 18, 19, 20, 22, 23, 25),
                  "b": (6, 12, 17, 21, 24, 26), "error": (27,)}


def icp_sums_err(got, want, magnitudes) -> float:
    """The largest error of H1b's sums, each block of each row (geometric,
    photometric) over its largest sum of magnitudes: a sum's rounding in
    another order stays within a few ulps of that, a wrong term does not.
    An absent term (magnitudes 0) must be 0 exactly."""
    worst = 0.0
    for row in range(2):
        for idx in ICP_SUM_BLOCKS.values():
            idx = list(idx)
            diff = float((got[row, idx] - want[row, idx]).abs().max())
            scale = float(magnitudes[row, idx].max())
            worst = max(worst, diff / scale if scale > 0.0 else
                        (float("inf") if diff else 0.0))
    return worst


R1_FRAMES = 10          # orbit frames fused (at their true poses) before R1 is timed


def range_image_kernel(P, torch, dev, cam, poses, frames) -> list[dict]:
    """Phase 2, R1 (``csrc/range_image.cu``): the march's range image at
    the march-orbit cell's shapes (640x480, ``Config(render_mode="march")``),
    on the orbit's first R1_FRAMES frames fused at their true poses and
    listed visible at the last one.  The kernel pair on the rows'
    values (``raycast._range_rows``) against the plain stamps and upsample
    (``_range_image_plain``) bit for bit, timed like K1; its library
    yardstick the plain version's three ``scatter_reduce_`` calls alone;
    its bound the bytes it must move (the listed rows, the coarse images
    written and read, the three maps)."""
    from vulcan_tpu_torch.ops import allocate, cuda_kernels, raycast

    cfg = P.Config(render_mode="march")
    h, w = frames[0][0].shape
    pipe = P.Pipeline(cfg, cam, h, w, init_pose=poses[0], device=dev)
    for pose, (d16, c8) in zip(poses[:R1_FRAMES], frames[:R1_FRAMES]):
        pipe.process(d16, c8, pose=pose)
    pose = poses[R1_FRAMES - 1].to(dev)
    vol = allocate.update_visibility(pipe.state.volume, cam, pose, h, w, cfg)
    rows = raycast._range_rows(vol, cam, pose, cfg)
    sc, st = cfg.range_scale, cfg.range_stamp
    hc, wc = -(-h // sc), -(-w // sc)
    args = (rows.z_min, rows.z_max, (rows.u_min, rows.u_max, rows.v_min, rows.v_max),
            rows.stampable, vol.num_visible, rows.any_overflow, rows.g_min, rows.g_max,
            (hc, wc), st, sc, (h, w))
    flat, zmin_b, zmax_b = raycast._stamp_lanes(rows, hc, wc, st)
    inf = float("inf")

    def library():
        for init, values, how in ((inf, zmin_b, "amin"), (inf, zmax_b, "amin"),
                                  (-inf, zmax_b, "amax")):
            buf = torch.full((hc * wc + 1,), init, dtype=torch.float32, device=dev)
            buf.scatter_reduce_(0, flat, values, how, include_self=True)


    def plain():
        return torch.stack(raycast._range_image_plain(rows, h, w, cfg))

    got, want = cuda_kernels.range_image(*args), plain()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"R1: the range image differs from the plain version's in "
             f"{int((got != want).sum())} of {got.numel()} entries")
    listed = int(vol.num_visible)
    stamped = int((flat < hc * wc).sum())
    print(f"R1 at {h}x{w}: {listed} listed rows, {int(rows.stampable.sum())} stampable, "
          f"{stamped} stamp cells of {flat.numel()} lanes, path "
          f"{cuda_kernels.range_image_path(hc * wc)}; bit-identical to the plain version",
          flush=True)
    row_bytes = 4 + 4 + 4 * 8 + 1
    return [check_kernel(dict(
        name="range_stamp", tol=0.0, source="vulcan_tpu_torch/csrc/range_image.cu",
        replaces="vulcan_tpu/ops/raycast.py:70",
        call=lambda: cuda_kernels.range_image(*args),
        count=card_count("range_stamp", "range_expand"), plain=plain,
        library=library,
        bytes=listed * row_bytes + 2 * 3 * hc * wc * 4 + 3 * h * w * 4, ops=0,
        extra=dict(listed_rows=listed, stamp_cells=stamped, lanes=flat.numel(),
                   kernels="range_stamp + range_expand"),
    ), torch)]


I1_FRAMES = 10          # frames fused (at their true poses) before I1 is timed
I1_OPS = 64             # f32 operations a voxel (I1's arithmetic, rounded up)
I1_OUTPUTS = ("tsdf", "weight", "colorpack", "surfpack", "surf_count", "mesh_dirty",
              "surf_overflow")


def integrate_kernel(P, torch, dev, cam, poses) -> list[dict]:
    """Phase 2, I1 (``csrc/integrate.cu``): the integrate layer at both
    benchmark configurations' shapes (640x480): ``Config()`` on the desk
    (``splat-combined``) and ``Config(render_mode="march")`` on the orbit
    (``march-depth``), each after I1_FRAMES frames fused at their true
    poses, on the next frame's band list (its length printed).  One launch
    against the plain version (``sparse._integrate_plain``, the chunk loop
    of PyTorch ops) bit for bit on all seven outputs, from copies of one
    volume; then both on that volume in place, I1 timed like K1 and the
    plain version's call ms; the bound is the bytes each listed block moves
    (its 512 tsdf, weight and colour words read and written, its surfel
    row, count, flag, coordinates and id) and the packed image read once."""
    from vulcan_tpu_torch.core.frame import Frame
    from vulcan_tpu_torch.io.synthetic import (orbit_poses, render_desk_depth,
                                               render_scene_depth)
    from vulcan_tpu_torch.ops import allocate, sparse
    from vulcan_tpu_torch.tools.timing import call_ms, device_and_host

    h, w = 480, 640
    n = I1_FRAMES + 1
    desk = orbit_poses(n, center=(0.0, 0.0, -0.25), radius=1.5, height=0.55, span=0.05 * n)
    cells = (("splat-combined", P.Config(), desk,
              lambda p: render_desk_depth(cam, p, h, w, device=dev)),
             ("march-depth", P.Config(render_mode="march"), poses[:n],
              lambda p: render_scene_depth(cam, p, h, w, SPHERES, FLOOR, device=dev)))
    entries = []
    for name, cfg, ps, render in cells:
        fs = [render(p) for p in ps]
        pipe = P.Pipeline(cfg, cam, h, w, init_pose=ps[0], device=dev)
        for pose, (d, c) in zip(ps[:-1], fs[:-1]):
            pipe.process(d, c, pose=pose)
        frame = Frame(*fs[-1], cam, ps[-1].to(dev))
        vol, band, n_band = allocate.allocate_for_frame(pipe.state.volume, frame.depth, cam,
                                                        frame.pose, cfg)
        del pipe

        def copy():
            return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).clone()
                                               for f in dataclasses.fields(vol)})

        got = sparse.integrate_sparse(copy(), frame, cfg, ids=band, count=n_band)
        want = sparse._integrate_plain(copy(), frame, cfg, band, n_band)
        for field in I1_OUTPUTS:
            a, b = getattr(got, field), getattr(want, field)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                fail(f"I1 ({name}): {field} differs from the plain version's in "
                     f"{int((a != b).sum())} of {a.numel()} entries")
        listed = int(n_band)
        print(f"I1 at {h}x{w} ({name}): {listed} band blocks of {band.shape[0]} rows, "
              f"{int(got.surf_overflow)} surfels dropped, "
              f"{int(got.mesh_dirty.sum())} blocks dirty; bit-identical to the plain "
              f"version on {', '.join(I1_OUTPUTS)}", flush=True)

        def call():
            return sparse.integrate_sparse(vol, frame, cfg, ids=band, count=n_band)

        def plain():
            return sparse._integrate_plain(vol, frame, cfg, band, n_band)

        count = card_count("integrate")
        count0 = count()
        call()
        launches_per_call = count() - count0
        kernel_ms, host_us = device_and_host(call)
        one_call = call_ms(call)
        plain_ms = call_ms(plain)
        block_bytes = 2 * 3 * 512 * 4 + cfg.surfel_slots * 4 + 4 + 1 + 3 * 4 + 4
        bound_ms, bound_by = bound(listed * block_bytes + h * w * 4,
                                   listed * 512 * I1_OPS)
        print(f"integrate ({name}): exact; kernel {kernel_ms:.4f} ms (device, "
              f"{launches_per_call} launch/call) host {host_us:.2f} us call {one_call:.4f} "
              f"ms (host included) plain {plain_ms:.4f} ms library none bound "
              f"{bound_ms:.5f} ms ({bound_by}) at {listed} band blocks", flush=True)
        entries.append(dict(
            name="integrate", config=name, route="cuda",
            source="vulcan_tpu_torch/csrc/integrate.cu",
            replaces="vulcan_tpu/ops/sparse.py:377", launches=0, max_abs_err=0.0,
            ms=one_call, kernel_ms=kernel_ms, call_ms=one_call, host_us=host_us,
            launches_per_call=launches_per_call, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, library_kernel_ms=None,
            library_host_us=None, band_blocks=listed))
        del vol, got, want
    return entries


S1_FRAMES = 10          # desk frames fused (at their true poses) before S1 is timed
S1_OPS = 60             # f32 operations a surfel (S1's arithmetic, rounded up)
S1_MODES = {"depth": 1, "luma": 1, "rgb": 2}   # S1's modes and launches a call


def splat_zbuf_kernel(P, torch, dev, cam) -> list[dict]:
    """Phase 2, S1 (``csrc/splat_zbuf.cu``): the surfel z-buffer at the
    desk cells' shapes (640x480, ``Config()``, ``splat-combined``), after
    S1_FRAMES desk frames fused at their true poses, on the visible list at
    the next pose.  In each mode (depth, luma, rgb) the kernel against the
    plain tiers (``splat._splat_zbuf_surfels_plain``, the two chunk loops
    of PyTorch ops) bit for bit, with its launches a call; then the luma
    mode, the desk cells', timed like K1 beside the plain version's call
    ms.  The bound is the bytes it moves: each listed row's id, each
    surfel block's count, coordinates and the slots of its tiers, a colour
    word a live surfel, and the buffer filled and updated once."""
    from vulcan_tpu_torch.io.synthetic import orbit_poses, render_desk_depth
    from vulcan_tpu_torch.ops import allocate, splat

    h, w = 480, 640
    n = S1_FRAMES + 1
    cfg = P.Config()
    desk = orbit_poses(n, center=(0.0, 0.0, -0.25), radius=1.5, height=0.55, span=0.05 * n)
    pipe = P.Pipeline(cfg, cam, h, w, init_pose=desk[0], device=dev)
    for pose in desk[:-1]:
        pipe.process(*render_desk_depth(cam, pose, h, w, device=dev), pose=pose)
    pose = desk[-1].to(dev)
    vol = allocate.update_visibility(pipe.state.volume, cam, pose, h, w, cfg)
    del pipe
    count = card_count("splat_zbuf")

    def run(mode, plain=False):
        fn = splat._splat_zbuf_surfels_plain if plain else splat._splat_zbuf_surfels
        out = fn(vol, cam, pose, h, w, cfg, with_color=mode == "rgb", luma=mode == "luma")
        return out if mode == "rgb" else (out,)

    for mode, want_launches in S1_MODES.items():
        c0 = count()
        got = run(mode)
        launches = count() - c0
        for a, b in zip(got, run(mode, plain=True)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                fail(f"S1 ({mode}): the buffer differs from the plain version's in "
                     f"{int((a != b).sum())} of {a.numel()} pixels")
        if launches != want_launches:
            fail(f"S1 ({mode}): {launches} launches a call, expected {want_launches}")
        print(f"S1 ({mode}): bit-identical to the plain tiers, {launches} launch(es) a call",
              flush=True)
    S = cfg.surfel_slots
    nv = int(vol.num_visible)
    ids = vol.visible_ids[:nv].long()
    held = vol.surf_count[ids]
    listed = ids[(ids > 0) & (held > 0)]
    held = vol.surf_count[listed]
    stop = torch.where(held > S // 2, S, S // 2)
    live = int(held.sum())
    hits = int((run("luma")[0] != splat._LUMA_EMPTY).sum())
    print(f"S1 at {h}x{w}: {nv} visible rows, {listed.numel()} surfel blocks, {live} "
          f"surfels, {hits} pixels hit", flush=True)
    return [check_kernel(dict(
        name="splat_zbuf", tol=0.0, source="vulcan_tpu_torch/csrc/splat_zbuf.cu",
        replaces="vulcan_tpu/ops/splat.py _splat_zbuf_surfels (two lax.while_loop tiers)",
        call=lambda: run("luma")[0], count=count,
        plain=lambda: run("luma", plain=True)[0],
        bytes=nv * 4 + listed.numel() * (4 + 12) + 4 * int(stop.sum()) + 4 * live
        + 2 * 4 * h * w,
        ops=live * S1_OPS,
        extra=dict(visible_rows=nv, surfel_blocks=listed.numel(), surfels=live,
                   pixels_hit=hits, mode="luma"),
    ), torch)]


NODE_REPS = 20          # IF/ELSE nodes a graph when one node's cost is timed
WHILE_TRIPS = (1, 8, 32)  # iterations of the timed WHILE nodes
# WHILE iterations (or IF nodes) a timed graph: a replay of many more queues
# more launches than the card holds pending, and the host waits.
NODE_BUDGET = 48
GRAPH_NODES = ("graph_while", "graph_while_next", "graph_ifelse")


def graph_node_kernels(torch, dev) -> list[dict]:
    """Phase 2, the conditional nodes' kernels (``csrc/graph.cu``): a graph
    with a chunk loop (``sync.chunk_loop``: one WHILE node), a ``sync.cond``
    (one IF/ELSE node) whose true branch holds a second chunk loop, whose
    body holds a third-level ``cond``, replayed at loop counts 0, 1, 3, 4,
    5, 16 and 21 (past the capacity of 16, in chunks of 4) and predicates 0
    and 1 against the same work run eagerly (its plain version: the counts
    and branches read on the host), with each replay's WHILE nodes,
    iterations and IF/ELSE nodes counted on the card against the eager
    form's loops, bodies and conds.  Timed: a replay of one WHILE node (one
    chunk of a 4-float add) and of one IF/ELSE node around such adds,
    beside the same work eagerly; one more chunk of the add, graph against
    eager (its device ms, call ms and host us, each the replay's reading at
    32 iterations less that at 1, over 31); and the nodes' own costs from graphs of nodes with empty bodies:
    one WHILE node of k = 1, 8 and 32 iterations against k IF nodes (graphs
    of NODE_BUDGET // k WHILE nodes and NODE_BUDGET IF nodes), one IF/ELSE
    node against two IF nodes (one on the predicate, one on its negation;
    graphs of NODE_REPS), and an empty kernel node, the floor.
    Returns the three kernels' entries of the kernels line."""
    from vulcan_tpu_torch.tools.timing import call_ms, device_and_host
    from vulcan_tpu_torch.utils import sync

    cap, chunk = 16, 4
    count = torch.zeros((), dtype=torch.int32, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    y = torch.zeros(cap, device=dev)
    z = torch.zeros(cap, device=dev)
    lanes = torch.arange(chunk, device=dev)

    def outer(offset):
        rows = offset + lanes
        y.index_add_(0, rows, (rows < count).float())

    def inner(offset):
        rows = offset + lanes
        add = sync.cond(offset == 0, lambda: torch.full((chunk,), 100.0, device=dev),
                        lambda: torch.full((chunk,), 10.0, device=dev))
        z.index_add_(0, rows, add * (rows < count))

    def work():
        sync.chunk_loop(count, cap, chunk, outer)

        def on():
            sync.chunk_loop(count, cap, chunk, inner)
            return y * 2.0

        return sync.cond(flag, on, lambda: y * 3.0)

    def counters():
        c = launch_counts()
        return {k: c[k] for k in GRAPH_NODES}

    y.add_(0.0)
    g = torch.cuda.CUDAGraph()
    with sync.capture(g, dev) as _pool:
        out = torch.zeros(cap, device=dev)
        out.copy_(work())
    err, nodes_ok = 0.0, True
    for n, v in itertools.product((0, 1, 3, 4, 5, 16, 21), (0, 1)):
        count.fill_(n)
        flag.fill_(v)
        y.zero_()
        z.zero_()
        torch.cuda.synchronize()
        before = counters()
        g.replay()
        torch.cuda.synchronize()
        card = {k: c - before[k] for k, c in counters().items()}
        got = (y.clone(), z.clone(), out.clone())
        y.zero_()
        z.zero_()
        bodies0, conds0 = sync.chunk_loop.count, sync.cond.count
        want_out = work()
        eager = {"graph_while_next": sync.chunk_loop.count - bodies0,
                 "graph_ifelse": sync.cond.count - conds0}
        trips = -(-min(n, cap) // chunk)
        want_nodes = {"graph_while": 1 + v, "graph_while_next": trips * (1 + v),
                      "graph_ifelse": 1 + v * trips}
        err = max(err, *(float((a - b).abs().max())
                         for a, b in zip(got, (y, z, want_out))))
        if card != want_nodes or any(card[k] != c for k, c in eager.items()):
            nodes_ok = False
            print(f"count {n} flag {v}: the card counted {card}, expected {want_nodes}, "
                  f"the eager form {eager}", flush=True)
    if not nodes_ok:
        fail("graph nodes: a replay ran another count of WHILE iterations or IF/ELSE "
             "nodes than the eager form")

    # One node around one 4-float add, graph and eager, and one more chunk.
    x = torch.zeros(chunk, device=dev)
    one_count = torch.ones((), dtype=torch.int32, device=dev)

    def add_chunk(offset):
        x.add_(1.0)

    loop = torch.cuda.CUDAGraph()
    with sync.capture(loop, dev) as _pool1:
        sync.chunk_loop(one_count, 32, 1, add_chunk)
    branch = torch.cuda.CUDAGraph()
    with sync.capture(branch, dev) as _pool2:
        picked = torch.zeros(chunk, device=dev)
        picked.copy_(sync.cond(flag, lambda: x * 2.0, lambda: x * 3.0))
    flag.fill_(1)
    timed = {}
    for k in (1, 32):
        one_count.fill_(k)
        timed[f"while_{k}_add_ms"], timed[f"while_{k}_add_host_us"] = (
            device_and_host(loop.replay))
        timed[f"while_{k}_add_call_ms"] = call_ms(loop.replay)
        timed[f"eager_loop_{k}_add_ms"] = call_ms(
            lambda: sync.chunk_loop(one_count, 32, 1, add_chunk))
    one_count.fill_(1)
    while_ms, while_host_us = device_and_host(loop.replay)
    while_call_ms = call_ms(loop.replay)
    ifelse_ms, ifelse_host_us = device_and_host(branch.replay)
    ifelse_call_ms = call_ms(branch.replay)

    # The nodes' own costs, empty bodies, each graph's replay over its count
    # of WHILE nodes (against as many groups of k IF nodes) or IF/ELSE nodes.
    pred = flag > 0
    reps = {k: NODE_BUDGET // k for k in WHILE_TRIPS}

    def graph_of(build):
        gr = torch.cuda.CUDAGraph()
        with sync.capture(gr, dev) as pool:
            build()
        return gr, pool

    whiles = {k: graph_of(lambda k=k: [sync.chunk_loop(one_count, 32, 1, lambda o: None)
                                       for _ in range(reps[k])])
              for k in WHILE_TRIPS}
    ifs = {k: graph_of(lambda k=k: [sync._cond_node(pred, lambda: None)
                                    for _ in range(reps[k] * k)])
           for k in WHILE_TRIPS}
    ifelse = graph_of(lambda: [sync._cond_node(pred, lambda: None, lambda: None)
                               for _ in range(NODE_REPS)])
    two_ifs = graph_of(lambda: [(sync._cond_node(pred, lambda: None),
                                 sync._cond_node(~pred, lambda: None))
                                for _ in range(NODE_REPS)])
    empty = torch.cuda.CUDAGraph()
    with torch.cuda.graph(empty):
        for _ in range(NODE_REPS):
            torch.cuda._sleep(0)
    node = {"empty_kernel_node_ms": device_and_host(empty.replay)[0] / NODE_REPS}
    for k in WHILE_TRIPS:
        one_count.fill_(k)
        torch.cuda.synchronize()
        before = counters()
        whiles[k][0].replay()
        torch.cuda.synchronize()
        if counters()["graph_while_next"] - before["graph_while_next"] != reps[k] * k:
            fail(f"graph nodes: a WHILE node of {k} iterations ran another count")
        node[f"while_node_{k}_iterations_ms"] = (
            device_and_host(whiles[k][0].replay)[0] / reps[k])
        node[f"{k}_if_nodes_ms"] = device_and_host(ifs[k][0].replay)[0] / reps[k]
    for v in (1, 0):
        flag.fill_(v)
        pred.copy_(flag > 0)
        node[f"ifelse_node_ms_pred_{v}"] = device_and_host(ifelse[0].replay)[0] / NODE_REPS
        node[f"two_if_nodes_ms_pred_{v}"] = device_and_host(two_ifs[0].replay)[0] / NODE_REPS
    flag.fill_(1)
    pred.copy_(flag > 0)
    k_lo, k_hi = WHILE_TRIPS[0], WHILE_TRIPS[-1]
    node["while_iteration_ms"] = (node[f"while_node_{k_hi}_iterations_ms"]
                                  - node[f"while_node_{k_lo}_iterations_ms"]) / (k_hi - k_lo)
    node["while_node_ms"] = node[f"while_node_{k_lo}_iterations_ms"] - node["while_iteration_ms"]
    node["if_node_ms"] = node[f"{k_lo}_if_nodes_ms"]
    node["if_node_excess_ms"] = node["if_node_ms"] - node["empty_kernel_node_ms"]
    node["ifelse_node_excess_ms"] = node["ifelse_node_ms_pred_1"] - node["empty_kernel_node_ms"]

    def eager_cond():
        return sync.cond(flag, lambda: x * 2.0, lambda: x * 3.0)

    replaces = {"graph_while": "vulcan_tpu/ops/sparse.py:377 lax.while_loop, "
                               "vulcan_tpu/ops/splat.py:434,536",
                "graph_while_next": "vulcan_tpu/ops/sparse.py:377 lax.while_loop, "
                                    "vulcan_tpu/ops/splat.py:434,536",
                "graph_ifelse": "vulcan_tpu/pipeline/fusion.py:147,308 lax.cond"}
    common = dict(route="cuda", source="vulcan_tpu_torch/csrc/graph.cu", launches=0,
                  max_abs_err=err, launches_per_call=1, bound_by="bytes", library_ms=None,
                  library_kernel_ms=None, library_host_us=None, **node, **timed)
    # One more iteration: each reading at 32 iterations less the same at 1.
    more = {key: (timed[f"while_32_add_{key}"] - timed[f"while_1_add_{key}"]) / 31
            for key in ("ms", "call_ms", "host_us")}
    per_chunk = more["ms"]
    eager_per_chunk = (timed["eager_loop_32_add_ms"] - timed["eager_loop_1_add_ms"]) / 31
    entries = [
        dict(name="graph_while", replaces=replaces["graph_while"],
             ms=while_call_ms, kernel_ms=while_ms, call_ms=while_call_ms,
             host_us=while_host_us, plain_ms=timed["eager_loop_1_add_ms"],
             bound_ms=bound(4 + 8, 0.0)[0],
             shape="one WHILE node, one iteration of a 4-float add", **common),
        dict(name="graph_while_next", replaces=replaces["graph_while_next"],
             ms=more["call_ms"], kernel_ms=per_chunk, call_ms=more["call_ms"],
             host_us=more["host_us"],
             plain_ms=eager_per_chunk, bound_ms=bound(4 + 8 + 8, 0.0)[0],
             shape="one more iteration of a 4-float add (32 against 1)", **common),
        dict(name="graph_ifelse", replaces=replaces["graph_ifelse"],
             ms=ifelse_call_ms, kernel_ms=ifelse_ms, call_ms=ifelse_call_ms,
             host_us=ifelse_host_us, plain_ms=call_ms(eager_cond), bound_ms=bound(1, 0.0)[0],
             shape="one IF/ELSE node, a 4-float multiply a branch", **common),
    ]
    print(f"graph nodes: WHILE, IF/ELSE (nested 3 deep) against the eager form "
          f"max_abs_err {err:.3e} (tol 0), iterations and nodes as the eager form's "
          f"loops and conds; a replay of one WHILE node around an add {while_ms:.4f} ms "
          f"device (32 iterations {timed['while_32_add_ms']:.4f}; eager "
          f"{timed['eager_loop_1_add_ms']:.4f} / {timed['eager_loop_32_add_ms']:.4f} ms "
          f"call), one more iteration {per_chunk:.6f} ms device, {more['call_ms']:.6f} ms "
          f"call, {more['host_us']:.3f} us host (eager {eager_per_chunk:.6f} ms call); "
          f"one IF/ELSE node around a multiply {ifelse_ms:.4f} ms device, eager "
          f"{entries[2]['plain_ms']:.4f} ms call", flush=True)
    print("graph nodes, empty bodies, ms a node: "
          + ", ".join(f"{k} {v:.6f}" for k, v in node.items()), flush=True)
    if err != 0.0:
        fail("the conditional nodes ran other work than the eager form")
    return entries


def track_kernels(P, torch, dev, cam, poses, frames) -> list[dict]:
    """Phase 2, H1a-H1c and the fused step: the orbit's first frame fused
    at its true pose and rendered (the model), its own pyramid (the live
    side), at the true pose and at one moved 2 cm and 1 degree, in depth,
    color (no geometric term) and combined mode, every level: H1a against
    ``_associate_plain`` (validity masks and the decoded correspondences
    exact, samples within 1e-5), H1b against ``_rows_plain`` on the same
    correspondences (step and detector rows; ``icp_sums_err`` within
    ICP_SUM_TOL, the count exact), H1c against ``_solve_plain`` on the
    same sums (step and scores, ICP_SOLVE_RTOL), the fused step
    ``icp_rows_solve`` against ``_solve_plain(_rows_plain(...))`` (sums as
    H1b's, pose and scores as H1c's; its pose bit-equal to H1c's on the
    fused sums), H1a right behind a fused step (bit-equal); each kernel
    twice, bit-identical.  Returns the kernels line's entries, timed at
    the finest level in depth mode (the main path's shapes)."""
    from vulcan_tpu_torch.core.frame import Frame
    from vulcan_tpu_torch.core.se3 import SE3
    from vulcan_tpu_torch.ops import cuda_kernels, icp, preprocess
    from vulcan_tpu_torch.pipeline import fusion
    from vulcan_tpu_torch.tools.timing import max_abs_err

    cfg = P.Config()
    pipe = P.Pipeline(cfg, cam, 480, 640, init_pose=poses[0], mode="combined", device=dev)
    d16, c8 = frames[0]
    pipe.process(d16, c8, pose=poses[0])
    depth, color = fusion._to_metric(torch.from_numpy(d16).to(dev),
                                     torch.from_numpy(c8).to(dev), cfg)
    live = preprocess.build_pyramid(Frame(depth, color, cam, poses[0]), cfg)
    model = icp.model_pyramid(pipe.state.model, cfg.pyramid_levels,
                              flat_thresh=max(0.05, 6.0 * cfg.voxel_size))
    moved = SE3.exp(torch.tensor([0.0, 0.0174533, 0.0, 0.02, 0.0, 0.0], device=dev))
    strides = icp._level_strides(cfg)
    report = []

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for mode in ("depth", "color", "combined"):
        geometric = mode != "color"
        for tag, pose in (("true pose", poses[0].to(dev)),
                          ("moved 2 cm, 1 deg", moved @ poses[0].to(dev))):
            pv = icp._pose_vector(pose)
            for level in range(cfg.pyramid_levels):
                photo = icp._photo_here(mode, level, cfg)
                lv = icp.level_inputs(live[level], model[level], strides[level], icp.LOCAL,
                                      photo)
                got, want = (icp.icp_associate(lv, pv, cfg, geometric, photo),
                             icp._associate_plain(lv, pv, cfg, geometric, photo))
                again = icp.icp_associate(lv, pv, cfg, geometric, photo)
                want_c, want_s = want
                # Each term's outputs, validity mask last: (v_m, n_m, ok),
                # (i_m0, gu, gv, u0, v0, ok).
                terms = [k for k in range(2) if want[k] is not None]
                repeat = all(same(got[k], again[k]) for k in terms)
                ok_flips = sum(int((got[k][-1] != want[k][-1]).sum()) for k in terms)
                corr_exact = not geometric or same(got[0], want_c)
                if photo:
                    s_err = max(max_abs_err(a, b) for a, b in zip(got[1][:5], want_s[:5]))
                    samples_exact = same(got[1], want_s)
                else:
                    s_err, samples_exact = 0.0, True
                rows = {}
                for live_normals in (False, True):
                    args = (lv, pv, want_c, want_s, cfg, geometric, photo, live_normals)
                    got = icp.icp_rows(*args)
                    again = icp.icp_rows(*args)
                    want = icp._rows_plain(*args)
                    rows[live_normals] = dict(
                        err=icp_sums_err(got, want, icp._rows_plain(*args, magnitudes=True)),
                        count_equal=bool(torch.equal(got[:, 28], want[:, 28])),
                        repeat=bool(torch.equal(got, again)), sums=want)
                solve, fused = {}, {}
                for detect in (False, True):
                    sums = rows[detect]["sums"]
                    got = icp.icp_solve(sums, pv, cfg, geometric, photo, detect)
                    again = icp.icp_solve(sums, pv, cfg, geometric, photo, detect)
                    want = icp._solve_plain(sums, pv, cfg.icp_damping, geometric, photo,
                                            detect)
                    solve[detect] = dict(
                        err=max_abs_err(got, want), repeat=bool(torch.equal(got, again)),
                        ok=bool(torch.allclose(got, want, rtol=ICP_SOLVE_RTOL, atol=1e-6)))
                    # The fused step against _solve_plain(_rows_plain(...)),
                    # and its pose against H1c alone on its own sums (the
                    # same solve code on the same numbers: bit-equal).
                    args = (lv, pv, want_c, want_s, cfg, geometric, photo, detect)
                    f_sums, f_pose = icp.icp_rows_solve(*args)
                    a_sums, a_pose = icp.icp_rows_solve(*args)
                    p_sums = icp._rows_plain(*args)
                    p_pose = icp._solve_plain(p_sums, pv, cfg.icp_damping, geometric, photo,
                                              detect)
                    fused[detect] = dict(
                        sums_err=icp_sums_err(f_sums, p_sums,
                                              icp._rows_plain(*args, magnitudes=True)),
                        count_equal=bool(torch.equal(f_sums[:, 28], p_sums[:, 28])),
                        pose_err=max_abs_err(f_pose, p_pose),
                        ok=bool(torch.allclose(f_pose, p_pose, rtol=ICP_SOLVE_RTOL,
                                               atol=1e-6)),
                        same_as_h1c=bool(torch.equal(
                            f_pose, icp.icp_solve(f_sums, pv, cfg, geometric, photo,
                                                  detect))),
                        repeat=bool(torch.equal(f_sums, a_sums) and torch.equal(f_pose, a_pose)))
                # H1a right behind the fused step whose pose it reads (a
                # programmatic dependent launch waits for that pose).
                chained_pose = icp.icp_rows_solve(lv, pv, want_c, want_s, cfg, geometric,
                                                  photo)[1]
                chained = icp.icp_associate(lv, chained_pose, cfg, geometric, photo)
                chained_want = icp._associate_plain(lv, chained_pose, cfg, geometric, photo)
                chained_exact = all(same(chained[k], chained_want[k]) for k in terms)
                line = dict(mode=mode, pose=tag, level=level, photo=photo,
                            live=tuple(lv.depth.shape), ok_flips=ok_flips,
                            correspondences_exact=corr_exact, samples_exact=samples_exact,
                            samples_max_abs_err=s_err, rows_rel_err=rows[False]["err"],
                            detector_rows_rel_err=rows[True]["err"],
                            solve_max_abs_err=solve[False]["err"],
                            scores_max_abs_err=solve[True]["err"],
                            fused_sums_rel_err=max(f["sums_err"] for f in fused.values()),
                            fused_pose_max_abs_err=fused[False]["pose_err"],
                            fused_scores_max_abs_err=fused[True]["pose_err"],
                            fused_equals_h1c=all(f["same_as_h1c"] for f in fused.values()),
                            h1a_behind_fused_exact=chained_exact,
                            inliers=float(rows[False]["sums"][0 if geometric else 1, 28]),
                            repeats_bit_identical=repeat and all(
                                r["repeat"] for r in (*rows.values(), *solve.values(),
                                                      *fused.values())))
                report.append(line)
                print(f"H1a-H1c {mode}, {tag}, level {level} ({line['live'][0]}x"
                      f"{line['live'][1]}, photometric {photo}): ok flips {ok_flips}, "
                      f"correspondences exact {corr_exact}, samples exact {samples_exact} "
                      f"(max abs err {s_err:.3e}); rows {rows[False]['err']:.3e} / detector "
                      f"{rows[True]['err']:.3e} of a block's sum of magnitudes (tol {ICP_SUM_TOL:g}), "
                      f"counts equal {rows[False]['count_equal'] and rows[True]['count_equal']}; "
                      f"solve max abs err {solve[False]['err']:.3e}, scores "
                      f"{solve[True]['err']:.3e} (rtol {ICP_SOLVE_RTOL:g}, atol 1e-6); fused "
                      f"step sums {line['fused_sums_rel_err']:.3e}, pose "
                      f"{line['fused_pose_max_abs_err']:.3e}, scores "
                      f"{line['fused_scores_max_abs_err']:.3e}, equal to H1c on its sums "
                      f"{line['fused_equals_h1c']}; H1a behind it exact {chained_exact}; "
                      f"inliers {line['inliers']:.0f}; repeats "
                      f"bit-identical {line['repeats_bit_identical']}", flush=True)
                if ok_flips or not corr_exact or not s_err <= 1e-5:
                    fail(f"H1a differs from its plain version ({mode}, {tag}, level {level})")
                if not all(r["err"] <= ICP_SUM_TOL and r["count_equal"] for r in rows.values()):
                    fail(f"H1b differs from its plain version ({mode}, {tag}, level {level})")
                if not all(v["ok"] for v in solve.values()):
                    fail(f"H1c differs from its plain version ({mode}, {tag}, level {level})")
                if not all(f["sums_err"] <= ICP_SUM_TOL and f["count_equal"] and f["ok"]
                           and f["same_as_h1c"] for f in fused.values()):
                    fail(f"the fused step differs from its plain version or from H1c "
                         f"({mode}, {tag}, level {level})")
                if not chained_exact:
                    fail(f"H1a behind the fused step differs ({mode}, {tag}, level {level})")
                if not line["repeats_bit_identical"]:
                    fail(f"a repeat of a track kernel differs ({mode}, {tag}, level {level})")
                if line["inliers"] < 100:
                    fail(f"under 100 inliers at level {level}: the check saw no rows")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "track_kernels.json"), "w") as f:
        json.dump(report, f, indent=1)

    # The kernels line: the finest level in depth mode, at the moved pose.
    lv = icp.level_inputs(live[0], model[0], strides[0], icp.LOCAL, False)
    pv = icp._pose_vector(moved @ poses[0].to(dev))
    corr, _ = icp._associate_plain(lv, pv, cfg, True, False)
    sums = icp._rows_plain(lv, pv, corr, None, cfg, True, False)
    shape = f"{lv.depth.shape[0]}x{lv.depth.shape[1]} live, {lv.npack.shape[0]}x" \
            f"{lv.npack.shape[1]} model, depth mode"
    a_bytes, a_ops = icp_bytes_ops("associate", lv, True, False)
    r_bytes, r_ops = icp_bytes_ops("rows", lv, True, False)
    f_bytes, f_ops = icp_bytes_ops("rows_solve", lv, True, False)
    specs = [
        dict(name="icp_associate", tol=0.0, source="vulcan_tpu_torch/csrc/icp.cu",
             replaces="vulcan_tpu/ops/icp.py:349",
             call=lambda: icp.icp_associate(lv, pv, cfg, True, False),
             count=card_count("icp_associate"),
             plain=lambda: icp._associate_plain(lv, pv, cfg, True, False),
             flat=lambda out: torch.cat([out[0][0].reshape(-1), out[0][1].reshape(-1),
                                         out[0][2].reshape(-1).float()]),
             bytes=a_bytes, ops=a_ops,
             extra=dict(shape=shape, also_replaces="vulcan_tpu/ops/icp.py:800 color_assoc")),
        dict(name="icp_rows", tol=ICP_SUM_TOL * float(sums[:, :28].abs().max()),
             source="vulcan_tpu_torch/csrc/icp.cu", replaces="vulcan_tpu/ops/icp.py:703",
             call=lambda: icp.icp_rows(lv, pv, corr, None, cfg, True, False),
             count=card_count("icp_rows"),
             plain=lambda: icp._rows_plain(lv, pv, corr, None, cfg, True, False),
             bytes=r_bytes, ops=r_ops,
             extra=dict(shape=shape, cluster_ctas=cuda_kernels.ICP_ROWS_CLUSTER,
                        also_replaces="vulcan_tpu/ops/icp.py:753 _fused_normal_eqs, "
                               ":879 color_rows_fixed")),
        dict(name="icp_solve", tol=ICP_SOLVE_RTOL, source="vulcan_tpu_torch/csrc/icp.cu",
             replaces="vulcan_tpu/ops/icp.py:983",
             call=lambda: icp.icp_solve(sums, pv, cfg, True, False),
             count=card_count("icp_solve"),
             plain=lambda: icp._solve_plain(sums, pv, cfg.icp_damping, True, False),
             flat=lambda out: out[:12],
             bytes=(2 * 29 + 2 * 16) * 4, ops=ICP_SOLVE_OPS,
             extra=dict(shape="one 6x6 step",
                        also_replaces="vulcan_tpu/ops/icp.py:931 _min_eig_normalized")),
        dict(name="icp_rows_solve", tol=ICP_SOLVE_RTOL, source="vulcan_tpu_torch/csrc/icp.cu",
             replaces="vulcan_tpu/ops/icp.py:753",
             call=lambda: icp.icp_rows_solve(lv, pv, corr, None, cfg, True, False),
             count=card_count("icp_rows_solve"),
             plain=lambda: icp._solve_plain(icp._rows_plain(lv, pv, corr, None, cfg, True,
                                                            False),
                                            pv, cfg.icp_damping, True, False),
             flat=lambda out: (out[1] if isinstance(out, tuple) else out)[:12],
             bytes=f_bytes, ops=f_ops,
             extra=dict(shape=shape + ", one GN step",
                        cluster_ctas=cuda_kernels.ICP_ROWS_CLUSTER,
                        also_replaces="vulcan_tpu/ops/icp.py:703 _pp_normal_eqs, "
                               ":983 solve_gn, SE3.exp")),
    ]
    return [check_kernel(spec, torch) for spec in specs]


def probes(P, torch, dev) -> list[dict]:
    """Phase 6: the probe kernels at the tools' own shapes against their
    plain versions, then the three probe entry points with every probe
    count set to 0; each probe kernel must launch there."""
    from vulcan_tpu_torch.ops import cuda_kernels
    from vulcan_tpu_torch.tools import bench_gather, bench_stencil, bench_subsample, sass
    from vulcan_tpu_torch.tools.timing import device_ms

    scfg = bench_stencil.probe_config(P.Config().trunc_dist)
    d = bench_stencil.make_input(480, 640, dev)
    k2_ms = device_ms(lambda: bench_stencil.fill_smooth_k2(d, scfg))
    specs = [dict(
        name="fill_smooth_fused", tol=K2_TOL,
        source="vulcan_tpu_torch/csrc/fill_smooth_fused.cu",
        replaces="tools/bench_pallas_stencil.py:77",
        call=lambda: bench_stencil.fill_smooth_fused(d, scfg),
        count=lambda: bench_stencil.fill_smooth_fused.launches,
        plain=lambda: bench_stencil.fill_smooth_plain(d, scfg),
        also=[("K2", lambda: bench_stencil.fill_smooth_k2(d, scfg))],
        bytes=2 * d.numel() * 4, ops=d.numel() * fill_smooth_ops(scfg.splat_fill_rounds),
        extra=dict(k2_kernel_ms_same_input=k2_ms),
    )]
    names = {"T2": "gather_smem_f32", "T3": "gather_smem_i32", "T4": "gather_columns_f32",
             "T4/l2": "gather_l2_f32"}
    lines = {"T2": 85, "T3": 115, "T4": 146, "T4/l2": 146}
    cases = [(c.name, c, None) for c in bench_gather.make_cases(dev)]
    cases.append(("T4/l2", cases[-1][1], "l2"))
    for tag, case, path in cases:
        specs.append(dict(
            name=names[tag], tol=0.0, source="vulcan_tpu_torch/csrc/gather.cu",
            replaces=f"tools/bench_pallas_gather.py:{lines[tag]}",
            call=lambda c=case, p=path: bench_gather.chained_gather(
                c.table, c.idx, c.rounds, path=p),
            count=lambda c=case, p=path: bench_gather.chained_gather.launches[
                bench_gather.launch_key(c.table, p)],
            plain=lambda c=case: bench_gather.chained_gather_plain(c.table, c.idx, c.rounds),
            bytes=(case.table.numel() + 2 * case.idx.numel()) * 4,
            # per lookup: convert, two adds, abs, remainder, sum
            ops=case.lookups * 6,
            extra=dict(path=bench_gather.launch_key(case.table, path),
                       lookups=case.lookups,
                       gather_x_rounds_ms=device_ms(
                           lambda c=case: bench_gather.gather_rounds(c))),
        ))
    t2, t3, t4 = (c for _, c, _ in cases[:3])
    smem_ragged(bench_gather, t2, t3, torch)
    gather_ragged(bench_gather, t4, torch)
    for case, path in ((t2, "smem"), (t3, "smem"), (t4, "columns")):
        print(f"{case.name} under the {path} path's variants, device ms (each exact):",
              flush=True)
        for row in bench_gather.variant_times(case):
            waves = (f"  {row['clusters']} clusters, {row['clusters_at_once']} at once"
                     if "clusters" in row else "")
            print(f"  {row['ms']:.6f} ms  {row['m_lookups_per_s']:8.0f} M lookups/s  "
                  f"{row['name']}" + (f"  {tuple(row['plan'])}" if row["plan"] else "") + waves,
                  flush=True)
    for case in (t2, t3):
        print(f"{case.name}, one launch by round count, device ms:", flush=True)
        for step, ms in bench_gather.round_costs(case).items():
            print(f"  {ms:.6f} ms  {step}", flush=True)
    sass.print_loops(cuda_kernels.build(), "gather_smem_kernelI[fi]Li4ELb0", "LDS", "lookup")
    sass.print_loops(cuda_kernels.build(), "fill_smooth_fused_kernelILi2", "SHFL", "shuffle")
    t1_rounds_and_shapes(bench_stencil, scfg.trunc_dist, torch, dev)
    t5_exact(bench_subsample, torch, dev)
    x = bench_subsample.make_input(dev)
    breakdown = bench_subsample.host_breakdown(x)
    print("T5 host us per call, step by step (queued behind a spin kernel):",
          flush=True)
    for step, us in breakdown.items():
        print(f"  {us:8.3f} us  {step}", flush=True)
    specs.append(dict(
        name="subsample2", tol=0.0, source="vulcan_tpu_torch/csrc/subsample.cu",
        replaces="tools/bench_subsample.py:63",
        call=lambda: bench_subsample.subsample2(x),
        count=lambda: bench_subsample.subsample2.launches,
        plain=lambda: bench_subsample.subsample2_plain(x),
        library=lambda: x[::2, ::2].contiguous(),
        # the even rows in (odd columns ride in the same sectors), the output out
        bytes=((x.shape[0] + 1) // 2 * x.shape[1]
               + (x.shape[0] + 1) // 2 * ((x.shape[1] + 1) // 2)) * 4,
        ops=0,
        extra=dict(host_breakdown_us=breakdown),
    ))
    entries = [check_kernel(spec, torch) for spec in specs]
    fused = entries[0]
    print(f"T1 {fused['kernel_ms']:.4f} ms vs K2 {k2_ms:.4f} ms, device time, "
          "same input", flush=True)
    for tag, fused_kernel in (("K2", False), ("T1", True)):
        print(f"{tag}, one launch on the same input, device ms:", flush=True)
        for step, ms in bench_stencil.launch_costs(d, scfg.trunc_dist, fused_kernel).items():
            print(f"  {ms:.6f} ms  {step}", flush=True)
    print("T1 by strip height and warps a block, device ms:", flush=True)
    for (rows, warps), ms in bench_stencil.strip_times(d, scfg.trunc_dist).items():
        print(f"  {ms:.6f} ms  {rows} rows a strip, {warps} warps a block", flush=True)
    for e in entries[1:5]:
        e["m_lookups_per_s"] = e["lookups"] / e["kernel_ms"] * 1e3 / 1e6
        print(f"{e['name']}: {e['m_lookups_per_s']:.0f} M lookups/s (device time)",
              flush=True)

    bench_stencil.fill_smooth_fused.launches = 0
    bench_subsample.subsample2.launches = 0
    for k in bench_gather.chained_gather.launches:
        bench_gather.chained_gather.launches[k] = 0
    bench_stencil.run(dev)
    bench_gather.run(dev)
    bench_subsample.run(dev)
    counts = {
        "fill_smooth_fused": bench_stencil.fill_smooth_fused.launches,
        "subsample2": bench_subsample.subsample2.launches,
    }
    for e in entries[1:5]:
        counts[e["name"]] = bench_gather.chained_gather.launches[e["path"]]
    print(f"probe entry points' kernel launches {counts}", flush=True)
    for e in entries:
        e["launches"] = counts[e["name"]]
        if e["launches"] < 1:
            fail(f"{e['name']}: not launched by its probe entry point")
    return entries


def smem_ragged(bench_gather, t2, t3, torch) -> None:
    """The smem path (T2/T3) where its partition is ragged, under every
    variant of its plan and on its own: heights of idx that do not fill the
    slabs, 16 to 128 columns, short tables, 0, 1 and 32 rounds, both
    dtypes, and an int32 table whose sums hit the most negative int; each
    bit for bit against the plain version."""
    from vulcan_tpu_torch.ops import cuda_kernels

    sms = cuda_kernels._sm_count(t2.table.get_device())
    idx_tall = torch.cat([t2.idx, t2.idx.flip(0)])
    checked = 0
    for base, n, cols, t_rows in itertools.product(
            (t2.table, t3.table), (7, 1000, 3001), (16, 48, 128), (64, 1024, 2048)):
        table = base[:t_rows, :cols].contiguous()
        idx = (idx_tall[:n, :cols] % t_rows).contiguous()
        plans = [cuda_kernels.smem_plan(t_rows, cols, n, sms, cpb, blocks)
                 for _, cpb, blocks in bench_gather.SMEM_VARIANTS] + [None]
        for rounds in (0, 1, 32):
            want = bench_gather.chained_gather_plain(table, idx, rounds)
            for plan in plans:
                got = bench_gather.chained_gather(table, idx, rounds, plan=plan)
                checked += 1
                if got.dtype != want.dtype or not torch.equal(got, want):
                    fail(f"smem gather differs from the plain version at N={n}, L={cols}, "
                         f"T={t_rows}, rounds {rounds}, {table.dtype}, {plan}")
    # table[r] = INT_MIN - r: the first sum is the most negative int, whose
    # absolute value is itself; later sums wrap
    r = torch.arange(2048, dtype=torch.int64, device=t2.table.device)
    extreme = ((r.neg() + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    table = extreme[:, None].repeat(1, 16).contiguous()
    idx = t2.idx[:100, :16].contiguous()
    for rounds in (1, 2, 5):
        want = bench_gather.chained_gather_plain(table, idx, rounds)
        for path in cuda_kernels.GATHER_PATHS:
            checked += 1
            if not torch.equal(bench_gather.chained_gather(table, idx, rounds, path=path), want):
                fail(f"{path} gather differs on the most negative int at {rounds} rounds")
    print(f"T2/T3 smem path: {checked} launches at ragged shapes, under every variant of "
          "the plan and on the most negative int: all exact", flush=True)


def t1_rounds_and_shapes(bench_stencil, mu, torch, dev) -> None:
    """T1 at 0-4 rounds at 480x640 and at two odd shapes at 2 rounds,
    against the plain version and against K2 (K2_TOL, finite masks equal),
    on an image with hole patches that take several rounds to close."""
    from vulcan_tpu_torch.tools.timing import max_abs_err

    rng = np.random.default_rng(17)
    for h, w, all_rounds in ((480, 640, range(5)), (121, 161, (2,)), (479, 641, (2,))):
        d = bench_stencil.make_input(h, w, "cpu").numpy().copy()
        for _ in range(max(4, h * w // 4000)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            sy, sx = rng.integers(2, 9, size=2)
            d[y0:y0 + sy, x0:x0 + sx] = np.inf
        x = torch.from_numpy(d).to(dev)
        for rounds in all_rounds:
            cfg = bench_stencil.probe_config(mu, rounds)
            got = bench_stencil.fill_smooth_fused(x, cfg)
            errs = {"plain": max_abs_err(got, bench_stencil.fill_smooth_plain(x, cfg)),
                    "K2": max_abs_err(got, bench_stencil.fill_smooth_k2(x, cfg))}
            print(f"T1 {h}x{w} rounds {rounds}: max_abs_err plain {errs['plain']:.3e}, "
                  f"K2 {errs['K2']:.3e} (tol {K2_TOL:g})", flush=True)
            for ref, err in errs.items():
                if not err <= K2_TOL:
                    fail(f"T1 at {h}x{w}, rounds {rounds}: max abs error against {ref} "
                         f"{err} above {K2_TOL}")


def gather_ragged(bench_gather, case, torch) -> None:
    """The columns path where its partition is ragged: heights that do not
    fill the blocks' row shares, a 16-column width, an int32 table and a
    table of 4096 rows, bit for bit against the plain version."""
    from vulcan_tpu_torch.ops import cuda_kernels

    t_rows = case.table.shape[0]
    picks = [(case.table, 1000, 128), (case.table, 7, 128), (case.table, 12345, 16),
             (case.table.to(torch.int32), 3001, 32), (case.table[:4096], 5000, 48)]
    for table, n, cols in picks:
        table = table[:, :cols].contiguous()
        idx = (case.idx[:n, :cols] % table.shape[0]).contiguous()
        if n > idx.shape[0]:
            fail("gather_ragged: the case has too few rows")
        want = bench_gather.chained_gather_plain(table, idx, case.rounds)
        got = bench_gather.chained_gather(table, idx, case.rounds, path="columns")
        ok = got.dtype == want.dtype and torch.equal(got, want)
        plan = cuda_kernels.gather_plan(table.shape[0], cols, n,
                                        cuda_kernels._sm_count(table.get_device()))
        print(f"T4 columns path, table {tuple(table.shape)} {table.dtype}, idx ({n}, {cols}): "
              f"{'exact' if ok else 'DIFFERS'}  {tuple(plan)}", flush=True)
        if not ok:
            fail(f"columns gather differs from the plain version at N={n}, L={cols}, "
                 f"T={table.shape[0]} (full height {t_rows})")


def t5_exact(bench_subsample, torch, dev) -> None:
    """T5 at odd and tiny shapes, in int32 and float32, bit for bit against
    its plain version (the kernel's word-by-word remainder)."""
    rng = np.random.default_rng(7)
    for h, w in ((479, 641), (2, 6), (1, 1)):
        for dtype in (np.int32, np.float32):
            a = (rng.integers(-(1 << 31), 1 << 31, (h, w), dtype=np.int64).astype(np.int32)
                 if dtype == np.int32 else rng.standard_normal((h, w)).astype(np.float32))
            x = torch.from_numpy(a).to(dev)
            got = bench_subsample.subsample2(x)
            want = bench_subsample.subsample2_plain(x)
            ok = got.dtype == want.dtype and torch.equal(
                got.view(torch.int32), want.view(torch.int32))
            print(f"T5 {h}x{w} {dtype.__name__}: {'exact' if ok else 'DIFFERS'}",
                  flush=True)
            if not ok:
                fail(f"T5 differs from x[::2, ::2] at {h}x{w} {dtype.__name__}")


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


def make_desk_frames(P, camera, poses, h, w, device):
    """The desk scene's frames, as ``make_frames`` hands over the orbit's."""
    from vulcan_tpu_torch.io.synthetic import render_desk_depth

    frames = []
    for pose in poses:
        d, c = render_desk_depth(camera, pose, h, w, device=device)
        d16 = np.clip(d.cpu().numpy() * 5000.0, 0, 65535).astype(np.uint16)
        c8 = np.clip(c.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        frames.append((d16, c8))
    return frames


_EAGER = {}


def eager_pipeline(P):
    """``Pipeline`` with every frame through the eager step, on the card
    too: the graph's yardstick (phase 3c) and the ground of the sharded
    step's comparison (phase 10)."""
    if P not in _EAGER:
        class EagerPipeline(P.Pipeline):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.captured, self._graphs = False, None

        _EAGER[P] = EagerPipeline
    return _EAGER[P]


def launch_counts() -> dict[str, int]:
    """The main path's kernels' launches on the card: K1, K2's kernel
    launches, H1a-H1c, the fused step and the conditional nodes' kernels
    (a WHILE node's set-up, its iterations, an IF/ELSE node's set-up), each
    counted by the kernel itself at every launch, eager or replayed from a
    CUDA graph (``cuda_kernels.launch_counts``; a capture launches
    nothing)."""
    from vulcan_tpu_torch.ops import cuda_kernels

    return cuda_kernels.launch_counts()


def card_count(*names):
    """A ``check_kernel`` ``count``: the card's launches of the kernels
    ``names``, added."""
    return lambda: sum(launch_counts()[name] for name in names)


def reset_counts() -> None:
    """Every count a main-path run reads set to 0: the launches on the
    card, the host reads, and the eager step's chunk-loop bodies and
    ``cond``s."""
    from vulcan_tpu_torch.ops import cuda_kernels
    from vulcan_tpu_torch.utils import sync

    cuda_kernels.reset_launch_counts()
    sync.read_int.count = 0
    sync.chunk_loop.count = 0
    sync.cond.count = 0


def per_frame(counts: list[dict]) -> list[dict]:
    """Each frame's launches from the counts read after each frame (the
    first frame's from 0)."""
    prev = dict.fromkeys(counts[0], 0) if counts else {}
    out = []
    for c in counts:
        out.append({k: c[k] - prev[k] for k in c})
        prev = c
    return out


def want_per_frame(config, known=False, k2_per_frame=1) -> dict[str, int]:
    """The launches a frame of the main path takes: K1 once, K2
    ``k2_per_frame`` times, the track's as ``track_launches`` (none at a
    known pose), R1's two kernels once under the march and never under the
    splat, I1 once (every frame integrates its band), S1 once on the
    surfel splat's own path (no polish; luma model colour, or none) and
    never off it (the march, the direct and the cached z-buffers)."""
    h1 = {k: 0 if known else v for k, v in track_launches(config).items()}
    r1 = int(config.render_mode == "march")
    s1 = int(config.render_mode == "splat" and config.splat_source == "surfels"
             and config.splat_polish == 0)
    return {"bilateral": 1, "fill_smooth": k2_per_frame, **h1, "range_stamp": r1,
            "range_expand": r1, "integrate": 1, "splat_zbuf": s1}


def want_nodes(config, mode="depth", known=False) -> dict[str, int]:
    """The conditional nodes a replayed frame evaluates, on a frame that
    auto-photo has not armed: a WHILE node for each loop of the render the
    frame takes (the direct z-buffer's chunks; the render cache's halo
    chunks, and on the splat its cached z-buffer's; the surfel splat and
    integrate have none: S1 and I1 are one launch each that reads its
    list's count on the card), and an IF/ELSE node for each of auto-photo's two
    ``cond``s (depth mode, tracked) and for each march level's compaction
    branch.  The render has colour in the photometric modes and at a known
    pose, not on an unarmed depth-mode frame."""
    if config.model_color != "luma":
        raise ValueError("want_nodes counts the luma render's loops")
    auto = (mode == "depth" and config.auto_photo and config.degen_min_eig > 0.0
            and not known)
    with_color = known or mode != "depth"
    ifelse = 2 if auto else 0
    if config.render_mode == "march":
        render = 1
        ifelse += (config.raycast_coarse_compact > 0) + (config.raycast_fine_compact > 0)
    else:
        surfels = config.splat_source == "surfels"
        need_cache = config.splat_polish > 0 or (
            with_color and not (surfels and config.splat_polish == 0))
        render = 2 if need_cache else 0 if surfels else 1
    return {"graph_while": render, "graph_ifelse": ifelse}


def check_launches(label, frames, want, captured, nodes=None, eager=None) -> dict:
    """Each frame's launches on the card (``per_frame``) against ``want``.
    Eager, every frame takes exactly ``want`` and no conditional node.
    Captured, the warm-up frames run eagerly with both sides of every
    ``sync.cond`` (at least ``want``, no conditional node), and every later
    frame is a replay that takes exactly ``want``, the WHILE and IF/ELSE
    nodes of ``nodes`` and at least one WHILE iteration where it has a
    WHILE node (none where it has none); given ``eager``,
    the chunk-loop bodies and ``cond``s of an eager run of the same frames
    (``run_pipeline``'s ``chunks`` and ``conds``), exactly its bodies as
    WHILE iterations and its ``cond``s as IF/ELSE nodes on every frame.
    Returns the mean launches of the frames held to exactly ``want``."""
    from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

    first = WARMUP_FRAMES if captured else 0
    for i, got in enumerate(frames):
        kind = "warm-up" if i < first else "replayed" if captured else "eager"
        ok = all(got[k] >= v if i < first else got[k] == v for k, v in want.items())
        graph = dict.fromkeys(GRAPH_NODES, 0)
        if kind == "replayed":
            graph = dict(nodes)
            if eager is not None:
                graph.update(graph_while_next=eager["chunks"][i],
                             graph_ifelse=eager["conds"][i])
            else:
                ok = ok and (got["graph_while_next"] >= 1) == (nodes["graph_while"] > 0)
        ok = ok and all(got[k] == v for k, v in graph.items())
        if not ok:
            fail(f"{label}: {kind} frame {i} launched {got} on the card, expected "
                 f"{want} and the conditional nodes {graph} a frame")
    held = frames[first:]
    return {k: sum(f[k] for f in held) / len(held) for k in frames[0]} if held else {}


def run_pipeline(P, config, camera, poses, frames, h, w, device, sync,
                 mode="depth", eager=False, known=False):
    """Returns (pipe, translations, ms per frame, armed frames, run): a
    frame is armed when auto-photo tracked it in combined mode (the
    countdown carried into it was positive); ``run`` holds each frame's
    host reads, the launch counts after each frame, the (n, 12) poses
    (R row-major, t), and each frame's eager chunk-loop bodies and
    ``cond``s (``sync.chunk_loop.count``, ``sync.cond.count``; ``chunks``
    and ``conds``).  ``eager`` runs the eager step on the card too
    (``eager_pipeline``); otherwise ``Pipeline`` decides (a captured graph
    on the card at every supported setting).  ``known`` fuses each
    frame at its true pose (``process(..., pose=...)``).  The launch
    counts after each frame are the card's (``launch_counts``), in
    ``run["counts"]``."""
    from vulcan_tpu_torch.utils.sync import chunk_loop, cond, read_int

    cls = eager_pipeline(P) if eager else P.Pipeline
    pipe = cls(config, camera, h, w, init_pose=poses[0], mode=mode, device=device)
    est, ms, armed, reads, counts, full = [], [], 0, [], [], []
    chunks, conds = [], []
    for i, (d16, c8) in enumerate(frames):
        armed += int(pipe.state.photo_cnt) > 0
        r0, b0, c0 = read_int.count, chunk_loop.count, cond.count
        t0 = time.perf_counter()
        pipe.process(d16, c8, pose=poses[i] if known else None)
        if sync:
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(read_int.count - r0)
        chunks.append(chunk_loop.count - b0)
        conds.append(cond.count - c0)
        counts.append(launch_counts())
        full.append(torch_cat_pose(pipe.pose))
        est.append(pipe.pose.translation.cpu().numpy())
    run = dict(reads=reads, counts=counts, poses=np.stack(full),
               chunks=chunks, conds=conds)
    return pipe, np.stack(est), ms, armed, run


def torch_cat_pose(pose) -> np.ndarray:
    """(12,) R row-major and t of an SE3, on the host."""
    return np.concatenate([pose.rotation.reshape(9).cpu().numpy(),
                           pose.translation.cpu().numpy()])


def check_graph_run(label, pipe, run, config, known=False, k2_per_frame=1, mode="depth",
                    eager=None) -> dict:
    """A captured run: every frame after the warm-up was a replay (the
    graphs' replays, ``StepGraphs.run`` replaying the capture frame too,
    are the frames after the warm-up) and read nothing on the host, and
    ``check_launches`` holds each frame's launches on the card, the
    conditional nodes of ``mode`` (``want_nodes``) among them, and, given
    the ``run`` of the eager step on the same frames, its chunk-loop bodies
    and ``cond``s.  A replayed frame runs no Python step, so an eager
    launch there would show as a surplus on the card.  Returns the
    launches a replayed frame."""
    from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

    if not pipe.captured or not pipe.graph_stats:
        fail(f"{label}: the pipeline did not run as a captured graph")
    replays = sum(st["replays"] for st in pipe.graph_stats.values())
    if replays != len(run["reads"]) - WARMUP_FRAMES:
        fail(f"{label}: {replays} replays over {len(run['reads'])} frames, "
             f"{WARMUP_FRAMES} of them warm-up")
    later = sum(run["reads"][WARMUP_FRAMES:])
    if later:
        fail(f"{label}: {later} host reads in the replayed frames")
    return check_launches(label, per_frame(run["counts"]),
                          want_per_frame(config, known, k2_per_frame), True,
                          want_nodes(config, mode, known), eager)


def check_eager_run(label, run, config, known=False, k2_per_frame=1) -> None:
    """An eager run on the card: each frame launched exactly the path's
    kernels (``check_launches``)."""
    check_launches(label, per_frame(run["counts"]),
                   want_per_frame(config, known, k2_per_frame), False)


# The track's entry points: H1a, H1b, H1c and the fused step (H1b + H1c).
H1_ENTRIES = ("icp_associate", "icp_rows", "icp_solve", "icp_rows_solve")


def track_launches(cfg, sharded=False) -> dict[str, int]:
    """The track's launches at ``cfg``: H1a once an association round; a
    GN step and a level score each one ``icp_rows_solve`` in one process,
    or (``sharded``: the reducer adds the ranks' sums between them) one
    H1b and one H1c."""
    rounds = [max(1, min(a, i)) for a, i in zip(cfg.icp_assoc, cfg.icp_iters)]
    steps = sum(r * -(-i // r) for r, i in zip(rounds, cfg.icp_iters))
    steps += cfg.pyramid_levels if cfg.degen_min_eig > 0.0 else 0
    return {"icp_associate": sum(rounds), "icp_rows": steps if sharded else 0,
            "icp_solve": steps if sharded else 0, "icp_rows_solve": 0 if sharded else steps}


@contextlib.contextmanager
def plain_track():
    """The track's entry points swapped for their plain versions, on
    whatever device the tensors are (the yardstick run of phase 3), and
    put back after."""
    from vulcan_tpu_torch.ops import icp

    saved = {k: getattr(icp, k) for k in H1_ENTRIES}

    def rows_solve(lv, pose, corr, samples, config, geometric, photo, detect=False):
        sums = icp._rows_plain(lv, pose, corr, samples, config, geometric, photo, detect)
        return sums, icp._solve_plain(sums, pose, config.icp_damping, geometric, photo,
                                      detect)

    icp.icp_associate = icp._associate_plain
    icp.icp_rows = icp._rows_plain
    icp.icp_solve = lambda sums, pose, config, geometric, photo, detect=False: (
        icp._solve_plain(sums, pose, config.icp_damping, geometric, photo, detect))
    icp.icp_rows_solve = rows_solve
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(icp, k, v)


def run_cell(P, torch, label, config, mode, camera, poses, frames, ate_limit,
             must_arm=False, k2_per_frame=1, no_failures=False):
    """Phases 3b and 8: one path over its frames at 480x640 through
    ``Pipeline``, counts set to 0 just before it and read just after.
    ``ate_limit`` None records the ATE without judging it.  On the eager
    path every frame must launch K1 once, K2 ``k2_per_frame`` times (0 on
    the ray march, which has no fill/smooth step) and the track's as
    ``track_launches`` (``check_eager_run``); a captured path must pass
    ``check_graph_run``.  ``no_failures`` fails on a track failure.
    Returns the printed numbers as a dict."""
    from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES
    from vulcan_tpu_torch.utils.evaluate import ate_rmse

    n = len(frames)
    torch.cuda.synchronize()
    reset_counts()
    pipe, est, ms, armed, run = run_pipeline(
        P, config, camera, poses, frames, 480, 640, torch.device("cuda:0"),
        torch.cuda.synchronize, mode,
    )
    counts = run["counts"][-1]
    h1 = {k: counts[k] for k in H1_ENTRIES}
    k1, k2 = counts["bilateral"], counts["fill_smooth"]
    reads = sum(run["reads"])
    path = "graph" if pipe.captured else "eager"
    replay_reads = sum(run["reads"][WARMUP_FRAMES:]) / (n - WARMUP_FRAMES)
    gt = np.stack([p.translation.numpy() for p in poses])
    ate = ate_rmse(est, gt)
    diag = pipe.diagnostics()
    timed = np.asarray(ms[N_WARM:])
    out = dict(cell=label, mode=mode, frames=n, path=path,
               ms_median=float(np.median(timed)),
               ms_p90=float(np.percentile(timed, 90)), ate_m=float(ate),
               armed_frames=int(armed), host_reads_per_frame=reads / n,
               host_reads_per_frame_after_warmup=replay_reads,
               k1_launches=k1, k2_kernel_launches=k2, h1_launches=h1,
               graph=pipe.graph_stats,
               track_failures=diag["track_failures"],
               degen_frames=diag["track_degen_frames"])
    print(f"{label} ({path}): ms/frame median {out['ms_median']:.3f} p90 "
          f"{out['ms_p90']:.3f} (warm-up {N_WARM}, timed {len(timed)}, synchronized "
          f"per frame); ATE {ate:.6f} m over {n} frames; armed frames {armed}; "
          f"host reads/frame {reads / n:.2f} ({replay_reads:.2f} after the first "
          f"{WARMUP_FRAMES}); K1 launches {k1}, K2 kernel launches {k2}, track {h1}; "
          f"graph {pipe.graph_stats}; track failures {diag['track_failures']}, "
          f"degenerate frames {diag['track_degen_frames']}", flush=True)
    for key, st in pipe.graph_stats.items():
        print(f"{label}: graph '{key}' captured in {st['capture_ms']:.1f} ms, memory "
              f"pool {st['pool_mib']:.1f} MiB, {st['replays']} replays", flush=True)
    if pipe.captured:
        out["launches_per_replayed_frame"] = check_graph_run(
            label, pipe, run, config, k2_per_frame=k2_per_frame, mode=mode)
    else:
        check_eager_run(label, run, config, k2_per_frame=k2_per_frame)
    if diag["alloc_overflow"] or diag["visible_overflow"]:
        fail(f"{label}: allocation or visibility overflow")
    if no_failures and diag["track_failures"]:
        fail(f"{label}: {diag['track_failures']} track failures")
    if not np.all(np.isfinite(est)) or not bool(torch.isfinite(pipe.state.pose.rotation).all()):
        fail(f"{label}: a non-finite pose")
    if must_arm and not armed:
        fail(f"{label}: auto-photo never armed")
    if ate_limit is not None and not ate < ate_limit:
        fail(f"{label}: ATE {ate} m not below {ate_limit} m")
    return out


def named_tensors(tree, prefix=""):
    """{dotted path: tensor} of a dataclass tree (the state's arrays)."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(named_tensors(getattr(tree, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: tree} if hasattr(tree, "dtype") else {}


# Phase 3c: what the graph may differ from the eager step in, by array, when
# two eager runs agree bit for bit: nothing (the same kernels on the same
# inputs in the same order).
GRAPH_TOL = 0.0


def graph_against_eager(P, torch, label, config, mode, cam, poses, frames, dev,
                        ate_limit, known=False, k2_per_frame=1) -> dict:
    """Phase 3c, one cell: the eager step twice on the card (whether it
    repeats bit for bit), then ``Pipeline`` (the captured graph) on the
    same frames.  Wherever the two eager runs agree, the graph's per-frame
    poses and final state must equal the eager ones (GRAPH_TOL); the
    arrays that differ are named.  Each run's launches a frame on the card
    are held as ``check_eager_run`` / ``check_graph_run`` hold them (K2
    ``k2_per_frame`` times: 0 on the march), and the graph's replayed
    frames read nothing; ``known`` fuses at the true poses (the known-pose
    step: no track).  Returns the printed numbers."""
    from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES
    from vulcan_tpu_torch.utils.evaluate import ate_rmse

    n = len(frames)
    gt = np.stack([p.translation.numpy() for p in poses])
    runs = {}
    for tag, eager in (("eager", True), ("eager again", True), ("graph", False)):
        torch.cuda.synchronize()
        reset_counts()
        pipe, est, ms, armed, run = run_pipeline(
            P, config, cam, poses, frames, 480, 640, dev, torch.cuda.synchronize, mode,
            eager=eager, known=known)
        replayed = None
        if eager:
            check_eager_run(f"{label} ({tag})", run, config, known, k2_per_frame)
        else:
            replayed = check_graph_run(label, pipe, run, config, known, k2_per_frame,
                                       mode=mode, eager=runs["eager"]["run"])
        runs[tag] = dict(graph=pipe.graph_stats, ms=np.asarray(ms[N_WARM:]), armed=armed,
                         run=run, replayed=replayed,
                         state={k: v.clone() for k, v in named_tensors(pipe.state).items()})
        del pipe
    e1, e2, g = runs["eager"], runs["eager again"], runs["graph"]
    differ, eager_differ = {}, []
    for name, a in e1["state"].items():
        if not torch.equal(a, e2["state"][name]):
            eager_differ.append(name)
        elif not torch.equal(a, g["state"][name]):
            b = g["state"][name]
            differ[name] = (float((a.double() - b.double()).abs().max())
                            if a.is_floating_point() else int((a != b).sum()))
    poses_e1, poses_e2, poses_g = (r["run"]["poses"] for r in (e1, e2, g))
    poses_eager_same = bool(np.array_equal(poses_e1, poses_e2))
    poses_same = bool(np.array_equal(poses_e1, poses_g))
    pose_diff = float(np.abs(poses_e1 - poses_g).max())
    ate = {t: float(ate_rmse(r["run"]["poses"][:, 9:], gt)) for t, r in runs.items()}
    got = g["replayed"]
    out = dict(cell=label, mode=mode, frames=n, path="graph", graph=g["graph"],
               eager_ms_median=float(np.median(e1["ms"])),
               eager_ms_p90=float(np.percentile(e1["ms"], 90)),
               graph_ms_median=float(np.median(g["ms"])),
               graph_ms_p90=float(np.percentile(g["ms"], 90)),
               eager_reads_per_frame=float(np.mean(e1["run"]["reads"])),
               graph_reads_per_replayed_frame=float(
                   np.mean(g["run"]["reads"][WARMUP_FRAMES:])),
               launches_per_replayed_frame=got,
               ate_m=ate, armed_frames={t: r["armed"] for t, r in runs.items()},
               eager_repeats_bit_identical=poses_eager_same and not eager_differ,
               eager_differs_from_itself=eager_differ,
               poses_bit_identical=poses_same, max_pose_diff=pose_diff,
               arrays_differing=differ)
    print(f"{label}: graph {out['graph_ms_median']:.3f} / p90 {out['graph_ms_p90']:.3f} "
          f"ms a frame, eager {out['eager_ms_median']:.3f} / {out['eager_ms_p90']:.3f} "
          f"(synchronized per frame); host reads a frame eager "
          f"{out['eager_reads_per_frame']:.2f}, graph "
          f"{out['graph_reads_per_replayed_frame']:.2f} a replayed frame; capture "
          f"{out['graph']}; launches a replayed frame on the card {got}; ATE {ate}; "
          f"armed {out['armed_frames']}; eager repeats "
          f"bit-identical {out['eager_repeats_bit_identical']} (differ: {eager_differ}); "
          f"graph vs eager poses bit-identical {poses_same} (max diff {pose_diff:.3e}), "
          f"arrays differing {differ}", flush=True)
    if poses_eager_same and not poses_same:
        fail(f"{label}: the graph's poses differ from the eager step's by {pose_diff}")
    if any(v > GRAPH_TOL for v in differ.values()):
        fail(f"{label}: the graph's state differs from the eager step's: {differ}")
    if ate_limit is not None and not ate["graph"] < ate_limit:
        fail(f"{label}: ATE {ate['graph']} m not below {ate_limit} m")
    return out


MESH_POS_TOL = 1e-5     # m: card vs CPU extraction (one division a vertex)
MESH_COLOR_TOL = 1e-5   # colour interpolation: FMA contraction on the card
INC_POS_TOL = 2e-4      # m: the cache's 16-bit edge parameter (tests/test_mcubes.py)
INC_COLOR_TOL = 1 / 128  # the cache's rgb888 colour (tests/test_mcubes.py)
MESH_EVERY = 5           # frames between re-meshes (the CLI's --mesh-every)
MESH_SLOTS = 512         # cache slots a block in (b); the default is 256


def events_ms(fn, torch):
    """(result, ms) of one call of ``fn()`` between two CUDA events (the
    host's part, host reads included, is inside the window)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def compare_meshes(label, got, want, pos_tol, color_tol):
    """Equal counts and overflows, positions and colours of every lane
    within the tolerances (lanes past the count are zeros on both)."""
    for k in ("count", "overflow", "compact_dropped"):
        a, b = int(getattr(got, k)), int(getattr(want, k))
        if a != b:
            fail(f"{label}: {k} {a} against {b}")
    dp = float((got.positions.cpu() - want.positions.cpu()).abs().max())
    dc = float((got.colors.cpu() - want.colors.cpu()).abs().max())
    print(f"{label}: count {int(got.count)} equal, max |position diff| {dp:.3e} m "
          f"(tol {pos_tol:g}), max |colour diff| {dc:.3e} (tol {color_tol:g})", flush=True)
    if not (dp <= pos_tol and dc <= color_tol):
        fail(f"{label}: positions or colours differ beyond the tolerance")
    return dp, dc


def metric_frame(d16, c8, cfg):
    """A uint16/uint8 sensor frame in meters and [0, 1], as the step converts it."""
    return (d16.astype(np.float32) * np.float32(1.0 / cfg.depth_raw_scale),
            c8.astype(np.float32) * np.float32(1.0 / 255.0))


def mesh_and_api(P, torch, cfg, cam, poses, frames, pipe, dev) -> dict:
    """Phase 7: the mesh path and the five-class API at 640x480 on the card.
    (a) full extraction of phase 3's volume, against the port's plain path
    on a CPU copy; (b) incremental meshing every MESH_EVERY frames over the
    orbit (mesh_dirty_eps=0), its last decode against a full extraction;
    (c) PLY export and a v4 snapshot from the card loaded on the CPU, both
    traced at one pose; (d) the five-class flow over 10 frames.  Returns
    the printed numbers."""
    import dataclasses as dc

    from vulcan_tpu_torch.io.ply import read_ply
    from vulcan_tpu_torch.ops import mcubes
    from vulcan_tpu_torch.tools.timing import call_ms
    from vulcan_tpu_torch.utils.convert import volume_from_numpy, volume_to_numpy
    from vulcan_tpu_torch.utils.evaluate import ate_rmse
    from vulcan_tpu_torch.utils.sync import read_int

    cpu = torch.device("cpu")
    h, w = frames[0][0].shape
    report = {}

    # (a) full extraction, card against CPU
    vol = pipe.state.volume
    read_int.count = 0
    mesh = pipe.extract_mesh()
    torch.cuda.synchronize()
    reads = read_int.count
    extract_ms = call_ms(pipe.extract_mesh, reps=3, warm=1)
    n_tri, blocks = int(mesh.count), int(vol.free_count) - 1
    print(f"(a) extract_mesh: {n_tri} triangles from {blocks} allocated blocks, "
          f"overflow {int(mesh.overflow)}, {extract_ms:.3f} ms (median of 3, CUDA "
          f"events), host reads/extraction {reads}", flush=True)
    if not n_tri > 0 or int(mesh.overflow):
        fail("(a) the card's mesh is empty or overflowed")
    vol_cpu = volume_from_numpy(volume_to_numpy(vol), cpu)
    t0 = time.perf_counter()
    mesh_cpu = mcubes.extract_mesh(vol_cpu, cfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    dp, dcol = compare_meshes("(a) card vs CPU", mesh, mesh_cpu, MESH_POS_TOL,
                              MESH_COLOR_TOL)
    report["full"] = dict(triangles=n_tri, allocated_blocks=blocks, ms=extract_ms,
                          host_reads=reads, cpu_ms=cpu_ms, max_pos_diff_m=dp,
                          max_color_diff=dcol)
    del vol_cpu, mesh_cpu

    # (b) incremental meshing every MESH_EVERY frames (mesh_dirty_eps=0).
    # The default 256 cache slots a block drop ~0.5% of this orbit's
    # triangles (blocks of up to ~350, counted in overflow, as the
    # reference counts them), so the decode runs with MESH_SLOTS and
    # reports what 256 would have dropped.
    cfg0 = dc.replace(cfg, mesh_dirty_eps=0.0, mesh_slots=MESH_SLOTS)
    pipe0 = P.Pipeline(cfg0, cam, h, w, init_pose=poses[0], device=dev)
    cache = mcubes.create_mesh_cache(cfg0, dev)
    reset_counts()
    run0, cadences = dict(reads=[], counts=[]), []
    for k, (d16, c8) in enumerate(frames):
        read_int.count = 0
        pipe0.process(d16, c8)
        run0["reads"].append(read_int.count)
        run0["counts"].append(launch_counts())
        if (k + 1) % MESH_EVERY and k + 1 < len(frames):
            continue
        dirty = int(pipe0.state.volume.mesh_dirty.sum())
        read_int.count = 0
        (vol0, cache), up_ms = events_ms(
            lambda: mcubes.update_mesh_cache(pipe0.state.volume, cache, cfg0), torch)
        up_reads = read_int.count
        pipe0.state.volume = vol0
        read_int.count = 0
        inc, dec_ms = events_ms(lambda: mcubes.cache_to_mesh(vol0, cache, cfg0), torch)
        most = int(cache.counts.max())
        drop256 = int(torch.clamp(cache.counts - cfg.mesh_slots, min=0).sum())
        cadences.append(dict(frame=k + 1, dirty_blocks=dirty, update_ms=up_ms,
                             update_reads=up_reads, decode_ms=dec_ms,
                             decode_reads=read_int.count, triangles=int(inc.count),
                             most_in_a_block=most, default_slots_would_drop=drop256))
        print(f"(b) frame {k + 1}: {dirty} dirty blocks, update {up_ms:.3f} ms "
              f"({up_reads} reads), decode {dec_ms:.3f} ms ({read_int.count} reads), "
              f"{int(inc.count)} triangles, at most {most} in a block ({drop256} over "
              f"{cfg.mesh_slots} slots)", flush=True)
        if most >= MESH_SLOTS:
            fail(f"(b) a block filled all {MESH_SLOTS} cache slots")
    k1, k2 = run0["counts"][-1]["bilateral"], run0["counts"][-1]["fill_smooth"]
    n, step_reads = len(frames), sum(run0["reads"])
    print(f"(b) {'graph' if pipe0.captured else 'eager'}: step host reads a frame "
          f"{run0['reads']}; K1 launches {k1}, K2 kernel launches {k2} over {n} frames "
          "on the card", flush=True)
    if pipe0.captured:
        check_graph_run("(b)", pipe0, run0, cfg0)
    else:
        check_eager_run("(b)", run0, cfg0)
        if step_reads != 2 * n:
            fail(f"(b) the step read {step_reads} times over {n} frames, expected 2 "
                 "a frame")
    full0 = pipe0.extract_mesh()
    if not int(full0.count) > 0:
        fail("(b) empty mesh")
    compare_meshes("(b) last decode vs full extraction", inc, full0, INC_POS_TOL,
                   INC_COLOR_TOL)
    report["incremental"] = dict(every=MESH_EVERY, cadences=cadences,
                                 step_reads_per_frame=step_reads / n,
                                 full_triangles=int(full0.count))
    del pipe0, cache, vol0, inc, full0

    # (c) PLY export and a snapshot from the card loaded on the CPU
    tmp = os.path.join(ROOT, "build", "chip_smoke_tmp")
    os.makedirs(tmp, exist_ok=True)
    ply = os.path.join(tmp, "orbit.ply")
    t0 = time.perf_counter()
    count = pipe.export_ply(ply)
    ply_ms = (time.perf_counter() - t0) * 1e3
    faces = len(read_ply(ply)[2])
    print(f"(c) export_ply: {count} triangles, {faces} faces read back, "
          f"{os.path.getsize(ply) / 2**20:.1f} MiB, {ply_ms:.1f} ms (host clock)", flush=True)
    if faces != count or count != n_tri:
        fail(f"(c) PLY holds {faces} faces, the mesh {count} (phase (a): {n_tri})")
    card = P.Volume(cfg, device=dev)
    card.state = vol
    snap = os.path.join(tmp, "orbit.npz")
    t0 = time.perf_counter()
    card.save(snap)
    save_ms = (time.perf_counter() - t0) * 1e3
    host = P.Volume(cfg, device="cpu")
    host.load(snap)
    for f in dc.fields(vol):
        if not torch.equal(getattr(vol, f.name).cpu(), getattr(host.state, f.name)):
            fail(f"(c) snapshot field {f.name} differs after the round trip")
    pose = poses[-1]
    r_card = P.Tracer(card).trace(cam, pose, h, w)
    r_host = P.Tracer(host).trace(cam, pose, h, w)
    vc, vh = r_card.valid.cpu(), r_host.valid
    both = vc & vh
    d_diff = (r_card.depth.cpu() - r_host.depth).abs()[both]
    valid_mismatch = float((vc != vh).float().mean())
    depth_off = float((d_diff > 1e-5).float().mean())
    print(f"(c) snapshot: save {save_ms:.1f} ms, {os.path.getsize(snap) / 2**20:.1f} MiB, "
          f"every array equal on the CPU; trace card vs CPU: valid mismatch "
          f"{valid_mismatch:.2e} (tol 1e-3), depth off by > 1e-5 m on {depth_off:.2e} "
          f"of pixels (tol 2e-3), max {float(d_diff.max()):.3e} m", flush=True)
    if not (float(vc.float().mean()) > 0.3 and valid_mismatch < 1e-3 and depth_off < 2e-3):
        fail("(c) the snapshot's trace on the CPU differs from the card's")
    report["ply_snapshot"] = dict(ply_ms=ply_ms, save_ms=save_ms, faces=faces,
                                  trace_valid_mismatch=valid_mismatch,
                                  trace_depth_off=depth_off)
    os.remove(ply)
    report["ply_snapshot"]["snapshot"] = snap    # phase 9 meshes it offline
    del card, host, r_card, r_host

    # (d) the five-class flow over the first 10 orbit frames
    n5 = 10
    volume = P.Volume(cfg, device=dev)
    integrator, tracer = P.Integrator(volume), P.Tracer(volume)
    tracker, extractor = P.DepthTracker(cfg, device=dev), P.Extractor(volume)
    before = launch_counts()
    integrator.integrate(P.make_frame(*metric_frame(*frames[0], cfg), cam, poses[0],
                                      device=dev))
    pose, est = poses[0].to(dev), [poses[0].translation.numpy()]
    t0 = time.perf_counter()
    for d16, c8 in frames[1:n5]:
        d, c = metric_frame(d16, c8, cfg)
        model = tracer.trace(cam, pose, h, w)
        pose = tracker.track(model, P.make_frame(d, c, cam, pose, device=dev),
                             init_pose=pose).pose
        integrator.integrate(P.make_frame(d, c, cam, pose, device=dev))
        est.append(pose.translation.cpu().numpy())
    torch.cuda.synchronize()
    flow_ms = (time.perf_counter() - t0) * 1e3 / (n5 - 1)
    made = launch_counts()
    k1, k2 = (made[k] - before[k] for k in ("bilateral", "fill_smooth"))
    gt = np.stack([p.translation.numpy() for p in poses[:n5]])
    ate = ate_rmse(np.stack(est), gt)
    m5 = extractor.extract()
    print(f"(d) five-class flow: ATE {ate:.6f} m over {n5} frames, {flow_ms:.3f} ms a "
          f"frame (trace + track + integrate), mesh {int(m5.count)} triangles; "
          f"K1 launches {k1} over {n5 - 1} tracks, K2 kernel launches {k2} over "
          f"{n5 - 1} traces", flush=True)
    if k1 != n5 - 1 or k2 != n5 - 1:
        fail("(d) K1 must launch once a track and K2 once a trace")
    if not ate < 0.01 or not int(m5.count) > 0:
        fail(f"(d) ATE {ate} m or an empty mesh")
    report["five_class"] = dict(frames=n5, ate_m=float(ate), ms_per_frame=flow_ms,
                                triangles=int(m5.count), k1_launches=k1,
                                k2_kernel_launches=k2)
    return report


MAPS = ("depth", "vx", "vy", "vz", "nx", "ny", "nz")
DENSE_N = 256                       # BASELINE config 2: a 256^3 dense grid
DENSE_ORIGIN = (-1.024, -1.024, -0.75)  # m: 2.048 m cube (8 mm voxels) over
                                        # the orbit's spheres and floor


def hold_render(label, got, want) -> dict:
    """A render on the card against the same call on a CPU copy, at the
    tests' tolerances (tests/test_torch_raycast.py ``assert_render_close``):
    masks on 99.9% of pixels, depth and vertices within 1e-5 m on 99.9% of
    the common ones, normals within 1e-3 on 98%, colour on 99.9%.  The
    card's transforms (cuBLAS) round differently from the CPU's, and the
    march's sample indices round those floats."""
    vg, vc = got.valid.cpu().numpy(), want.valid.numpy()
    both = vg & vc
    out = dict(valid_frac=float(vg.mean()), valid_mismatch=float(np.mean(vg != vc)))
    for name in MAPS:
        a, b = getattr(got, name).cpu().numpy()[both], getattr(want, name).numpy()[both]
        out[f"{name}_off"] = float(np.mean(np.abs(a - b) > (1e-3 if name[0] == "n" else 1e-5)))
    out["color_off"] = float(np.mean(np.any(got.color.cpu().numpy() != want.color.numpy(),
                                            axis=-1)))
    print(f"{label}: valid {out['valid_frac']:.4f} of pixels, mismatch "
          f"{out['valid_mismatch']:.2e} (tol 1e-3); depth off {out['depth_off']:.2e}, "
          f"normals off {max(out['nx_off'], out['ny_off'], out['nz_off']):.2e} (tol 2e-2), "
          f"colour off {out['color_off']:.2e}", flush=True)
    bad = (out["valid_frac"] < 0.3 or out["valid_mismatch"] > 1e-3
           or out["color_off"] > 1e-3
           or any(out[f"{m}_off"] > (2e-2 if m[0] == "n" else 1e-3) for m in MAPS))
    if bad:
        fail(f"{label}: the card and the CPU copy disagree beyond the tolerances")
    return out


def render_paths(P, torch, cfg, cam, poses, frames, pipe, dev) -> dict:
    """Phase 8: the render paths off the main line at 640x480, each a
    captured graph.  (a) the orbit under render_mode="march" in depth and
    combined mode; (b) the orbit in depth mode with splat_source="direct"
    and with splat_polish=2; (c) Tracer.trace of phase 3's final volume under the
    march (cross and gradient normals) and the splat with gradient
    normals, each against a CPU copy, and the direct against the surfel
    z-buffer; (d) the dense backend at 256^3 over the orbit's frames at
    their true poses.  Returns the printed numbers."""
    import dataclasses as dc

    from vulcan_tpu_torch.io.synthetic import render_scene_depth
    from vulcan_tpu_torch.ops import allocate, dense, splat
    from vulcan_tpu_torch.ops import blocks as B
    from vulcan_tpu_torch.utils.sync import read_int

    h, w = frames[0][0].shape
    report = {}
    t0 = time.perf_counter()

    def took(part):
        report[f"{part}_s"] = time.perf_counter() - t0
        print(f"phase 8 {part} took {report[f'{part}_s']:.1f} s", flush=True)

    # (a), (b): the orbit through each path, counts set to 0 around each.
    march = P.Config(render_mode="march")
    specs = [("orbit/march", march, "depth", 0), ("orbit/march, combined", march, "combined", 0),
             ("orbit/direct", P.Config(splat_source="direct"), "depth", 1),
             ("orbit/polish", P.Config(splat_polish=2), "depth", 1)]
    cells = [run_cell(P, torch, label, config, mode, cam, poses, frames, 0.01,
                      k2_per_frame=k2, no_failures=True)
             for label, config, mode, k2 in specs]
    report["cells"] = cells
    took("(a)-(b)")

    # (c) traces of phase 3's final volume, card against a CPU copy.
    state = pipe.state.volume
    cpu_state = B.VolumeState(**{f.name: getattr(state, f.name).cpu()
                                 for f in dc.fields(state)})
    pose = poses[-1]
    pose_d = pose.to(dev)
    traces = {}
    for label, over, normals in (("march/cross", dict(render_mode="march"), "cross"),
                                 ("march/gradient", dict(render_mode="march"), "gradient"),
                                 ("splat/gradient", {}, "gradient")):
        c = dc.replace(cfg, **over)
        renders = []
        for device, st in ((dev, state), (torch.device("cpu"), cpu_state)):
            vol = P.Volume(c, device=device)
            vol.state = st
            k2_0 = launch_counts()["fill_smooth"]
            read_int.count = 0
            r, ms = events_ms(lambda: P.Tracer(vol).trace(cam, pose, h, w,
                                                          normals=normals), torch)
            if device == dev:
                k2 = launch_counts()["fill_smooth"] - k2_0
                reads, card_ms = read_int.count, ms
            renders.append(r)
        traces[label] = dict(hold_render(f"(c) trace {label} card vs CPU", *renders),
                             ms=card_ms, k2_launches=k2, host_reads=reads)
        print(f"(c) trace {label}: {card_ms:.3f} ms on the card (CUDA events, host "
              f"included), {reads} host reads, K2 launches {k2}", flush=True)
        if k2 != (0 if over else 1):
            fail(f"(c) trace {label}: K2 launched {k2} times")
        del renders
    report["traces"] = traces

    # The direct source against the persistent surfels.  On phase 3's
    # volume (recorded, not judged) blocks whose surfel lists overflowed the
    # default slots lose voxels that the direct source still scatters; the
    # judged pair is the orbit's first 10 frames fused at their true poses
    # with 512 slots (no list can overflow), as tests/test_sparse.py
    # holds the reference: equal hit masks, depths within the surfels'
    # 14-bit tsdf step (the two are not bit-equal in either package).
    def direct_vs_surfels(state, c):
        vis = allocate.update_visibility(state, cam, pose_d, h, w, c)
        za = splat._splat_zbuf_direct(vis, cam, pose_d, h, w, c)
        zb = splat._splat_zbuf_surfels(vis, cam, pose_d, h, w, c)
        ids = vis.visible_ids[:int(vis.num_visible)].long()
        live = ((vis.tsdf[ids].abs() < B.surfel_band(c)) & (vis.weight[ids] > 0)).sum(1)
        hit, hit_b = torch.isfinite(za), torch.isfinite(zb)
        return dict(hits=int(hit.sum()), mask_mismatch=int((hit != hit_b).sum()),
                    blocks_over_slots=int((live > c.surfel_slots).sum()),
                    slots=c.surfel_slots,
                    max_dz_m=float((za - zb)[hit & hit_b].abs().max()))

    dvs = {"phase 3 volume": direct_vs_surfels(state, cfg)}
    c512 = dc.replace(cfg, surfel_slots=512)
    pipe512 = P.Pipeline(c512, cam, h, w, init_pose=poses[0], device=dev)
    for (d16, c8), p in zip(frames[:10], poses[:10]):
        pipe512.process(d16, c8, pose=p)
    dvs["10 frames, 512 slots"] = direct_vs_surfels(pipe512.state.volume, c512)
    for label, r in dvs.items():
        print(f"(c) direct vs surfel z-buffer, {label}: {r['hits']} hits, mask mismatch "
              f"{r['mask_mismatch']} pixels, {r['blocks_over_slots']} visible blocks over "
              f"{r['slots']} surfel slots, max |dz| {r['max_dz_m']:.3e} m", flush=True)
    r = dvs["10 frames, 512 slots"]
    if r["blocks_over_slots"] or r["mask_mismatch"] or not r["max_dz_m"] < 1e-5:
        fail("(c) the direct z-buffer differs from the surfel z-buffer beyond the "
             "surfels' tsdf step")
    report["direct_vs_surfels"] = dvs
    del pipe512, cpu_state
    took("(a)-(c)")

    # (d) the dense backend at 256^3 (BASELINE config 2), fused at the
    # orbit's true poses, raycast from the last one.
    n = DENSE_N
    vol = dense.create_dense_volume((n, n, n), DENSE_ORIGIN, device=dev)
    integ_ms = []
    for (d16, c8), p in zip(frames, poses):
        frame = P.make_frame(*metric_frame(d16, c8, cfg), cam, p, device=dev)
        vol, ms = events_ms(lambda: dense.integrate_dense(vol, frame, cfg), torch)
        integ_ms.append(ms)
    events_ms(lambda: dense.raycast_dense(vol, cam, pose_d, h, w, cfg), torch)  # warm
    ray_ms = []
    for _ in range(3):
        out, ms = events_ms(lambda: dense.raycast_dense(vol, cam, pose_d, h, w, cfg), torch)
        ray_ms.append(ms)
    true_d, _ = render_scene_depth(cam, pose, h, w, SPHERES, FLOOR, device=dev)
    p_true = pose_d.apply(cam.rays(h, w, dev) * true_d[..., None])
    vox = (p_true - vol.origin) / cfg.voxel_size
    inside = torch.all((vox >= 2) & (vox <= n - 3), dim=-1)
    gt_valid = (true_d > 0) & inside
    hit_d = out["valid"] & gt_valid
    hit_rate = float(hit_d.sum()) / max(int(gt_valid.sum()), 1)
    err = (out["depth"] - true_d).abs()[hit_d]
    d_rep = dict(shape=[n, n, n], mbytes=6 * n ** 3 * 4 / 1e6,
                 integrate_ms_median=float(np.median(integ_ms[N_WARM:])),
                 integrate_ms_p90=float(np.percentile(integ_ms[N_WARM:], 90)),
                 raycast_ms_median=float(np.median(ray_ms)),
                 valid_pixels=int(out["valid"].sum()), gt_valid_pixels=int(gt_valid.sum()),
                 hit_rate=hit_rate, depth_err_mean_m=float(err.mean()),
                 depth_err_median_m=float(err.median()))
    print(f"(d) dense {n}^3 ({d_rep['mbytes']:.1f} MB of 6 float32 channels): integrate "
          f"{d_rep['integrate_ms_median']:.3f} ms median p90 {d_rep['integrate_ms_p90']:.3f} "
          f"over {len(frames) - N_WARM} frames (CUDA events); raycast 640x480 "
          f"{d_rep['raycast_ms_median']:.3f} ms (median of 3); {d_rep['valid_pixels']} "
          f"valid pixels, {hit_rate:.4f} of the {d_rep['gt_valid_pixels']} whose true "
          f"surface lies in the grid; depth error mean {d_rep['depth_err_mean_m']:.6f} m "
          f"median {d_rep['depth_err_median_m']:.6f} m", flush=True)
    if not hit_rate >= 0.9:
        fail(f"(d) the dense raycast hit {hit_rate:.4f} of the true surface, not 90%")
    if not (torch.isfinite(out["depth"]).all() and d_rep["depth_err_mean_m"] < cfg.trunc_dist):
        fail("(d) the dense raycast's depth is off")
    report["dense"] = d_rep
    del vol, out
    return report


# --- phase 9: the entry points -------------------------------------------

CLI_TIMEOUT = 600  # s, one CLI subprocess


def write_png(path: str, img: np.ndarray) -> None:
    """A PNG of a uint16 (H, W) or uint8 (H, W, 3) array, written with the
    standard library's zlib: every row with the Up filter (its bytes minus
    the row above's)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    if img.dtype == np.uint16:
        raw, bit_depth, color_type = img.astype(">u2").view(np.uint8).reshape(h, -1), 16, 0
    else:
        raw, bit_depth, color_type = np.ascontiguousarray(img).reshape(h, -1), 8, 2
    up = np.diff(raw, axis=0, prepend=np.zeros((1, raw.shape[1]), np.uint8))
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, color_type,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def write_tum_sequence(root: str, frames, poses) -> None:
    """The frames as a TUM RGB-D sequence: depth/ and rgb/ PNGs at 30 Hz
    stamps, depth.txt, rgb.txt and groundtruth.txt (tx ty tz qx qy qz qw)."""
    from vulcan_tpu_torch.utils.evaluate import rotmat_to_quat

    os.makedirs(os.path.join(root, "depth"))
    os.makedirs(os.path.join(root, "rgb"))
    with open(os.path.join(root, "depth.txt"), "w") as fd, \
            open(os.path.join(root, "rgb.txt"), "w") as fr, \
            open(os.path.join(root, "groundtruth.txt"), "w") as fg:
        fg.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, ((d16, c8), pose) in enumerate(zip(frames, poses)):
            t = f"{1.0 + i / 30.0:.6f}"
            write_png(os.path.join(root, "depth", f"{i}.png"), d16)
            write_png(os.path.join(root, "rgb", f"{i}.png"), c8)
            fd.write(f"{t} depth/{i}.png\n")
            fr.write(f"{t} rgb/{i}.png\n")
            vals = [*pose.translation.numpy().tolist(),
                    *rotmat_to_quat(pose.rotation.numpy()).tolist()]
            fg.write(t + " " + " ".join(repr(float(v)) for v in vals) + "\n")


def start_cli(argv: list[str], counted: bool = True):
    """Start one CLI subprocess from the checkout's root: ``python -m
    vulcan_tpu_torch.tools.cli_counts`` (the CLI's ``main`` with the loop's
    counters) or, with ``counted=False``, ``python -m vulcan_tpu_torch.cli``.
    ``finish_cli`` waits for it."""
    module = "vulcan_tpu_torch.tools.cli_counts" if counted else "vulcan_tpu_torch.cli"
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), module, argv, counted


def finish_cli(run):
    """(report, counts or None, seconds) of a ``start_cli`` run; fails
    unless it exited 0."""
    proc, t0, module, argv, counted = run
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"`{module} {' '.join(argv)}` ran over {CLI_TIMEOUT} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(out[-3000:], err[-3000:], flush=True)
        fail(f"`{module} {' '.join(argv)}` exited {proc.returncode}")
    lines = [x for x in out.splitlines() if x.startswith("{")]
    if counted:
        return json.loads(lines[-2]), json.loads(lines[-1])["counts"], secs
    return json.loads(lines[-1]), None, secs


def check_cli_run(label, rep, counts, n, reads_per_frame, ate_limit, nodes) -> dict:
    """A CLI run's report and loop counts: every frame, no failure or
    overflow, the ATE under its limit, none of the host reads added by the
    loop; K1 and K2 once a frame on the card and, replayed, the conditional
    nodes ``nodes`` (``check_launches`` over the run's
    ``launches_by_frame``); on a captured pipeline no step read after the
    warm-up frames, on the eager path the step's ``reads_per_frame``.
    Returns its numbers."""
    from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

    fps = rep["fps"]
    steady = counts["step_ms"][N_WARM:]
    out = dict(frames=rep["frames"], fps=fps, ms_per_frame=1e3 / fps if fps else None,
               step_ms_median=float(np.median(steady)),
               ate_m=rep.get("ate_rmse_m"), track_failures=rep["track_failures"],
               allocated_blocks=rep["allocated_blocks"],
               step_reads_per_frame=counts["step_reads"] / max(counts["frames"], 1),
               loop_transfers=counts["loop_transfers"], loop_syncs=counts["loop_syncs"],
               loop_windows=counts["loop_windows"], mesh_calls=counts["mesh_calls"],
               mesh_reads=counts["mesh_reads"], k1_launches=counts["k1_launches"],
               k2_kernel_launches=counts["k2_launches"])
    print(f"{label}: {rep['frames']} frames, {fps} fps ({out['ms_per_frame']} ms a frame "
          f"after the first, unsynchronized; Pipeline.process's host ms median "
          f"{out['step_ms_median']:.3f} after {N_WARM} frames), ATE {out['ate_m']} m; "
          f"step host reads a frame {counts['step_reads_by_frame'][:4]}... "
          f"({'captured' if counts['captured'] else 'eager'}); the "
          f"loop's own transfers {out['loop_transfers']} and syncs {out['loop_syncs']} "
          f"over {out['loop_windows']} windows between steps; mesh calls "
          f"{out['mesh_calls']} ({out['mesh_reads']} reads); K1 {out['k1_launches']}, "
          f"K2 {out['k2_kernel_launches']} launches", flush=True)
    if rep["frames"] != n or counts["frames"] != n:
        fail(f"{label}: {rep['frames']} frames, expected {n}")
    if rep["track_failures"] or rep["alloc_overflow"] or rep["visible_overflow"]:
        fail(f"{label}: track failures or overflows in {rep}")
    if not (rep.get("ate_rmse_m") is not None and rep["ate_rmse_m"] < ate_limit):
        fail(f"{label}: ATE {rep.get('ate_rmse_m')} m not below {ate_limit} m")
    if counts["loop_transfers"]:
        fail(f"{label}: the loop read on the host ({counts})")
    check_launches(label, counts["launches_by_frame"], {"bilateral": 1, "fill_smooth": 1},
                   counts["captured"], nodes)
    if counts["captured"]:
        if sum(counts["step_reads_by_frame"][WARMUP_FRAMES:]):
            fail(f"{label}: a replayed step read on the host ({counts})")
    elif counts["step_reads"] != round(reads_per_frame * n):
        fail(f"{label}: the step read {counts['step_reads']} times over {n} frames, "
             f"expected {reads_per_frame} a frame")
    out["captured"] = counts["captured"]
    return out


def entry_points(P, torch, cfg, cam, poses, frames, dev, reads, snap, snap_tris) -> dict:
    """Phase 9: the CLI at 640x480 on the card, as subprocesses.  Phase 3's
    frames are first written as a TUM sequence (``write_png``).  Then, three
    at once on the card (their times are not measurements): (a) ``run
    --synthetic 35 --mesh-every 5`` with every output flag, ``--profile``
    and ``--trace-dir``, in combined (the default) and depth mode, ``run
    --dataset --known-poses`` and the ``mesh`` subcommand on phase 7's
    snapshot ``snap`` (``snap_tris`` triangles).  Alone, timed: (b) the native decoder and
    loader, the same frames through ``Pipeline`` in memory, and ``run
    --dataset`` tracked (its trajectory against the in-memory run).
    ``reads`` maps a mode to the step's host reads a frame.  Returns the
    printed numbers."""
    import shutil

    from vulcan_tpu_torch import native
    from vulcan_tpu_torch.io.tum import TumDataset
    from vulcan_tpu_torch.utils.evaluate import ate_rmse

    tmp = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    n = len(frames)
    report = {}
    gt = np.stack([p.translation.numpy() for p in poses])
    seq = os.path.join(tmp, "seq")
    t0 = time.perf_counter()
    write_tum_sequence(seq, frames, poses)
    write_s = time.perf_counter() - t0

    def dataset_argv(name):
        return ["run", "--dataset", seq, "--eval-ate", "--mesh-out",
                os.path.join(tmp, f"{name}.ply"), "--traj-out",
                os.path.join(tmp, f"{name}.txt")]

    def check_dataset(label, rep, counts, secs, want, tol, ref_name):
        at_pose = label == "known poses"
        out = check_cli_run(f"dataset/{label}", rep, counts, n,
                            reads["known poses" if at_pose else "combined"],
                            1e-4 if at_pose else 0.01, want_nodes(cfg, "combined", at_pose))
        traj = np.loadtxt(os.path.join(tmp, f"{label.replace(' ', '_')}.txt"),
                          comments="#", ndmin=2)
        wait = np.asarray(counts["feed_wait_ms"])
        diff = float(np.abs(traj[:, 1:4] - want).max())
        out.update(seconds=secs, feed_wait_ms_total=float(wait.sum()),
                   feed_wait_ms_median=float(np.median(wait)),
                   feed_wait_ms_max=float(wait.max()), max_traj_diff_m=diff,
                   traj_tol_m=tol, mesh_triangles=rep["mesh_triangles"])
        print(f"dataset/{label}: {secs:.1f} s in all; waited on the loader "
              f"{wait.sum():.3f} ms over {len(wait)} frames (median {np.median(wait):.3f}, "
              f"max {wait.max():.3f}); trajectory vs the {ref_name}: max |dt| "
              f"{diff:.3e} m (tol {tol:g}); {rep['mesh_triangles']} triangles", flush=True)
        if traj.shape != (n, 8) or not diff <= tol:
            fail(f"dataset/{label}: the trajectory differs beyond {tol} m")
        if abs(traj[1, 0] - (1.0 + 1 / 30.0)) > 1e-6:
            fail(f"dataset/{label}: the trajectory is not at the sensor's stamps")
        report[f"dataset/{label}"] = out

    # (a) three runs at once: the synthetic orbit in both modes, the
    # sequence at its true poses; then the mesh subcommand
    synth = {}
    for mode in ("combined", "depth"):
        path = {k: os.path.join(tmp, f"{mode}.{ext}")
                for k, ext in (("mesh", "ply"), ("snap", "npz"), ("traj", "txt"))}
        argv = ["run", "--synthetic", str(n), "--mesh-every", "5",
                "--mesh-out", path["mesh"], "--snapshot-out", path["snap"],
                "--traj-out", path["traj"], "--eval-ate", "--profile",
                "--trace-dir", os.path.join(tmp, f"trace_{mode}"), "--mode", mode]
        synth[mode] = (path, start_cli(argv))
    known = start_cli(dataset_argv("known_poses") + ["--known-poses"])
    mesh_run = start_cli(["mesh", snap, "--out", os.path.join(tmp, "offline.ply")],
                         counted=False)
    for mode in ("combined", "depth"):
        path, run = synth[mode]
        rep, counts, secs = finish_cli(run)
        out = check_cli_run(f"(a) synthetic/{mode} (3 runs sharing the card)", rep,
                            counts, n, reads[mode], 0.01, want_nodes(cfg, mode))
        with open(path["mesh"], "rb") as f:
            head = f.read(80)
        traj = np.loadtxt(path["traj"], comments="#", ndmin=2)
        trace_file = os.path.join(tmp, f"trace_{mode}", "trace.json")
        with open(trace_file, "rb") as f:
            body = f.read()
        # A traced step is a launch of K1 (a replayed graph's steps carry no
        # stage ranges; the eager steps' preprocess ranges are counted too).
        kernels_in_trace = [e["name"] for e in json.loads(body).get("traceEvents", [])
                            if e.get("cat") == "kernel"]
        steps = sum("bilateral_kernel" in k for k in kernels_in_trace)
        ranges = body.count(b'"name": "vulcan.preprocess"')
        has_kernels = bool(kernels_in_trace)
        out.update(seconds=secs, stage_ms=rep["stage_ms"],
                   mesh_extractions=rep["mesh_extractions"],
                   mesh_triangles_online=rep["mesh_triangles_online"],
                   mesh_triangles=rep["mesh_triangles"],
                   trace_mb=len(body) / 2**20, traced_steps=steps,
                   traced_preprocess_ranges=ranges)
        print(f"(a) synthetic/{mode}: {secs:.1f} s in all; stage_ms {rep['stage_ms']} "
              f"(synchronized); {rep['mesh_extractions']} online meshes, last "
              f"{rep['mesh_triangles_online']} triangles, final {rep['mesh_triangles']}; "
              f"PLY header {head.splitlines()[2]!r}; trajectory {traj.shape}; trace "
              f"{len(body) / 2**20:.1f} MiB, {steps} steps (K1 launches), {ranges} "
              f"preprocess ranges, kernel events {has_kernels}", flush=True)
        if b"comment vulcan-tpu mesh (native)" not in head:
            fail(f"(a) {mode}: the PLY was not written by the native welder")
        if traj.shape != (n, 8) or rep["mesh_extractions"] != n // 5:
            fail(f"(a) {mode}: trajectory {traj.shape} or {rep['mesh_extractions']} meshes")
        if not has_kernels or steps < 3:
            fail(f"(a) {mode}: the profiler trace holds no kernel or fewer than 3 steps")
        report[f"synthetic/{mode}"] = out
    rep, counts, secs = finish_cli(known)
    check_dataset("known poses", rep, counts, secs, gt, 1e-6, "ground truth")
    rep, _, secs = finish_cli(mesh_run)
    with open(os.path.join(tmp, "offline.ply"), "rb") as f:
        head = f.read(80)
    print(f"(a) mesh subcommand on phase 7's snapshot: {rep['mesh_triangles']} "
          f"triangles (phase 7: {snap_tris}), {rep['allocated_blocks']} blocks, "
          f"{secs:.1f} s", flush=True)
    if rep["mesh_triangles"] != snap_tris or b"(native)" not in head:
        fail("(a) the mesh subcommand's mesh differs from phase 7's extraction")
    report["mesh_subcommand"] = dict(seconds=secs, triangles=rep["mesh_triangles"])

    # (b) alone: the decoder, the loader, the frames in memory, the CLI
    ds = TumDataset(seq)
    d0, c0, _ = ds.load(0)
    if not (np.array_equal(d0, frames[0][0].astype(np.float32) / np.float32(5000.0))
            and np.array_equal(c0, frames[0][1].astype(np.float32) / np.float32(255.0))):
        fail("(b) the decoded frame differs from the frame written")
    t0 = time.perf_counter()
    for ref in ds.frames:
        native.decode_depth(ref.depth_path, 640, 480)
        native.decode_rgb(ref.rgb_path, 640, 480)
    decode_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    got = sum(1 for _ in ds)
    loader_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"(b) TUM sequence of {n} frames written in {write_s:.1f} s; native decode "
          f"{decode_ms:.3f} ms a 640x480 depth+rgb frame on one thread; the prefetch "
          f"loader (2 threads, 4 slots) {loader_ms:.3f} ms a frame over {got}", flush=True)
    # The same frames through Pipeline in memory (uint16/uint8), timed as the
    # CLI times: frame 0 off the clock, one sync at the end.
    pipe = P.Pipeline(cfg, cam, 480, 640, init_pose=poses[0], mode="combined", device=dev)
    est, step_ms = [], []
    for k, (d16, c8) in enumerate(frames):
        t1 = time.perf_counter()
        pipe.process(d16, c8)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        est.append(pipe.pose.translation.clone())   # the graph's buffer: a copy
        if k == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    est = torch.stack(est).cpu().numpy()
    mem_step = float(np.median(step_ms[N_WARM:]))
    print(f"(b) in memory: Pipeline.process, combined, {mem_ms:.3f} ms a frame after "
          f"the first (unsynchronized, as the CLI counts); its host ms median "
          f"{mem_step:.3f} after {N_WARM} frames", flush=True)
    report["tum"] = dict(frames=n, write_s=write_s, decode_ms=decode_ms,
                         loader_ms=loader_ms, in_memory_ms_per_frame=mem_ms,
                         in_memory_step_ms_median=mem_step,
                         ate_in_memory_m=float(ate_rmse(est, gt)))
    rep, counts, secs = finish_cli(start_cli(dataset_argv("tracked")))
    check_dataset("tracked", rep, counts, secs, est, AGREE_TOL, "in-memory run")
    shutil.rmtree(tmp)
    return report


def sharded_step(P, torch, cfg, cam, poses, frames, dev, k=10) -> dict:
    """Phase 10: the row-sharded step on 2 gloo ranks sharing the card, on
    the orbit's first ``k`` frames under the default Config (depth mode),
    against the single-process step on the same frames
    (tests/test_parallel.py's tolerances, and the last frame's inliers at
    each pyramid level within 1%); every rank's pose bit-identical, the
    same host reads on every rank, K1/K2 once a frame in each and the
    track's H1a, H1b and H1c (no fused step: the reducer sits between the
    rows and the solve) as ``track_launches(sharded=True)``.  Also
    times the all-gather that opens each step, whole and for the frame's
    rows alone: the rest is the model maps' round trip."""
    from vulcan_tpu_torch.parallel import sharding
    from vulcan_tpu_torch.utils.sync import read_int

    t0 = time.perf_counter()
    ranks = sharding.run_ranks(2, sharding.run_frames,
                               (cfg, cam, frames[:k], poses[0], "depth"), device="cuda")
    spawn_s = time.perf_counter() - t0
    read_int.count = 0
    pipe, est, ms, _, _ = run_pipeline(P, cfg, cam, poses[:k], frames[:k], 480, 640,
                                       dev, torch.cuda.synchronize, eager=True)
    reads = read_int.count
    r0 = ranks[0]
    same = all(np.array_equal(r["rotation"], r0["rotation"])
               and np.array_equal(r["translation"], r0["translation"])
               and np.array_equal(r["tsdf"], r0["tsdf"]) for r in ranks[1:])
    s = pipe.state
    nf1, nfn = int(s.volume.free_count), r0["free_count"]
    dt = float(np.abs(est - r0["translation"]).max())
    v1, vn = s.model.valid.cpu().numpy(), r0["valid"]
    both = v1 & vn
    dq = float(np.quantile(np.abs(s.model.depth.cpu().numpy()[both] - r0["depth"][both]),
                           0.99))
    # The ranks return the tsdf rows below their free count (the rest is
    # untouched in both runs); rows only one run allocated count as off.
    # The track's inliers at each level after the last frame: a rank that
    # summed rows it does not own would scale them (2x for two ranks).  The
    # poses part by up to ~7e-5 m over the 10 frames (the sums' order), and
    # the counts with them: 0.067% at most on the H100, held to 1%.
    lv1, lvn = s.track_level_inliers.cpu().numpy(), r0["level_inliers"][-1]
    t1, m = s.volume.tsdf.cpu().numpy(), min(nf1, nfn)
    tsdf_off = float(((np.abs(t1[:m] - r0["tsdf"][:m]) > 1e-3).sum()
                      + abs(nf1 - nfn) * t1.shape[1]) / t1.size)
    out = dict(ranks=2, frames=k, spawn_and_run_s=spawn_s,
               rank_ms_median=[float(np.median(r["ms"][1:])) for r in ranks],
               single_ms_median=float(np.median(ms[1:])),
               gather_ms=[r["gather_ms"] for r in ranks],
               frame_gather_ms=[r["frame_gather_ms"] for r in ranks],
               level_inliers=lvn.tolist(), single_level_inliers=lv1.tolist(),
               ranks_bit_identical=same, reads=[r["reads"] for r in ranks],
               single_reads=reads, k1=[r["k1_launches"] for r in ranks],
               k2=[r["k2_launches"] for r in ranks],
               track=[r["track_launches"] for r in ranks], max_translation_diff_m=dt,
               free_count=[nf1, nfn], valid_mismatch=float((v1 != vn).mean()),
               depth_diff_q99_m=dq, tsdf_off_frac=tsdf_off,
               failures=[r["track_failures"] for r in ranks],
               overflow=[r["overflow"] for r in ranks])
    print(f"2 ranks on one card over gloo, {k} frames: ms/frame median "
          f"{out['rank_ms_median']} (synchronized; single process "
          f"{out['single_ms_median']:.3f}); the all-gather that opens a step "
          f"{out['gather_ms']} ms, of it the frame's rows alone {out['frame_gather_ms']} "
          f"ms; {spawn_s:.1f} s spawn to results; poses, "
          f"tsdf bit-identical across ranks {same}; host reads {out['reads']} (single "
          f"{reads}); K1 {out['k1']}, K2 {out['k2']}, track {out['track']}; against "
          f"the single process: "
          f"level inliers {out['level_inliers']} vs {out['single_level_inliers']} "
          f"(tol 1%), max "
          f"|dt| {dt:.3e} m (tol 1e-3), free count {nf1} vs {nfn}, valid mismatch "
          f"{out['valid_mismatch']:.2e} (tol 0.05), depth q99 {dq:.3e} m (tol "
          f"{cfg.voxel_size}), tsdf off by > 1e-3 on {tsdf_off:.2e} (tol 0.1)", flush=True)
    if not same or len(set(out["reads"])) != 1 or out["reads"][0] != reads:
        fail("the ranks disagree with each other or with the single process's reads")
    if out["k1"] != [k, k] or out["k2"] != [k, k]:
        fail(f"K1/K2 launches a rank {out['k1']} / {out['k2']}, expected {k} each")
    # The sharded track keeps H1b, the reducer, then H1c: no fused step.
    want_track = {name: k * v for name, v in track_launches(cfg, sharded=True).items()}
    if any(r["track_launches"] != want_track for r in ranks):
        fail(f"track launches a rank {out['track']}, expected {want_track} each")
    if any(out["failures"]) or any(out["overflow"]):
        fail("a track failure or overflow in a rank")
    if not (dt < 1e-3 and abs(nf1 - nfn) <= 0.05 * max(nf1, nfn)
            and (lv1 > 0).all() and (np.abs(lvn - lv1) <= 1e-2 * lv1).all()
            and out["valid_mismatch"] < 0.05 and both.sum() > 1000
            and dq < cfg.voxel_size and tsdf_off < 0.1):
        fail("the sharded step differs from the single-process step")
    return out


def main() -> None:
    want_parity = "--parity" in sys.argv[1:]
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
    from vulcan_tpu_torch.tools.timing import device_ms
    from vulcan_tpu_torch.utils.evaluate import ate_rmse
    from vulcan_tpu_torch.io.synthetic import orbit_poses

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device {name} capability {torch.cuda.get_device_capability(0)} "
          f"count {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")

    phase("1 build")
    import threading

    from vulcan_tpu_torch import native

    # g++ builds the native runtime (PNG decode, loader, PLY welder) while
    # nvcc builds the kernels.
    built = {}
    host = threading.Thread(target=lambda: built.update(path=native.build(),
                                                        s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    host.start()
    path = cuda_kernels.build()
    cuda_kernels.load()
    host.join()
    if "path" not in built:
        fail("the native runtime did not build")
    native.load()
    print(f"built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s, "
          f"{os.path.relpath(built['path'], ROOT)} in {built['s']:.2f} s", flush=True)
    for line in cuda_kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    phase("2 kernels against plain versions (480x640)")
    cfg = P.Config()
    n = N_WARM + N_TIMED
    cam = P.PinholeCamera.tum_default()
    poses = orbit_poses(n, radius=1.6, height=0.35, span=min(6.28, n * 0.05))
    frames = make_frames(P, cam, poses, 480, 640, dev)
    rng = np.random.default_rng(0)
    d1 = rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32)
    d1[rng.random((480, 640)) < 0.10] = 0.0
    d2 = rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32)
    d2[rng.random((480, 640)) < 0.25] = np.inf
    x1 = torch.from_numpy(d1).to(dev)
    x2 = torch.from_numpy(d2).to(dev)
    image_bytes = 2 * x1.numel() * 4          # one image in, one out
    taps = (2 * cfg.bilateral_radius + 1) ** 2
    # A process's first few hundred launches read slow on the host clock
    # (the first kernel measured paid 18.5 us a call where it paid 12.7 once
    # warm): run the launch path warm before anything is timed.
    for _ in range(300):
        preprocess.bilateral_filter(x1, cfg)
        splat._fill_and_smooth(x2, cfg)
    torch.cuda.synchronize()
    kernels = [
        check_kernel(dict(
            name="bilateral", tol=K1_TOL, source="vulcan_tpu_torch/csrc/bilateral.cu",
            replaces="vulcan_tpu/ops/preprocess.py:116",
            call=lambda: preprocess.bilateral_filter(x1, cfg),
            count=card_count("bilateral"),
            plain=lambda: preprocess._bilateral_math(x1, cfg),
            # per tap of the function: sub, mul, mul, exp, mul, select, mul, 2 adds,
            # compare (the kernel folds some of them; the bound counts the function's)
            bytes=image_bytes, ops=x1.numel() * (taps * 10 + 3),
            also=[("own arithmetic in PyTorch",
                   lambda: preprocess._bilateral_math_folded(x1, cfg))],
        ), torch),
        check_kernel(dict(
            name="fill_smooth", tol=K2_TOL, source="vulcan_tpu_torch/csrc/fill_smooth.cu",
            replaces="vulcan_tpu/ops/splat.py:606",
            call=lambda: splat._fill_and_smooth(x2, cfg),
            count=card_count("fill_smooth"),
            plain=lambda: splat._fill_smooth_math(x2, cfg),
            bytes=image_bytes, ops=x2.numel() * fill_smooth_ops(cfg.splat_fill_rounds),
        ), torch),
    ]

    print(f"launch floor: {device_ms(lambda: torch.cuda._sleep(1)):.6f} ms device time "
          "per launch of a kernel that does nothing", flush=True)
    k1_inputs_and_radii(P, preprocess, torch, dev, frames[0][0])
    k2_rounds_and_shapes(P, splat, torch, dev)
    kernels += track_kernels(P, torch, dev, cam, poses, frames)
    kernels += graph_node_kernels(torch, dev)
    kernels += range_image_kernel(P, torch, dev, cam, poses, frames)
    kernels += integrate_kernel(P, torch, dev, cam, poses)
    kernels += splat_zbuf_kernel(P, torch, dev, cam)

    phase("3 main path: Pipeline.process, default Config, depth mode, 480x640")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pipe, est, ms, armed, run = run_pipeline(
        P, cfg, cam, poses, frames, 480, 640, dev, torch.cuda.synchronize
    )
    launches = run["counts"][-1]
    h1 = {k: launches[k] for k in H1_ENTRIES}
    k2_kernel_launches = launches["fill_smooth"]
    reads = sum(run["reads"])
    gt = np.stack([p.translation.numpy() for p in poses])
    ate = ate_rmse(est, gt)
    diag = pipe.diagnostics()
    timed = np.asarray(ms[N_WARM:])
    depth = pipe.state.model.depth
    print(f"ms/frame median {np.median(timed):.3f} p90 {np.percentile(timed, 90):.3f} "
          f"(first frame {ms[0]:.1f} ms, warm-up {N_WARM}, timed {N_TIMED}, "
          "synchronized per frame)", flush=True)
    print(f"path {'graph' if pipe.captured else 'eager'} {pipe.graph_stats}; host reads "
          f"a frame {run['reads']}; launches on the card {launches} over {n} frames, "
          f"by frame {per_frame(run['counts'])}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    print("diagnostics", json.dumps(diag), flush=True)
    print(f"ATE {ate:.6f} m over {n} frames", flush=True)
    replayed = check_graph_run("orbit/depth", pipe, run, cfg)
    print(f"launches a replayed frame on the card {replayed}", flush=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_replayed_frame"] = replayed[k["name"]]
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
    # The same run with the track's entry points on their plain versions
    # (PyTorch on the card): the kernels must not move the trajectory.
    with plain_track():
        _, est_plain, ms_plain, _, plain_run = run_pipeline(
            P, cfg, cam, poses, frames, 480, 640, dev, torch.cuda.synchronize)
    if any(plain_run["counts"][-1][k] != v for k, v in h1.items()):
        fail("the plain-path run launched a track kernel")
    ate_plain = ate_rmse(est_plain, gt)
    plain_dt = float(np.abs(est - est_plain).max())
    print(f"plain track on the card: ATE {ate_plain:.6f} m (kernels {ate:.6f}, "
          f"|dATE| {abs(ate - ate_plain):.3e} m, tol {PLAIN_ATE_TOL:g}), max per-frame "
          f"translation difference {plain_dt:.3e} m, ms/frame median "
          f"{np.median(ms_plain[N_WARM:]):.3f}", flush=True)
    if not abs(ate - ate_plain) < PLAIN_ATE_TOL:
        fail(f"ATE through the kernels {ate} m is not within {PLAIN_ATE_TOL} m of the "
             f"plain path's {ate_plain} m")
    cells = [dict(cell="orbit/depth", mode="depth", frames=n,
                  path="graph" if pipe.captured else "eager",
                  graph=pipe.graph_stats, host_reads_by_frame=run["reads"],
                  ms_median=float(np.median(timed)),
                  ms_p90=float(np.percentile(timed, 90)), ate_m=float(ate),
                  armed_frames=int(armed), host_reads_per_frame=reads / n,
                  k1_launches=launches["bilateral"], k2_kernel_launches=k2_kernel_launches,
                  h1_launches=h1, launches_per_replayed_frame=replayed,
                  ate_plain_track_m=float(ate_plain),
                  plain_track_max_dt_m=plain_dt,
                  plain_track_ms_median=float(np.median(ms_plain[N_WARM:])),
                  track_failures=diag["track_failures"],
                  degen_frames=diag["track_degen_frames"])]

    phase("3b photometric paths: combined, auto-photo armed, desk (480x640)")
    cells += [
        run_cell(P, torch, "orbit/combined", cfg, "combined", cam, poses, frames,
                 0.01),
        run_cell(P, torch, "orbit/depth, auto_photo_enter=0.99",
                 P.Config(auto_photo_enter=0.99), "depth", cam, poses, frames,
                 0.01, must_arm=True),
    ]
    # bench.py's desk scene: 5 warm-up + 240 frames over one full orbit.
    desk_poses = orbit_poses(245, center=(0.0, 0.0, -0.25), radius=1.5,
                             height=0.55, span=2.0 * np.pi)
    desk_frames = make_desk_frames(P, cam, desk_poses, 480, 640, dev)
    cells.append(run_cell(P, torch, "desk/combined", cfg, "combined", cam,
                          desk_poses, desk_frames, DESK_ATE))
    if want_parity:
        for mode in ("light", "depth"):
            cells.append(run_cell(P, torch, f"desk/{mode}", cfg, mode, cam,
                                  desk_poses, desk_frames, None))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "cells.json"), "w") as f:
        json.dump(dict(device=smi, cells=cells), f, indent=1)

    phase("3c the captured graph against the eager step (480x640)")
    armed_cfg = P.Config(auto_photo_enter=0.99)
    march = P.Config(render_mode="march")
    graph_specs = [("orbit/depth", cfg, "depth", poses, frames, 0.01),
                   ("orbit/combined", cfg, "combined", poses, frames, 0.01),
                   ("orbit/depth, auto_photo_enter=0.99", armed_cfg, "depth", poses,
                    frames, 0.01),
                   ("orbit/color", cfg, "color", poses, frames, None),
                   ("orbit/known poses", cfg, "depth", poses, frames, 1e-6, True),
                   ("desk/combined", cfg, "combined", desk_poses, desk_frames, DESK_ATE),
                   ("orbit/march", march, "depth", poses, frames, 0.01, False, 0),
                   ("orbit/march, combined", march, "combined", poses, frames, 0.01,
                    False, 0),
                   ("orbit/direct", P.Config(splat_source="direct"), "depth", poses,
                    frames, 0.01),
                   ("orbit/polish", P.Config(splat_polish=2), "depth", poses, frames,
                    0.01)]
    if want_parity:
        graph_specs += [("desk/light", cfg, "light", desk_poses, desk_frames, None),
                        ("desk/depth", cfg, "depth", desk_poses, desk_frames, None)]
    graph_cells = [graph_against_eager(P, torch, label, config, mode, cam, cell_poses,
                                       cell_frames, dev, ate, *rest)
                   for label, config, mode, cell_poses, cell_frames, ate, *rest
                   in graph_specs]
    if not graph_cells[2]["armed_frames"]["graph"]:
        fail("phase 3c: auto-photo never armed in the graph")
    del desk_frames
    with open(os.path.join(OUT_DIR, "graph.json"), "w") as f:
        json.dump(dict(device=smi, cells=graph_cells), f, indent=1)

    phase("4 card vs CPU agreement (port, 120x160, 6 frames, depth and combined)")
    small = P.Config(num_blocks=8192, hash_size=32768, max_visible=4096,
                     voxel_size=0.015, trunc_dist=0.06, depth_max=4.0)
    scam = P.PinholeCamera.create(130.0, 130.0, 79.5, 59.5)
    sposes = orbit_poses(6, radius=1.6, height=0.35, span=0.3)
    sframes = make_frames(P, scam, sposes, 120, 160, torch.device("cpu"))
    for mode in ("depth", "combined"):
        _, est_gpu, _, _, _ = run_pipeline(P, small, scam, sposes, sframes, 120, 160,
                                           dev, torch.cuda.synchronize, mode)
        _, est_cpu, _, _, _ = run_pipeline(P, small, scam, sposes, sframes, 120, 160,
                                           torch.device("cpu"), None, mode)
        diff = float(np.abs(est_gpu - est_cpu).max())
        print(f"{mode}: max per-frame translation difference card vs CPU "
              f"{diff:.3e} m (tol {AGREE_TOL:g})", flush=True)
        if not diff <= AGREE_TOL:
            fail(f"the port on the card and on the CPU disagree in {mode} mode")

    phase("6 probes: T1-T5 against plain versions, then the probe entry points")
    kernels += probes(P, torch, dev)

    phase("7 mesh and API: extraction, incremental meshing, PLY, snapshot, five classes")
    t0 = time.perf_counter()
    mesh_report = mesh_and_api(P, torch, cfg, cam, poses, frames, pipe, dev)
    mesh_report["phase_s"] = time.perf_counter() - t0
    print(f"phase 7 took {mesh_report['phase_s']:.1f} s", flush=True)
    with open(os.path.join(OUT_DIR, "mesh.json"), "w") as f:
        json.dump(dict(device=smi, **mesh_report), f, indent=1)

    phase("8 render paths: march, direct, polish, traces, dense 256^3 (480x640)")
    t0 = time.perf_counter()
    render_report = render_paths(P, torch, cfg, cam, poses, frames, pipe, dev)
    render_report["phase_s"] = time.perf_counter() - t0
    print(f"phase 8 took {render_report['phase_s']:.1f} s", flush=True)
    with open(os.path.join(OUT_DIR, "render.json"), "w") as f:
        json.dump(dict(device=smi, **render_report), f, indent=1)

    phase("9 entry points: the CLI at 640x480 (synthetic, mesh, a TUM sequence)")
    t0 = time.perf_counter()
    # The eager step's host reads a frame (phase 3c): the integrate chunk
    # count with the auto-photo render's branch, and in depth mode the
    # auto-photo track's branch (S1 reads nothing on the host).
    cli_report = entry_points(P, torch, cfg, cam, poses, frames, dev,
                              {"depth": 2.0, "known poses": 1.0, "combined": 1.0},
                              mesh_report["ply_snapshot"]["snapshot"],
                              mesh_report["full"]["triangles"])
    os.remove(mesh_report["ply_snapshot"].pop("snapshot"))
    cli_report["phase_s"] = time.perf_counter() - t0
    print(f"phase 9 took {cli_report['phase_s']:.1f} s", flush=True)

    phase("10 the row-sharded step: 2 gloo ranks on one card (480x640, 10 frames)")
    t0 = time.perf_counter()
    cli_report["sharded"] = sharded_step(P, torch, cfg, cam, poses, frames, dev)
    cli_report["sharded"]["phase_s"] = time.perf_counter() - t0
    print(f"phase 10 took {cli_report['sharded']['phase_s']:.1f} s", flush=True)
    with open(os.path.join(OUT_DIR, "entry.json"), "w") as f:
        json.dump(dict(device=smi, **cli_report), f, indent=1)

    if any(m.split(".")[0] in ("jax", "vulcan_tpu", "cv2") for m in sys.modules):
        fail("JAX, the JAX package or OpenCV was imported")
    print(f"device: {smi}", flush=True)   # again, inside the output's tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
