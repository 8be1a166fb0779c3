"""Run one cell of the benchmark of ``vulcan_tpu_torch`` once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process: set-up (the cell's frames
from the seed, the ``Pipeline``, warm-up frames that build the kernels
and capture the step's CUDA graph), a closed-loop window of ``--seconds``
in which each frame is handed over as host uint16 depth and uint8 rgb
arrays and the next one only once the frame's pose is on the host, then
the comparison with the plain references by the checks the cell's
configuration names (``check.py``, ``checks/``), and one JSON line on
standard output.  ``--trace 1`` reports the per-layer metrics
(``metrics/``) instead of the end-to-end ones, from the same window (the
``Pipeline`` built traced: its spans of the window's frames) and a
profiled span after it.  Without a CUDA card, or with fewer than the
cell asks for, it prints no result and exits 2; a configuration its
checks refuse stops the run before set-up.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import check, scene, spec, trace  # noqa: E402
from .roofline import track_bound_s  # noqa: E402

WARM_FRAMES = 15       # 2 eager, the capture, then replays
THROWAWAY_FRAMES = 5   # profiled and dropped: CUPTI misreads a first window
PROFILED_FRAMES = 40
TRACK_FRAMES = 3       # frames after the window whose track is compared
FORBIDDEN = ("jax", "jaxlib", "flax", "vulcan_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def build_config(cfg: dict):
    from vulcan_tpu_torch.config import Config

    s = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["settings"].items()}
    return Config(**s)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


@dataclasses.dataclass
class Record:
    """What the loop keeps of every frame of the run (warm-up, window and
    profiled frames alike), filled in place."""

    rot: np.ndarray
    trans: np.ndarray
    failures: np.ndarray
    degenerate: np.ndarray
    n: int = 0

    @staticmethod
    def empty(capacity: int) -> "Record":
        return Record(np.zeros((capacity, 3, 3), np.float32), np.zeros((capacity, 3), np.float32),
                      np.zeros(capacity, np.int64), np.zeros(capacity, np.int64))

    def add(self, vec: np.ndarray) -> None:
        if self.n == len(self.failures):
            grow = Record.empty(self.n)
            for f in ("rot", "trans", "failures", "degenerate"):
                setattr(self, f, np.concatenate([getattr(self, f), getattr(grow, f)]))
        self.rot[self.n] = vec[:9].reshape(3, 3)
        self.trans[self.n] = vec[9:12]
        self.failures[self.n] = int(vec[12])
        self.degenerate[self.n] = int(vec[13])
        self.n += 1

    def arrays(self) -> dict:
        return {f: getattr(self, f)[: self.n] for f in ("rot", "trans", "failures", "degenerate")}


class Loop:
    """The closed loop of one pipeline over one stream."""

    def __init__(self, cell: spec.Cell, stream: scene.Stream, pipe, torch):
        self.stream = stream
        self.pipe = pipe
        self.torch = torch
        self.known = bool(cell.traffic.get("known_pose"))
        self.poses = None
        if self.known:
            from vulcan_tpu_torch.core.se3 import SE3

            self.poses = [SE3(torch.from_numpy(stream.rotation[k]),
                              torch.from_numpy(stream.translation[k]))
                          for k in range(len(stream))]
        self.i = 0
        self.record = Record.empty(4096)
        self.label = None       # ``record_function`` while a span is profiled

    def readout(self):
        s = self.pipe.state
        p = s.model.pose
        return self.torch.cat((p.rotation.reshape(9), p.translation,
                               s.track_failures.reshape(1).float(),
                               s.track_degen_frames.reshape(1).float()))

    def frame(self) -> tuple[float, float]:
        """One frame: (the call into ``process``, the frame's latency), s."""
        d16, c8 = self.stream.frame(self.i)
        pose = self.poses[self.i % len(self.stream)] if self.known else None
        t0 = time.perf_counter()
        if self.label is None:
            self.pipe.process(d16, c8, pose=pose)
            t1 = time.perf_counter()
            vec = self.readout().cpu().numpy()
        else:
            with self.label(trace.HOST_PROCESS):
                self.pipe.process(d16, c8, pose=pose)
            t1 = time.perf_counter()
            with self.label(trace.HOST_POSE):
                vec = self.readout().cpu().numpy()
        t2 = time.perf_counter()
        self.record.add(vec)
        self.i += 1
        return t1 - t0, t2 - t0


def profile_span(loop: Loop, frames: int, card) -> dict:
    """``frames`` frames under ``torch.profiler``: the device spans, the
    host's labelled ranges, the span's host-clock length, and the counted
    kernels' launches on the card and in the trace."""
    from torch.profiler import profile, record_function

    before = card.counts()
    loop.label = record_function
    with profile(activities=card.activities()) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            loop.frame()
        card.sync()
        wall_s = time.perf_counter() - t0
    loop.label = None
    after = card.counts()
    dev = trace.device_spans(prof)
    return {"frames": frames, "device": dev, "host": trace.host_ranges(prof), "wall_s": wall_s,
            "card": {k: after[k] - before[k] for k in after},
            "traced": trace.kernel_counts(dev)}


def check_trace(span: dict, metrics, root=spec.ROOT) -> None:
    """Raise unless the trace holds every launch that the card's own
    counters saw of each counted kernel that a reported metric reads from
    the trace (its reader's ``TRACED``): a trace that dropped some would
    give a partial number."""
    need = {k for m in metrics for k in spec.traced_kernels(m["name"], root)}
    short = {k: (span["traced"][k], span["card"][k]) for k in need
             if span["traced"][k] < span["card"][k]}
    if short:
        raise RuntimeError(f"the trace lacks counted kernel launches (traced, card): {short}")


class Card:
    """What a run reads of the CUDA card it runs on: the program's launch
    counters, the profiler's activities, the memory peak and the card's
    name and power limit."""

    device = "cuda"

    def __init__(self):
        import torch

        from vulcan_tpu_torch.ops import cuda_kernels

        self.torch = torch
        self.counts = cuda_kernels.launch_counts

    def activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated())

    def free(self) -> None:
        self.torch.cuda.empty_cache()

    def info(self, peak: int) -> dict:
        return {"platform": "gpu", "kind": self.torch.cuda.get_device_name(), "count": 1,
                "memory_peak_bytes": peak, "power_limit": power_limit()}


def window_spans(pipe, stop: int) -> dict | None:
    """The program's spans (``Pipeline.trace_spans``) of the window's
    frames, which end before frame ``stop``: all of them, or the last
    ``RING_FRAMES`` where the window ran more than the ring holds."""
    from vulcan_tpu_torch.utils.timing import RING_FRAMES

    return pipe.trace_spans(max(WARM_FRAMES, stop - RING_FRAMES), stop)


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, control: bool = False,
            card: Card | None = None) -> dict:
    """One run of ``cell`` on ``card`` (the CUDA card when None); returns
    the result line's object.  ``control`` adds the bfloat16 control's
    numbers beside the program's and whether they pass
    (``control_correct``; ``calibrate.py``)."""
    import torch

    from vulcan_tpu_torch.core.camera import PinholeCamera
    from vulcan_tpu_torch.core.se3 import SE3
    from vulcan_tpu_torch.pipeline.api import Pipeline

    card = card or Card()
    plan = check.prepare(cell)
    conf = cell.config
    sensor = conf["sensor"]
    config = build_config(conf)
    stream = scene.make_stream(cell.traffic, sensor, seed, card.device)
    cam = PinholeCamera.create(sensor["fx"], sensor["fy"], sensor["cx"], sensor["cy"])
    init = SE3(torch.from_numpy(stream.rotation[0]), torch.from_numpy(stream.translation[0]))
    pipe = Pipeline(config, cam, sensor["height"], sensor["width"], init_pose=init,
                    mode=conf["mode"], device=card.device, trace=traced)
    loop = Loop(cell, stream, pipe, torch)
    for _ in range(WARM_FRAMES):
        loop.frame()
    c0 = card.counts()

    # --- the measured window ---------------------------------------------
    host_s, lat_s = [], []
    t_win = time.perf_counter()
    while True:
        h, lat = loop.frame()
        host_s.append(h)
        lat_s.append(lat)
        if time.perf_counter() - t_win >= seconds:
            break
    window_s = time.perf_counter() - t_win
    setup_s = t_win - T_START
    c1 = card.counts()
    n_win = len(lat_s)

    span = spans = None
    if traced:
        spans = window_spans(pipe, WARM_FRAMES + n_win)
        profile_span(loop, THROWAWAY_FRAMES, card)
        span = profile_span(loop, PROFILED_FRAMES, card)
        check_trace(span, cell.per_layer, cell.root)
    peak = card.peak_bytes()
    graph_stats = pipe.graph_stats

    # --- frames after the window whose track the reference follows ---------
    program = {}        # what the checks keep of the program
    if not loop.known:
        for _ in range(TRACK_FRAMES):
            check.before_frame(plan, pipe, loop.i, program)
            loop.frame()
    diag = pipe.diagnostics()
    check.read(plan, pipe, program)

    # --- the comparison, once the window has closed and the peak is read --
    del pipe, loop.pipe
    card.free()
    t_check = time.perf_counter()
    inp = check.Inputs(stream, loop.record.arrays(), program, conf, cell.traffic, card.device,
                       seed)
    values, shared = check.numbers(plan, inp)
    correct, checks = check.judge(values, plan.limits)
    control_correct = None
    if control:
        ctrl = check.control_numbers(plan, inp, shared)
        control_correct = check.judge(ctrl, plan.limits)[0]
        for k, v in ctrl.items():
            checks[k]["control"] = v
    print(f"diagnostics {json.dumps(diag)}; frames {loop.i}; comparison "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)

    # --- the result --------------------------------------------------------
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {found}")
    result = {"correct": bool(correct), "attempted": n_win,
              "failed": int(loop.record.failures[WARM_FRAMES + n_win - 1]
                            - loop.record.failures[WARM_FRAMES - 1])}
    dev_info = card.info(peak)
    if traced:
        reading = {"config": conf, "host_s": host_s, "window_s": window_s, "frames": n_win,
                   "counts": (c0, c1), "graph_stats": graph_stats, "span": span,
                   "spans": spans,
                   "track_bound_s": track_bound_s(conf["settings"], conf["mode"],
                                                  sensor["height"], sensor["width"])}
        vals = {}
        for metric in cell.per_layer:
            v = spec.reader(metric["name"], cell.root)(reading)
            if v is not None:
                vals[metric["name"]] = {"value": v, "unit": metric["unit"]}
        result["metrics"] = vals
        dev_info.update(busy_s=trace.busy_s(span["device"]), window_s=span["wall_s"])
        result["breakdown"] = {"device_ops": trace.top_ops(span["device"]),
                               "idle_gaps": trace.idle_gaps(span["device"], span["host"])}
    else:
        result["metrics"] = {
            "frames_per_s": {"value": n_win / window_s, "unit": "frames/s"},
            "frame_ms_p95": {"value": float(np.percentile(np.array(lat_s) * 1e3, 95)),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["metrics"] = {k: v for k, v in result["metrics"].items()
                             if any(e["name"] == k for e in cell.end_to_end)}
    result["device"] = dev_info
    if control:
        result["control_correct"] = bool(control_correct)
    result["checks"] = checks
    for k, v in checks.items():
        extra = f" control {v['control']:.6g}" if "control" in v else ""
        print(f"check {k}: {v['value']:.6g} limit {v['limit']:.6g}{extra}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: {cell.name} needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips != 1:
        raise NotImplementedError("cells on more than one card are not built yet")
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    # The checks' lines close standard error; the result line closes standard output.
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
