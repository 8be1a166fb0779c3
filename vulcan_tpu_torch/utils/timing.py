"""Per-stage timing: the CLI's wall-clock ``StageTimer``, and the step's
spans (``stage``, ``SpanTracer``).

``StageTimer`` is a context-manager timer around pipeline stages.  PyTorch
queues CUDA work and returns before the device finishes, so on a CUDA
device the timer synchronizes that device as each stage exits: a stage's
time is what the stage took, not how long its dispatch took.  On the CPU
(or with no device) nothing is synchronized.  ``vulcan-tpu-torch run
--trace-dir`` adds a ``torch.profiler`` trace for the device-side
breakdown.

``stage(name)`` wraps each stage of ``pipeline/fusion.py``'s step.  It
always opens the profiler range ``vulcan.<name>`` (what a profiler trace of
the eager step shows).  While a traced ``Pipeline`` runs its step
(``tracing``), it also places a mark at the stage's entry and exit: a
one-thread kernel that writes the card's ``%globaltimer`` into the
tracer's ring on the device (``csrc/trace.cu``), eagerly or as a kernel
node of the captured graph, so that the spans time the step users run.  On
the CPU a mark writes the host clock instead.  ``SpanTracer`` owns the
ring, the host's spans of ``Pipeline.process`` and the calibration that
puts the card's clock on the host's.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import cuda_kernels


class StageTimer:
    def __init__(self, device=None):
        device = torch.device(device) if device is not None else None
        self._sync = device is not None and device.type == "cuda"
        self.device = device
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last_ms = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - t0) * 1e3
            self.totals[name] += ms
            self.counts[name] += 1
            self.last_ms[name] = round(ms, 2)

    def summary(self) -> dict:
        return {
            k: round(self.totals[k] / max(self.counts[k], 1), 2)
            for k in self.totals
        }


# The step's spans on the device, in slot order: span i's entry mark is slot
# 2 i and its exit 2 i + 1.  ``step`` is every other span's parent.
SPANS = ("step", "preprocess", "track", "allocate", "integrate", "render")
# The host's spans of ``Pipeline.process``; ``process`` is the others' parent.
HOST_SPANS = ("process", "upload", "launch")
RING_FRAMES = 8192          # frames the ring holds: 20 s at up to 400 frames/s
CALIBRATION_MARKS = 20


def host_ns() -> int:
    """The host clock of every span, in ns: ``CLOCK_REALTIME``, the clock
    that ``torch.profiler`` stamps its events with (``c10::getTime`` in
    ``c10/util/ApproximateClock.h``, which its converter maps the
    profiler's cycle counts to), so that a span, a mark and a profiler event
    land on one timeline."""
    return time.time_ns()


class Clock(NamedTuple):
    """One calibration of the card's clock against the host's: a device
    time, the host time minus the device time there, and the half-width of
    the host window it was taken in (the error of the offset)."""

    device_ns: int
    offset_ns: int
    error_ns: int


def fit_clock(triples) -> Clock:
    """The calibration from (host before, device, host after) triples, each
    a mark between two host reads: the narrowest window's midpoint."""
    h0, d, h1 = min(triples, key=lambda t: t[2] - t[0])
    return Clock(d, (h0 + h1) // 2 - d, (h1 - h0) // 2)


def to_host(device_ns, start: Clock, end: Clock):
    """Device times (an int or an int64 array) on the host clock: the offset
    moves linearly from ``start``'s to ``end``'s (the drift between two
    calibrations)."""
    if end.device_ns == start.device_ns:
        return device_ns + start.offset_ns
    slope = (end.offset_ns - start.offset_ns) / (end.device_ns - start.device_ns)
    shift = np.rint(slope * (np.asarray(device_ns) - start.device_ns)).astype(np.int64)
    return device_ns + start.offset_ns + shift


def mark_plain(ring: torch.Tensor, frame: torch.Tensor, slot: int, flags: int, t: int) -> None:
    """``csrc/trace.cu``'s ``mark_kernel`` on the host: time ``t`` into slot
    ``slot`` of frame ``frame``'s row of ``ring``."""
    f = int(frame)
    row = ring[f % ring.shape[0]]
    if flags & cuda_kernels.TRACE_FIRST:
        row.zero_()
        row[0] = f
    row[1 + slot] = t
    if flags & cuda_kernels.TRACE_LAST:
        frame.add_(1)


class SpanTracer:
    """The spans of one ``Pipeline``'s frames, kept in memory until read.

    On the device, a ring of ``frames`` rows of int64: a row a frame, its
    number, then the times of the step's marks (``SPANS``), two a span.  The
    frame's number is a device counter that the step's exit mark advances,
    so a replayed graph needs no host value.  On the host, the same frame's
    ``HOST_SPANS`` in a numpy ring of the same length, keyed by the frames
    the host has begun (``begun``), which the counter follows one to one.
    The card's clock is calibrated against ``host_ns`` when the tracer is
    made (``start``) and again at each read-out, which also gives its drift.
    The ring and the mark's kernel exist before any capture."""

    def __init__(self, device: torch.device, frames: int = RING_FRAMES):
        self.frames = frames
        self.ring = torch.zeros((frames, 1 + 2 * len(SPANS)), dtype=torch.int64, device=device)
        self.frame = torch.zeros((), dtype=torch.int64, device=device)
        self.host = np.zeros((frames, 2 * len(HOST_SPANS)), np.int64)
        self.begun = 0
        self._clock_ring = torch.zeros((CALIBRATION_MARKS, 2), dtype=torch.int64, device=device)
        self._clock_frame = torch.zeros((), dtype=torch.int64, device=device)
        if self.ring.is_cuda:
            cuda_kernels.trace_prepare(self.ring.device)
        self.start = self.calibrate()

    def _mark(self, ring, frame, slot: int, flags: int, counted: bool = True) -> None:
        if ring.is_cuda:
            cuda_kernels.trace_mark(ring, frame, slot, flags, counted)
        else:
            mark_plain(ring, frame, slot, flags, host_ns())

    def mark(self, name: str, end: bool) -> None:
        """Span ``name``'s entry (``end`` False) or exit mark of the frame
        under way; ``step``'s entry begins the frame, its exit ends it."""
        flags = 0
        if name == "step":
            flags = cuda_kernels.TRACE_LAST if end else cuda_kernels.TRACE_FIRST
        self._mark(self.ring, self.frame, 2 * SPANS.index(name) + end, flags)

    def _sync(self) -> None:
        if self.ring.is_cuda:
            torch.cuda.synchronize(self.ring.device)

    def calibrate(self) -> Clock:
        """``CALIBRATION_MARKS`` marks, each launched between two host reads
        on an idle device and waited for: the narrowest window
        (``fit_clock``).  The marks are not counted as ``trace_mark``."""
        windows = []
        self._clock_frame.zero_()
        for _ in range(CALIBRATION_MARKS):
            self._sync()
            h0 = host_ns()
            self._mark(self._clock_ring, self._clock_frame, 0,
                       cuda_kernels.TRACE_FIRST | cuda_kernels.TRACE_LAST, counted=False)
            self._sync()
            windows.append((h0, host_ns()))
        device = self._clock_ring[:, 1].tolist()
        return fit_clock([(h0, d, h1) for (h0, h1), d in zip(windows, device)])

    def record_host(self, process: tuple, upload: tuple, launch: tuple) -> None:
        """The host's (start, end) ns of the frame under way's ``HOST_SPANS``;
        ends the frame on the host."""
        self.host[self.begun % self.frames] = (*process, *upload, *launch)
        self.begun += 1

    def spans(self, first: int, stop: int) -> dict | None:
        """Frames ``first`` to ``stop`` - 1 (numbered from the pipeline's
        first, 0): ``{"spans": [(frame, name, parent, start ns, end ns),
        ...], "error_ns", "drift_ns", "interval_s"}``, every time on the host
        clock (``host_ns``): the device's spans mapped through a calibration
        at the tracer's start and one made now, whose larger half-width is
        the error and whose difference is the drift over the interval
        between them.  One copy of the ring to the host.  None where the
        window reaches frames not yet run or already overwritten."""
        if not max(0, self.begun - self.frames) <= first <= stop <= self.begun:
            return None
        frames = np.arange(first, stop)
        rows = self.ring.cpu().numpy()[frames % self.frames]
        if (rows[:, 0] != frames).any():
            return None
        end = self.calibrate()
        marks = rows[:, 1:]
        mapped = np.where(marks > 0, to_host(marks, self.start, end), 0).tolist()
        host = self.host[frames % self.frames].tolist()
        out = []
        for f, m, h in zip(frames.tolist(), mapped, host):
            for i, name in enumerate(SPANS):
                if m[2 * i] and m[2 * i + 1]:
                    out.append((f, name, None if i == 0 else "step", m[2 * i], m[2 * i + 1]))
            for i, name in enumerate(HOST_SPANS):
                out.append((f, name, None if i == 0 else "process", h[2 * i], h[2 * i + 1]))
        return {"spans": out, "error_ns": max(self.start.error_ns, end.error_ns),
                "drift_ns": end.offset_ns - self.start.offset_ns,
                "interval_s": (end.device_ns - self.start.device_ns) / 1e9}


_tracer: SpanTracer | None = None     # the tracer of the step under way, if any


@contextlib.contextmanager
def tracing(tracer: SpanTracer):
    """``stage`` marks into ``tracer`` inside the block (``Pipeline``
    around its step)."""
    global _tracer
    saved, _tracer = _tracer, tracer
    try:
        yield
    finally:
        _tracer = saved


@contextlib.contextmanager
def stage(name: str):
    """One stage of the step (``SPANS``): the profiler range
    ``vulcan.<name>``, and, under ``tracing``, a mark at entry and exit."""
    tracer = _tracer
    with record_function("vulcan." + name):
        if tracer is None:
            yield
        else:
            tracer.mark(name, False)
            yield
            tracer.mark(name, True)
