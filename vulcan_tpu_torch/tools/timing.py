"""Timing, comparison and argument helpers shared by the probes and
``chip_smoke.py``."""
from __future__ import annotations

import argparse
import statistics
import time

import torch


def device_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
             "versions and reports host times)",
    )
    return parser


def clock_name(device: torch.device) -> str:
    """How ``time_ms`` times work on ``device``, for printed results."""
    return "device time" if device.type == "cuda" else "host clock, CPU"


def device_and_host(fn, reps: int = 50, warm: int = 3) -> tuple[float, float]:
    """Device ms and host us per call of ``fn()``: back-to-back calls
    between two CUDA events, queued behind a spin kernel
    (``torch.cuda._sleep``), so the host's part of every call (checks,
    allocation, launches) is done before the device reaches the first
    event and the window holds only the device's work and the gaps between
    kernels.  The host clock (``time.perf_counter``) around the same loop
    reads the host's part alone, since the device is still spinning.  If
    the spin ended before the host had queued every call, both would mix;
    that happens when the calls take longer to queue than the spin lasts,
    or launch more kernels than the device's queue of pending launches
    holds (the host then blocks until the spin ends).  The window is then
    taken again with half the calls and twice the spin, down to one call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / reps, host_s * 1e6 / reps
        if reps == 1:
            raise RuntimeError("device_and_host: could not queue one call ahead of the device")
        reps = max(1, reps // 2)
        cycles *= 2


def device_ms(fn, reps: int = 50, warm: int = 3) -> float:
    """Device ms per call of the work ``fn()`` queues (``device_and_host``)."""
    return device_and_host(fn, reps, warm)[0]


def time_ms(fn, device: torch.device, reps: int = 10, warm: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back runs: device time on
    the card (``device_ms``), the host clock on the CPU."""
    if device.type == "cuda":
        return device_ms(fn, reps, warm)
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def call_ms(fn, reps: int = 25, warm: int = 5) -> float:
    """Median ms of single calls of ``fn()`` on the card, each between two
    CUDA events: the host's part of the call (checks, allocation, launch)
    is inside the window, unlike ``device_ms``."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference where ``want`` is finite; inf when the shapes,
    dtypes or finite masks differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())

