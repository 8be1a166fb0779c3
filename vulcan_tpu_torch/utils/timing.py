"""Per-stage wall-clock timing.

A context-manager timer around pipeline stages.  PyTorch queues CUDA work
and returns before the device finishes, so on a CUDA device the timer
synchronizes that device as each stage exits: a stage's time is what the
stage took, not how long its dispatch took.  On the CPU (or with no
device) nothing is synchronized.  ``vulcan-tpu-torch run --trace-dir``
adds a ``torch.profiler`` trace for the device-side breakdown.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
