"""The CPU stand-in for the card that the tests drive a whole run with, at
a small size: the harness's own timed path, with no launch counters, a
CPU-only trace and no memory peak."""
from __future__ import annotations

import dataclasses

from benchmark import run, spec

SMALL = {"sensor": {"width": 160, "height": 120, "fx": 517.3 / 4, "fy": 516.5 / 4,
                    "cx": 319.1 / 4 - 0.5, "cy": 255.8 / 4 - 0.5},
         "settings": {"num_blocks": 32768, "hash_size": 131072, "max_visible": 8192}}


class HostCard(run.Card):
    device = "cpu"

    def __init__(self):
        from vulcan_tpu_torch.ops import cuda_kernels

        self.counts = lambda: dict.fromkeys(cuda_kernels.COUNTED, 0)

    def activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU]

    def sync(self) -> None:
        pass

    def peak_bytes(self) -> int:
        return 0

    def free(self) -> None:
        pass

    def info(self, peak: int) -> dict:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def small_cell(workload: str, root=spec.ROOT) -> spec.Cell:
    """``workload`` of ``root`` with its sensor cut to 160x120 and its
    volume halved."""
    cell = spec.cell(workload, root)
    conf = cell.config
    conf = dict(conf, sensor=dict(conf["sensor"], **SMALL["sensor"]),
                settings=dict(conf["settings"], **SMALL["settings"]))
    return dataclasses.replace(cell, config=conf)


def small_run(workload, traced=False, control=False, seconds=0.5, seed=2**31 + 7) -> dict:
    return run.execute(small_cell(workload), seed, seconds, traced, control=control,
                       card=HostCard())
