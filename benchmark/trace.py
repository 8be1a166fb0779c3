"""Reading a ``torch.profiler`` trace of the card, kept in memory, and the
program's own spans (``span_ms``).

On the card the trace of a captured step holds only the first iteration
of each WHILE node's body (CUPTI; the counter of ``while_next_kernel``
shows it), so what it sums of the step's device time is short by the
later iterations, and their time reads as idle gaps while the host waits
for the pose.  A per-layer metric reads from the trace only kernels whose
launches it can count against the card's counters (``TRACED`` in its
reader).
"""
from __future__ import annotations

import collections

import torch

# The host's labelled ranges of a profiled frame.
HOST_PROCESS = "bench.process"      # the call into Pipeline.process
HOST_POSE = "bench.pose"            # the pose read, which waits for the step

# What occupies the card in a trace, by kineto's activity names: kernels,
# copies and fills (not the device-side copies of host ranges).
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")

# The program's counted hand kernels (``cuda_kernels.COUNTED``) by the name
# of their kernel in a trace.
KERNEL_NAMES = {"bilateral": "bilateral_kernel", "fill_smooth": "fill_smooth_kernel",
                "icp_associate": "associate_kernel", "icp_rows": "rows_kernel",
                "icp_solve": "solve_kernel", "icp_rows_solve": "gn_step_kernel",
                "graph_while": "while_begin_kernel",
                "graph_while_next": "while_next_kernel",
                "graph_ifelse": "set_cond_kernel"}


def _device_work(e) -> bool:
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_WORK
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return False
    return not e.name().startswith("vulcan.")


def device_spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every kernel, copy and fill of a finished
    ``torch.profiler.profile``, a CUDA graph's replayed kernels included."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and _device_work(e)]


def host_ranges(prof) -> list[tuple[str, int, int]]:
    """(label, start ns, end ns) of the host's labelled ranges, in order."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cpu and e.name() in (HOST_PROCESS, HOST_POSE)),
                  key=lambda r: r[1])


def _union(spans) -> list[tuple[int, int]]:
    """The union of the spans' intervals, in order."""
    out = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(spans) -> float:
    """The seconds in which at least one of ``spans`` ran: the length of
    their union, so that work overlapping on two streams counts once."""
    return sum(e - s for s, e in _union(spans)) / 1e9


def idle_gaps(spans, host, n: int = 10) -> list[list]:
    """The ``n`` longest gaps between the device's busy intervals, each
    named by what the host was doing when it began: [name, seconds]."""
    busy = _union(spans)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])), reverse=True)[:n]
    names = {HOST_PROCESS: "host in Pipeline.process (upload, launch)",
             HOST_POSE: "host waiting for the pose (or WHILE iterations the trace drops)"}
    out = []
    for ns, at in gaps:
        label = next((names[h] for h, s, e in host if s <= at < e),
                     "host between frames (loop, next hand-over)")
        out.append([label, ns / 1e9])
    return out


def kernel_counts(spans) -> dict[str, int]:
    """Launches of each counted hand kernel in the trace."""
    return {k: sum(pat in s[0] for s in spans) for k, pat in KERNEL_NAMES.items()}


def top_ops(spans, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time: [name, seconds]."""
    tot = collections.Counter()
    for name, s, e in spans:
        tot[name[:120]] += (e - s) / 1e9
    return [[k, v] for k, v in tot.most_common(n)]


def span_ms(spans: dict | None, name: str) -> float | None:
    """The mean ms a frame of the program's span ``name`` in ``spans``
    (``Pipeline.trace_spans``): its time summed over the frames read, over
    their number, so that a span that runs on some frames only counts as
    its share of each; None where no span was read or none is ``name``."""
    if not spans:
        return None
    ns = [e - s for _, n, _, s, e in spans["spans"] if n == name]
    if not ns:
        return None
    return sum(ns) / 1e6 / len({f for f, *_ in spans["spans"]})
