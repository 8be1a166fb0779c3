"""Run the port's CLI with counters around its loop.

    python -m vulcan_tpu_torch.tools.cli_counts run --synthetic 35 ...

runs ``vulcan_tpu_torch.cli.main`` on the arguments, as ``python -m
vulcan_tpu_torch.cli`` does, then prints one more line,
``{"counts": {...}}``:

  * ``frames``, ``step_reads``, ``step_reads_by_frame``, ``step_ms``: the
    frames ``Pipeline.process`` took, the host reads
    (``utils.sync.read_int``) made inside it, in all and frame by frame,
    and each call's host time (not synchronized: with the step's own
    reads, close to the frame's time);
  * ``captured``: whether the pipeline ran its frames as a captured CUDA
    graph (``Pipeline.captured``; its warm-up frames run eagerly);
  * ``mesh_calls``, ``mesh_reads``: the ``ops.mcubes`` extraction, update
    and decode calls and the reads inside them;
  * ``loop_transfers``, ``loop_syncs``, ``loop_windows``: what the CLI's
    own code does between two steps, from the end of the second step on:
    calls that copy a tensor to the host or read it (``Tensor.item``,
    ``tolist``, ``cpu``, ``numpy``, ``__array__``, ``__bool__``,
    ``__int__``, ``__float__``, ``__index__``) and
    ``torch.cuda.synchronize`` calls, over that many windows.  The window
    after the first step (the FPS clock's one sync and the first mesh
    call) and the code after the last step (the final report) are left
    out;
  * ``k1_launches``, ``k2_launches``: the bilateral and fill/smooth
    kernels' launches over the run, counted on the card by the kernels
    themselves (``ops.cuda_kernels.launch_counts``: a captured graph's
    replays too; 0 on the CPU), and ``launches_by_frame``: each counted
    kernel's launches in each ``Pipeline.process`` call (a copy of the
    card's counters queued after each call, read at the end);
  * ``feed_wait_ms``: for a ``--dataset`` run, the host time the loop
    spent waiting for each frame from the TUM reader (the native
    prefetching loader), in frame order.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

_TRANSFERS = ("item", "tolist", "cpu", "numpy", "__array__", "__bool__",
              "__int__", "__float__", "__index__")


@contextlib.contextmanager
def counting():
    """Patch the counters in; yields the counts dict, filled on exit."""
    from ..io import tum
    from ..ops import cuda_kernels, mcubes
    from ..pipeline import api
    from ..utils.sync import read_int

    counts = dict(frames=0, step_reads=0, step_reads_by_frame=[], captured=False,
                  mesh_calls=0, mesh_reads=0, loop_transfers=0, loop_syncs=0,
                  loop_windows=0, feed_wait_ms=[], step_ms=[])
    snapshots = []
    where = {"now": "outside"}
    pending = {"transfers": 0, "syncs": 0}
    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    orig_process = api.Pipeline.process

    def process(self, *a, **k):
        if where["now"] == "between":          # a window closes: it counts
            counts["loop_transfers"] += pending["transfers"]
            counts["loop_syncs"] += pending["syncs"]
            counts["loop_windows"] += 1
        where["now"] = "step"
        r0, t0 = read_int.count, time.perf_counter()
        try:
            return orig_process(self, *a, **k)
        finally:
            counts["step_ms"].append((time.perf_counter() - t0) * 1e3)
            counts["step_reads"] += read_int.count - r0
            counts["step_reads_by_frame"].append(read_int.count - r0)
            counts["captured"] = self.captured
            snapshots.append(cuda_kernels.launch_snapshot(self.device)
                             if self.device.type == "cuda" else None)
            counts["frames"] += 1
            pending["transfers"] = pending["syncs"] = 0
            where["now"] = "between" if counts["frames"] >= 2 else "outside"

    patch(api.Pipeline, "process", process)

    def mesh_call(orig):
        def wrapped(*a, **k):
            prev, where["now"] = where["now"], "mesh"
            r0 = read_int.count
            try:
                return orig(*a, **k)
            finally:
                counts["mesh_reads"] += read_int.count - r0
                counts["mesh_calls"] += 1
                where["now"] = prev
        return wrapped

    for name in ("extract_mesh", "update_mesh_cache", "cache_to_mesh"):
        patch(mcubes, name, mesh_call(getattr(mcubes, name)))

    def counted(orig, key):
        def wrapped(*a, **k):
            if where["now"] == "between":
                pending[key] += 1
            return orig(*a, **k)
        return wrapped

    for name in _TRANSFERS:
        patch(torch.Tensor, name, counted(getattr(torch.Tensor, name), "transfers"))
    patch(torch.cuda, "synchronize", counted(torch.cuda.synchronize, "syncs"))

    orig_iter = tum.TumDataset.__iter__

    def timed_iter(self):
        frames = orig_iter(self)
        while True:
            t0 = time.perf_counter()
            item = next(frames, None)
            if item is None:
                return
            counts["feed_wait_ms"].append((time.perf_counter() - t0) * 1e3)
            yield item

    patch(tum.TumDataset, "__iter__", timed_iter)

    cuda_kernels.reset_launch_counts()
    try:
        yield counts
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)
        total = cuda_kernels.launch_counts()
        counts["k1_launches"] = total["bilateral"]
        counts["k2_launches"] = total["fill_smooth"]
        zero = torch.zeros(len(cuda_kernels.COUNTED), dtype=torch.int64)
        rows = torch.stack([zero, *(zero if s is None else s.cpu().to(torch.int64)
                                    for s in snapshots)])
        counts["launches_by_frame"] = [dict(zip(cuda_kernels.COUNTED, d))
                                       for d in rows.diff(dim=0).tolist()]


def main(argv=None) -> int:
    from .. import cli

    with counting() as counts:
        rc = cli.main(argv)
    print(json.dumps({"counts": counts}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
