"""Host-to-device frame feed.

``prefetch_to_device`` uploads frames i+1..i+lookahead while the device
runs frame i, so the host feed stays off the per-frame critical path.

The reference's ``setup_cache`` (JAX's persistent compilation cache) has
no counterpart: the port's kernels are cached on disk by source hash at
their first build (``ops/cuda_kernels.py``, ``native/__init__.py``), and
eager PyTorch compiles nothing else.
"""
from __future__ import annotations

import collections

import numpy as np
import torch


class _PinnedUploader:
    """Copies host arrays to ``device`` from pinned buffers on a side
    stream.  A buffer is reused only after the copy that last read it has
    completed (its event), and the consumer's stream waits on a frame's
    copy before it uses the frame."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.free = collections.defaultdict(list)   # (shape, dtype) -> [(buf, event)]

    def _buffer(self, src: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event]:
        pool = self.free[(tuple(src.shape), src.dtype)]
        if pool:
            buf, event = pool.pop()
            event.synchronize()
        else:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            event = torch.cuda.Event()
        return buf, event

    def put(self, src: torch.Tensor):
        buf, event = self._buffer(src)
        buf.copy_(src)
        with torch.cuda.stream(self.stream):
            out = buf.to(self.device, non_blocking=True)
            event.record(self.stream)
        return out, (buf, event)

    def hand_over(self, out: torch.Tensor, lease) -> torch.Tensor:
        buf, event = lease
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        # Allocated on the side stream, used on the consumer's: the caching
        # allocator must not recycle it before the consumer is done.
        out.record_stream(consumer)
        self.free[(tuple(buf.shape), buf.dtype)].append((buf, event))
        return out


def _as_host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:       # torch tensors cannot wrap read-only memory
        x = x.copy()
    return torch.from_numpy(x)


def prefetch_to_device(iterator, device, lookahead: int = 2):
    """Yield the tuples of ``iterator`` with their array leaves (numpy
    arrays and tensors) on ``device``.  On a CUDA device frames
    i+1..i+lookahead are copied from pinned host memory on a side stream
    (``non_blocking``) while frame i computes; tensors already on the
    device and non-array leaves pass through untouched."""
    device = torch.device(device)
    uploader = _PinnedUploader(device) if device.type == "cuda" else None

    def on_device(t: torch.Tensor) -> bool:
        return t.device.type == device.type and (
            device.index is None or t.device.index in (None, device.index))

    def put(item):
        out = []
        for x in item:
            if isinstance(x, (np.ndarray, torch.Tensor)):
                t = _as_host_tensor(x)
                if on_device(t):
                    out.append((t, None))
                elif uploader is not None:
                    out.append(uploader.put(t))
                else:
                    out.append((t.to(device), None))
            else:
                out.append((x, None))
        return out

    def hand_over(staged):
        return tuple(
            x if lease is None else uploader.hand_over(x, lease)
            for x, lease in staged
        )

    queue = collections.deque()
    it = iter(iterator)
    for item in it:
        queue.append(put(item))
        if len(queue) >= lookahead:
            break
    while queue:
        out = queue.popleft()
        for item in it:
            queue.append(put(item))
            break
        yield hand_over(out)
