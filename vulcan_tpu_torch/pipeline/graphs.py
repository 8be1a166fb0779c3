"""The online step as captured CUDA graphs: the port's counterpart of the
reference's ``jax.jit(step, donate_argnums=...)``.

``Pipeline`` on the card, at every configuration
``fusion.check_supported`` accepts, hands each frame to
``StepGraphs.run``.  The first ``WARMUP_FRAMES`` frames of a kind (a
tracked step, a known-pose step; per input dtype) run eagerly, with both
sides of every ``utils.sync.cond`` (``sync.warm_both``), so that every
kernel and every one-time set-up has run once.  The next frame captures
the step into a ``torch.cuda.CUDAGraph`` (a capture executes nothing) and
replays it; every later frame copies its inputs into the graph's input
buffers and replays.

Donation: the step reads the state from one set of buffers and its graph
writes the new state back into the same buffers at its end.  The voxel
arrays are updated in place by the step itself (``ops/sparse.py``), so
they are never copied; the rest of the state (hash table, visible list,
model maps, pose, counters: a few MB) is.  Whatever a caller puts into
``Pipeline.state`` between frames (a snapshot's volume, a re-meshed
volume's flags) is copied into the buffers before the next replay.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..utils import sync

WARMUP_FRAMES = 2   # eager frames of a kind before its capture


def rebuild(template, leaves):
    """``template``'s tree with its tensors replaced, in order, by the
    tensors of the iterator ``leaves`` (``sync.tensor_leaves``' order)."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, (tuple, list)):
        return type(template)(rebuild(x, leaves) for x in template)
    return template


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def distinct(leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """``leaves`` with every tensor whose memory an earlier one shares
    cloned (a fresh state passes one pose as both ``prev_pose`` and
    ``model.pose``), so that each buffer can be written alone."""
    seen, out = set(), []
    for t in leaves:
        out.append(t.clone() if _storage(t) in seen else t)
        seen.add(_storage(out[-1]))
    return out


def copy_leaves(dst: list[torch.Tensor], src: list[torch.Tensor]) -> bool:
    """Copy ``src[i]`` into ``dst[i]`` wherever the two are not the same
    memory; returns whether anything was copied.  A source that lives in
    one of the buffers (the step passes the old pose on as ``prev_pose``)
    is snapshotted first, so the copies cannot overwrite one another's
    sources."""
    pairs = [(d, s) for d, s in zip(dst, src)
             if d is not s and not sync.same_memory(d, s)]
    if not pairs:
        return False
    targets = {_storage(d) for d in dst}
    pairs = [(d, s.clone() if _storage(s) in targets else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)
    return True


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]      # the frame's buffers, in input order
    body_pool: object               # what the conditional nodes' bodies allocate


class StepGraphs:
    """The graphs of one ``Pipeline``: one per kind of frame, all reading
    and writing one set of state buffers.  ``stats[key]`` holds a graph's
    capture ms (host clock), its memory pool MiB (device memory reserved
    by the capture) and its replays."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buffers: list[torch.Tensor] | None = None
        self.view = None                # the state over the buffers
        self.graphs: dict = {}
        self.eager_frames: dict = {}
        self.stats: dict = {}

    def run(self, key, fn, state, *inputs):
        """The state after one frame: ``fn(state, *inputs)``, eagerly for
        the first ``WARMUP_FRAMES`` frames of ``key``, then as its graph."""
        g = self.graphs.get(key)
        if g is None:
            n = self.eager_frames.get(key, 0)
            if n < WARMUP_FRAMES:
                self.eager_frames[key] = n + 1
                with sync.warm_both():
                    return fn(state, *inputs)
            g = self.graphs[key] = self._capture(key, fn, state, inputs)
        elif copy_leaves(self.buffers, sync.tensor_leaves(state)) or state is not self.view:
            self.view = rebuild(self.view, iter(self.buffers))
        for dst, src in zip(g.inputs, sync.tensor_leaves(inputs)):
            dst.copy_(src)
        g.graph.replay()
        self.stats[key]["replays"] += 1
        return self.view

    def _capture(self, key, fn, state, inputs) -> _Graph:
        if self.buffers is None:
            self.buffers = distinct(sync.tensor_leaves(state))
        else:
            copy_leaves(self.buffers, sync.tensor_leaves(state))
        self.view = rebuild(state, iter(self.buffers))
        static = [x.clone() for x in sync.tensor_leaves(inputs)]
        frame = rebuild(inputs, iter(static))
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with sync.capture(graph, self.device) as body_pool:
            out = fn(self.view, *frame)
            copy_leaves(self.buffers, sync.tensor_leaves(out))
        del out
        self.stats[key] = {
            "capture_ms": (time.perf_counter() - t0) * 1e3,
            "pool_mib": (torch.cuda.memory_reserved(self.device) - reserved) / 2**20,
            "replays": 0,
        }
        return _Graph(graph, static, body_pool)
