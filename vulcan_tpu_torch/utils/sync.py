"""Device->host reads, and the step's data-dependent control flow.

The reference runs its data-dependent loops (the integrate chunks, the two
splat tiers) as ``lax.while_loop``s on device counts and its two mode
switches (the auto-photo track, the colour render) as ``lax.cond``s, all
inside one jitted step.  The port runs the same step two ways:

* eager: each trip count or branch is read on the host, which waits for
  the device.  Every such read goes through ``read_int`` / ``read_ints``
  so a run can report how many it made a frame (``read_int.count``);
* captured into a CUDA graph (``pipeline/api.py``): nothing is read.  A
  loop runs to its static upper bound with every chunk under ``run_if``,
  a conditional IF node on the device count, and ``cond`` captures both
  branches, each under an IF node (``lax.cond`` on the device).

``capturing()`` tells the two apart.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


def read_int(t: torch.Tensor) -> int:
    """Read a 0-d integer (or bool) tensor on the host (a device sync on
    CUDA)."""
    read_int.count += 1
    return int(t.item())


read_int.count = 0


def read_ints(*ts: torch.Tensor) -> list[int]:
    """Read several 0-d integer tensors in ONE transfer (counted once)."""
    read_int.count += 1
    return [int(v) for v in torch.stack(list(ts)).tolist()]


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


_body_pool = None       # the IF bodies' memory pool of the capture under way
_body_streams: list = []  # the bodies' capture streams, one a nesting depth
_body_depth = 0         # IF bodies being captured, nested
MAX_IF_DEPTH = 4


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device):
    """``torch.cuda.graph(graph)``, with what ``run_if`` and ``cond`` need
    to add IF nodes to it: the nodes' kernel loaded, a stream for each
    nesting depth of their bodies, and a memory pool for the tensors the
    bodies allocate (yielded: keep it as long as the graph, whose replays
    write into it)."""
    global _body_pool, _body_streams
    from ..ops import cuda_kernels

    cuda_kernels.graph_prepare(device)
    streams = cuda_kernels.graph_streams(device, MAX_IF_DEPTH)
    pool = torch.cuda.MemPool()
    saved = _body_pool, _body_streams
    _body_pool, _body_streams = pool, streams
    try:
        with torch.cuda.graph(graph):
            yield pool
    finally:
        _body_pool, _body_streams = saved


def _if_node(pred: torch.Tensor, fn) -> None:
    """Capture ``fn()`` into the body of a conditional IF node of the graph
    being captured (``csrc/graph.cu``): at a replay the body runs only
    where the 0-d bool ``pred`` is true on the device.  The body is
    captured from its nesting depth's stream, made current meanwhile (the
    hand kernels' wrappers launch on the current stream), and what it
    allocates comes from the capture's body pool: PyTorch routes only the
    capturing stream's own allocations to the graph's pool.  The outermost
    body routes every allocation of this thread there; a nested body (an
    IF inside a body) falls under its routing."""
    global _body_depth
    from ..ops import cuda_kernels

    if _body_pool is None:
        raise RuntimeError("an IF node is added only inside sync.capture()")
    if _body_depth >= len(_body_streams):
        raise RuntimeError(f"IF nodes nest deeper than {len(_body_streams)}")
    device = pred.device.index
    body = _body_streams[_body_depth]
    cuda_kernels.graph_if_begin(pred, body)
    _body_depth += 1
    try:
        with torch.cuda.stream(body):
            if _body_depth == 1:
                torch._C._cuda_beginAllocateCurrentThreadToPool(device, _body_pool.id)
            try:
                fn()
            finally:
                if _body_depth == 1:
                    torch._C._cuda_endAllocateToPool(device, _body_pool.id)
                    torch._C._cuda_releasePool(device, _body_pool.id)
    finally:
        _body_depth -= 1
        cuda_kernels.graph_if_end(body)


def run_if(pred: torch.Tensor, fn) -> None:
    """One guarded chunk of a loop that runs to a static bound: ``fn()``
    (which updates tensors in place and returns nothing) runs where the 0-d
    bool ``pred`` is true.  Eager, the caller's loop already stops at the
    read count, so ``fn`` simply runs."""
    if capturing():
        _if_node(pred, fn)
    else:
        fn()


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dataclasses, tuples and lists, in field
    order (other leaves, such as a camera's floats, are skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in tensor_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


_warm_both = False


@contextlib.contextmanager
def warm_both():
    """Eager ``cond``s inside the block run both branches (the one not
    taken is thrown away), so that everything either branch launches has
    run once before a capture: a capture executes nothing, and a branch
    first reached in a replay would meet its one-time set-up there."""
    global _warm_both
    saved, _warm_both = _warm_both, True
    try:
        yield
    finally:
        _warm_both = saved


def cond(pred: torch.Tensor, true_fn, false_fn):
    """``lax.cond``: ``true_fn()`` where the 0-d ``pred`` is nonzero, else
    ``false_fn()``.  Eager, ``pred`` may also be its value already read on
    the host (an int).  Both must return trees of the same structure, shapes
    and dtypes (fresh tensors, or the same input tensor at the same place).

    While capturing, each branch is captured under an IF node, on ``pred``
    and on its negation, and the second branch's outputs are copied into
    the first's, so the rest of the graph reads one set of buffers.
    Eager, a tensor ``pred`` is read (``read_int``, counted) and one branch
    runs; inside ``warm_both`` both run and the chosen one's result is
    returned."""
    if not capturing():
        def take() -> bool:
            return bool(read_int(pred) if isinstance(pred, torch.Tensor) else pred)

        if _warm_both:
            a, b = true_fn(), false_fn()
            return a if take() else b
        return true_fn() if take() else false_fn()
    on = pred != 0
    out = []
    _if_node(on, lambda: out.append(true_fn()))

    def other():
        for dst, src in zip(tensor_leaves(out[0]), tensor_leaves(false_fn())):
            if not same_memory(dst, src):
                dst.copy_(src)

    _if_node(~on, other)
    return out[0]
