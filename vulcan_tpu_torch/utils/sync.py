"""Device->host reads, and the step's data-dependent control flow.

The reference runs its data-dependent loops (the integrate chunks, the two
splat tiers, the direct and cached z-buffers' chunks, the render cache's
halo chunks) as ``lax.while_loop``s on device counts and its branches (the
auto-photo track and colour render, each march level's compaction) as
``lax.cond``s, all inside one jitted step.  The port runs the same step two ways:

* eager: each trip count or branch is read on the host, which waits for
  the device.  Every such read goes through ``read_int`` / ``read_ints``
  so a run can report how many it made a frame (``read_int.count``);
* captured into a CUDA graph (``pipeline/api.py``): nothing is read.  A
  loop (``chunk_loop``) is one conditional WHILE node that runs its body
  while the chunk's start, a device offset, is below the device count,
  and ``cond`` is one IF/ELSE node (``lax.cond`` on the device); both are
  built in ``csrc/graph.cu``.

``capturing()`` tells the two apart.  The same body serves both forms: it
takes its chunk's start as a 0-d device tensor, so the graph and the eager
step compute the same thing.
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


_body_pool = None       # the node bodies' memory pool of the capture under way
_body_streams: list = []  # the bodies' capture streams, one a nesting depth
_body_depth = 0         # node bodies being captured, nested
# Bodies nest 2 deep on the step (a render's WHILE or the march's
# compaction IF/ELSE inside the colour render's IF/ELSE); chip_smoke's
# phase 2 nests 3.
MAX_DEPTH = 4


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device):
    """``torch.cuda.graph(graph)``, with what ``chunk_loop`` and ``cond``
    need to add conditional nodes to it: the nodes' kernels loaded, a stream
    for each nesting depth of their bodies, and a memory pool for the
    tensors the bodies allocate (yielded: keep it as long as the graph,
    whose replays write into it)."""
    global _body_pool, _body_streams
    from ..ops import cuda_kernels

    cuda_kernels.graph_prepare(device)
    streams = cuda_kernels.graph_streams(device, MAX_DEPTH)
    pool = torch.cuda.MemPool()
    saved = _body_pool, _body_streams
    _body_pool, _body_streams = pool, streams
    try:
        with torch.cuda.graph(graph):
            yield pool
    finally:
        _body_pool, _body_streams = saved


@contextlib.contextmanager
def _body(graph: int, device: torch.device):
    """Capture what the block launches into ``graph``, the body graph of a
    conditional node just added (``csrc/graph.cu``).  The body is captured
    from its nesting depth's stream, made current meanwhile (the hand
    kernels' wrappers launch on the current stream), and what it allocates
    comes from the capture's body pool: PyTorch routes only the capturing
    stream's own allocations to the graph's pool.  The outermost body
    routes every allocation of this thread there; a nested body (a node
    inside a body) falls under its routing."""
    global _body_depth
    from ..ops import cuda_kernels

    if _body_pool is None:
        raise RuntimeError("a conditional node is added only inside sync.capture()")
    if _body_depth >= len(_body_streams):
        raise RuntimeError(f"conditional nodes nest deeper than {len(_body_streams)}")
    body = _body_streams[_body_depth]
    cuda_kernels.graph_body_begin(graph, body)
    _body_depth += 1
    try:
        with torch.cuda.stream(body):
            if _body_depth == 1:
                torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, _body_pool.id)
            try:
                yield
            finally:
                if _body_depth == 1:
                    torch._C._cuda_endAllocateToPool(device.index, _body_pool.id)
                    torch._C._cuda_releasePool(device.index, _body_pool.id)
    finally:
        _body_depth -= 1
        cuda_kernels.graph_body_end(body)


def _while_node(count: torch.Tensor, bound: int, chunk: int, body) -> None:
    """One WHILE node: at a replay ``body(offset)`` runs for offset = 0,
    ``chunk``, ... while offset < min(count, ``bound``) on the device."""
    from ..ops import cuda_kernels

    offset = torch.empty((), dtype=torch.int64, device=count.device)
    handle, graph = cuda_kernels.graph_while(count, bound, offset)
    with _body(graph, count.device):
        body(offset)
        cuda_kernels.graph_while_next(handle, count, bound, chunk, offset)


def _cond_node(pred: torch.Tensor, *branches) -> None:
    """One IF/ELSE node on the 0-d bool ``pred``: at a replay the first of
    the two ``branches`` runs where it is true, the second where it is
    false (one branch: an IF node, which runs it or nothing)."""
    from ..ops import cuda_kernels

    for graph, fn in zip(cuda_kernels.graph_cond(pred, len(branches)), branches):
        with _body(graph, pred.device):
            fn()


def chunk_loop(count: torch.Tensor, bound: int, chunk: int, body,
               host_count: int | None = None) -> None:
    """The reference's ``lax.while_loop`` over the chunks of a list of
    capacity ``bound``: ``body(offset)`` for offset = 0, ``chunk``, ...
    below min(``count``, ``bound``), where ``offset`` is the chunk's start
    as a 0-d int64 device tensor and ``count`` the list's 0-d int32 length
    on the device.  The body updates tensors in place, returns nothing,
    finds its rows at ``offset + arange(chunk)`` and masks those at or past
    ``count``.  ``chunk`` must divide ``bound``, so that no chunk reaches
    past the list.

    Eager, the count is read on the host (``read_int``, counted) unless the
    caller has read it already (``host_count``), and the offsets are views
    into one ``arange`` (no host-to-device copy a chunk); the bodies run
    are counted in ``chunk_loop.count``.  While capturing, the loop is one
    WHILE node."""
    if bound % chunk:
        raise ValueError(f"a chunk of {chunk} does not divide the loop's bound {bound}")
    if capturing():
        _while_node(count, bound, chunk, body)
        return
    n = read_int(count) if host_count is None else host_count
    trips = -(-min(n, bound) // chunk)
    if trips:
        offsets = torch.arange(0, bound, chunk, device=count.device)
        for i in range(trips):
            body(offsets[i])
    chunk_loop.count += trips


chunk_loop.count = 0


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

    While capturing, the two branches are the two bodies of one IF/ELSE
    node on ``pred != 0``, and the second branch's outputs are copied into
    the first's, so the rest of the graph reads one set of buffers.
    Eager, a tensor ``pred`` is read (``read_int``, counted) and one branch
    runs; inside ``warm_both`` both run and the chosen one's result is
    returned.  The eager ``cond``s are counted in ``cond.count``."""
    if not capturing():
        def take() -> bool:
            return bool(read_int(pred) if isinstance(pred, torch.Tensor) else pred)

        cond.count += 1
        if _warm_both:
            a, b = true_fn(), false_fn()
            return a if take() else b
        return true_fn() if take() else false_fn()
    out = []

    def other():
        for dst, src in zip(tensor_leaves(out[0]), tensor_leaves(false_fn())):
            if not same_memory(dst, src):
                dst.copy_(src)

    _cond_node(pred != 0, lambda: out.append(true_fn()), other)
    return out[0]


cond.count = 0
