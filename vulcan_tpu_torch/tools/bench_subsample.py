"""Stride-2 subsample probe (T5): the port of ``tools/bench_subsample.py``.

The JAX tool asks which formulation of ``x[::2, ::2]`` is fastest; its
Pallas kernel (``s_pallas``) becomes the hand kernel ``csrc/subsample.cu``
here.  The candidates, all bit-exact (pure selection):

  1. ``x[::2, ::2]``, a strided view;
  2. ``x[::2, ::2].contiguous()``, the plain version: one PyTorch call
     that computes the kernel's function;
  3. the hand kernel (``subsample2``).

Each runs in the JAX tool's chained loop on a (480, 640) int32 image: 16
times ``x = x + tile(s, (2, 2)) + i`` with ``s`` the subsample of ``x``,
so every round depends on the last.  The int32 adds wrap (the inputs reach
2^30); they are torch ops on either device, so only the subsample is the
kernel.  Prints ms per chain and GB/s of subsample output.

    python -m vulcan_tpu_torch.tools.bench_subsample [--device cpu]
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils.device import resolve_device
from .timing import clock_name, device_and_host, device_parser, time_ms

ROUNDS = 16
H, W = 480, 640


def subsample2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``x[::2, ::2]`` as a new tensor."""
    return x[::2, ::2].contiguous()


def subsample2(x: torch.Tensor) -> torch.Tensor:
    """``x[::2, ::2]`` of an (H, W) int32/float32 image.  A CPU tensor takes
    the plain version; a CUDA tensor launches T5 (``csrc/subsample.cu``)
    and counts it in ``subsample2.launches``."""
    if x.is_cpu:
        return subsample2_plain(x)
    out = cuda_kernels.subsample2(x)
    subsample2.launches += 1
    return out


subsample2.launches = 0

CANDIDATES = (
    ("x[::2, ::2] strided view", lambda x: x[::2, ::2]),
    ("x[::2, ::2].contiguous() (plain)", subsample2_plain),
    ("hand kernel csrc/subsample.cu", subsample2),
)


def make_input(device) -> torch.Tensor:
    """The JAX tool's input: ``default_rng(3)`` integers in [0, 2^30)."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 30, (H, W)).astype(np.int32)
    return torch.from_numpy(x).to(device)


def chain(fn, x: torch.Tensor, rounds: int = ROUNDS) -> torch.Tensor:
    """The JAX tool's loop: ``x = x + tile(fn(x), (2, 2)) + i``."""
    for i in range(rounds):
        x = x + fn(x).tile((2, 2)) + i
    return x


def run(device, reps: int = 10) -> list[dict]:
    """Check every candidate against ``x[::2, ::2]`` (one call and the whole
    chain), time each chain and print it; returns one dict per candidate."""
    device = torch.device(device)
    x0 = make_input(device)
    ref = x0[::2, ::2]
    want = chain(subsample2_plain, x0)
    n_bytes = ROUNDS * (H // 2) * (W // 2) * 4
    results = []
    for tag, fn in CANDIDATES:
        if not torch.equal(fn(x0), ref) or not torch.equal(chain(fn, x0), want):
            raise RuntimeError(f"{tag}: differs from x[::2, ::2]")
        ms = time_ms(lambda fn=fn: chain(fn, x0), device, reps=reps)
        gbps = n_bytes / ms * 1e3 / 1e9
        print(f"{tag + f' ({H}x{W} int32)':46s} {ms:9.4f} ms ({clock_name(device)})",
              flush=True)
        print(f"    -> {gbps:.2f} GB/s out", flush=True)
        results.append(dict(tag=tag, ms=ms, gb_per_s=gbps))
    return results


def host_breakdown(x: torch.Tensor, reps: int = 200) -> dict[str, float]:
    """Host us per call of each step of T5's launch path on a CUDA image,
    in its earlier form (a lock in every ``load``, a ``torch.cuda.device``
    guard, a ``Stream`` object for the handle) and in the trimmed one,
    beside ``x[::2, ::2].contiguous()`` and its view.  Each step is timed
    alone, queued behind a spin kernel (``timing.device_and_host``), so the
    host clock reads the host's part only."""
    lib = cuda_kernels.load()
    h, w = x.shape
    shape = ((h + 1) // 2, (w + 1) // 2)
    out = cuda_kernels.subsample2(x)
    xp, op = x.data_ptr(), out.data_ptr()
    raw = torch._C._cuda_getCurrentRawStream(x.get_device())
    lock = threading.Lock()

    def locked_load():
        with lock:
            return cuda_kernels._lib

    def guard():
        with torch.cuda.device(x.device):
            pass

    def stream_object():
        return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)

    def earlier_call():
        cuda_kernels._check(x, "subsample2", (torch.int32, torch.float32))
        lib_ = locked_load()
        o = torch.empty(shape, dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            err = lib_.vulcan_subsample2(x.data_ptr(), o.data_ptr(), h, w, stream_object())
        cuda_kernels._raise_on(err, "subsample2")
        return o

    steps = {
        "check (dtype, rank, layout, device)":
            lambda: cuda_kernels._check(x, "subsample2", (torch.int32, torch.float32)),
        "load, lock every call (earlier)": locked_load,
        "load, no lock once loaded": cuda_kernels.load,
        "allocate, torch.empty (earlier)":
            lambda: torch.empty(shape, dtype=x.dtype, device=x.device),
        "allocate, x.new_empty": lambda: x.new_empty(shape),
        "device guard, torch.cuda.device (earlier)": guard,
        "device check, index compare":
            lambda: x.get_device() == torch._C._cuda_getDevice(),
        "stream, Stream object + c_void_p (earlier)": stream_object,
        "stream, raw handle": lambda: torch._C._cuda_getCurrentRawStream(x.get_device()),
        "data_ptr x2": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call, kernel launch": lambda: lib.vulcan_subsample2(xp, op, h, w, raw),
        "whole call, earlier form": earlier_call,
        "whole call, cuda_kernels.subsample2": lambda: cuda_kernels.subsample2(x),
        "whole call, subsample2 (counted wrapper)": lambda: subsample2(x),
        "library, x[::2, ::2] view": lambda: x[::2, ::2],
        "library, x[::2, ::2].contiguous()": lambda: x[::2, ::2].contiguous(),
    }
    return {k: device_and_host(fn, reps=reps)[1] for k, fn in steps.items()}


def main(argv=None) -> list[dict]:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
