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

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils.device import resolve_device
from .timing import clock_name, device_parser, time_ms

ROUNDS = 16
H, W = 480, 640


def subsample2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``x[::2, ::2]`` as a new tensor."""
    return x[::2, ::2].contiguous()


def subsample2(x: torch.Tensor) -> torch.Tensor:
    """``x[::2, ::2]`` of an (H, W) int32/float32 image.  A CPU tensor takes
    the plain version; a CUDA tensor launches T5 (``csrc/subsample.cu``)
    and counts it in ``subsample2.launches``."""
    if x.device.type == "cpu":
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


def main(argv=None) -> list[dict]:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
