"""Fused fill+smooth stencil probe (T1): the port of
``tools/bench_pallas_stencil.py``.

The splat renderer's post-pass (2 gated hole-fill rounds, then an
edge-aware 3x3 smoothing pass) runs on the main path as kernel K2
(``csrc/fill_smooth.cu``): one launch with a rounds + 1 halo, a tile in
shared memory, each thread sliding a 3-row window down a column strip, a
block barrier between the passes.  T1 (``csrc/fill_smooth_fused.cu``) is the
JAX tool's one-launch kernel with no shared memory and no barrier: a warp
owns a strip of the image (``cuda_kernels.fused_strips``), its rows stream
through the lanes' registers and the neighbours come by warp shuffle.  This
probe checks both against the plain version (finite masks equal, max abs
error <= 1e-6 m) and times the three with the output fed back in, 30
times, so no call can be skipped.  ``launch_costs`` times one launch of K2
or of T1 for every round count (the slope is one fill round);
``strip_times`` times T1 by strip height and warps a block.

    python -m vulcan_tpu_torch.tools.bench_stencil [HxW] [--device cpu]

Input: ``default_rng(0)`` depths uniform in [0.5, 3) m with 30% +inf holes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..ops import cuda_kernels, splat
from ..utils.device import resolve_device
from .timing import clock_name, device_ms, device_parser, max_abs_err, time_ms

FILL_ROUNDS = 2
TOL = 1e-6  # m: fill is min/max (exact); smoothing sums in the same order


def probe_config(mu: float, rounds: int = FILL_ROUNDS) -> Config:
    """The default ``Config`` with the probe's truncation band and rounds."""
    return dataclasses.replace(Config(), trunc_dist=mu, splat_fill_rounds=rounds)


# The plain version is the port's own K2 math, and K2 is the main path's
# wrapper (one launch on the card at up to 4 rounds); both read mu and the
# round count from ``config.trunc_dist`` and ``config.splat_fill_rounds``.
fill_smooth_plain = splat._fill_smooth_math
fill_smooth_k2 = splat._fill_and_smooth


def fill_smooth_fused(d: torch.Tensor, config: Config) -> torch.Tensor:
    """K2's function in one launch.  A CPU tensor takes the plain version;
    a CUDA tensor launches T1 (``csrc/fill_smooth_fused.cu``) and counts it
    in ``fill_smooth_fused.launches``."""
    if d.is_cpu:
        return fill_smooth_plain(d, config)
    mu = config.trunc_dist
    out = cuda_kernels.fill_smooth_fused(d, config.splat_fill_rounds, 2.0 * mu, 0.5 * mu)
    fill_smooth_fused.launches += 1
    return out


fill_smooth_fused.launches = 0


def make_input(h: int, w: int, device) -> torch.Tensor:
    """The JAX tool's input: uniform(0.5, 3.0) m, 30% +inf splat holes."""
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.3] = np.inf
    return torch.from_numpy(d).to(device)


def launch_costs(d: torch.Tensor, mu: float, fused: bool = False) -> dict[str, float]:
    """Device ms of one K2 launch on the CUDA image ``d`` for every round
    count the kernel compiles, with the smoothing pass, and for its
    fill-only launch: neighbouring counts differ by one fill round, and 0
    rounds is the staging, the smoothing and the store alone.  ``fused``:
    the same of T1 (which has no fill-only form)."""
    if fused:
        return {
            f"{r} rounds + smooth": device_ms(
                lambda r=r: cuda_kernels.fill_smooth_fused(d, r, 2.0 * mu, 0.5 * mu))
            for r in range(cuda_kernels.FUSED_MAX_ROUNDS + 1)
        }
    top = cuda_kernels.FILL_SMOOTH_MAX_ROUNDS
    steps = [(r, True) for r in range(top + 1)] + [(top, False)]
    return {
        f"{r} rounds{' + smooth' if smooth else ', fill only'}": device_ms(
            lambda r=r, smooth=smooth: cuda_kernels.fill_smooth(
                d, ((r, smooth),), 2.0 * mu, 0.5 * mu))
        for r, smooth in steps
    }


# (rows a strip, warps a block) T1 is timed at, the wrapper's own choice among them
STRIPS = ((8, 2), (12, 1), (12, 2), (12, 4), (16, 2), (32, 2))


def strip_times(d: torch.Tensor, mu: float, rounds: int = FILL_ROUNDS) -> dict:
    """Device ms of one T1 launch on the CUDA image ``d`` for each strip
    height and block size of ``STRIPS``."""
    return {
        (rows, warps): device_ms(lambda rows=rows, warps=warps: cuda_kernels.fill_smooth_fused(
            d, rounds, 2.0 * mu, 0.5 * mu, rows, warps))
        for rows, warps in STRIPS
    }


def chain_ms(fn, x: torch.Tensor, device, n: int = 30) -> float:
    """Mean ms of ``out = fn(out)``, ``n`` times from ``fn(x)``."""
    state = [fn(x)]

    def step():
        state[0] = fn(state[0])

    return time_ms(step, device, reps=n, warm=0)


def run(device, h: int = 480, w: int = 640) -> dict:
    """Check the fused kernel and K2 against the plain version, time the
    three chained, print the times and speedups."""
    device = torch.device(device)
    cfg = probe_config(Config().trunc_dist)
    d = make_input(h, w, device)
    want = fill_smooth_plain(d, cfg)
    errs = {}
    for tag, fn in (("fused", fill_smooth_fused), ("k2", fill_smooth_k2)):
        errs[tag] = max_abs_err(fn(d, cfg), want)
        if not errs[tag] <= TOL:
            raise RuntimeError(f"{tag}: max abs error {errs[tag]} above {TOL} m")
    print(f"correctness: PASS (max abs err fused {errs['fused']:.3e}, "
          f"K2 {errs['k2']:.3e}, tol {TOL:g} m)", flush=True)
    ms = {
        tag: chain_ms(lambda x, fn=fn: fn(x, cfg), d, device)
        for tag, fn in (("plain", fill_smooth_plain), ("k2", fill_smooth_k2),
                        ("fused", fill_smooth_fused))
    }
    clock = clock_name(device)
    print(f"plain PyTorch   fill+smooth {h}x{w}: {ms['plain']:8.4f} ms ({clock})")
    print(f"K2, 1 launch    fill+smooth {h}x{w}: {ms['k2']:8.4f} ms")
    print(f"T1, warp strips fill+smooth {h}x{w}: {ms['fused']:8.4f} ms")
    print(f"speedup K2 over T1: {ms['fused'] / ms['k2']:.2f}x; "
          f"K2 over plain: {ms['plain'] / ms['k2']:.2f}x", flush=True)
    return dict(ms=ms, max_abs_err=errs)


def main(argv=None) -> dict:
    parser = device_parser(__doc__.splitlines()[0])
    parser.add_argument("shape", nargs="?", default="480x640", help="HxW")
    args = parser.parse_args(argv)
    h, w = (int(v) for v in args.shape.split("x"))
    return run(resolve_device(args.device), h, w)


if __name__ == "__main__":
    main()
