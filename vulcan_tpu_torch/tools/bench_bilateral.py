"""Bilateral filter (K1) tile probe: the kernel's compile-time tile shapes
timed against each other, and its instruction count a tap.

``csrc/bilateral.cu`` is compiled alone once per ``(rows a thread, thread
rows a block)`` pair of ``TILES`` (``-DK1_ROWS_PER_THREAD``,
``-DK1_BLOCK_ROWS``); each build is checked against the plain version
(max abs error <= 1e-5 m) and timed on the card, device time of
back-to-back launches.  ``sass.sass_counts`` disassembles a built library
with ``cuobjdump`` and counts the instructions of the radius-2 kernel, so
the cost of a tap can be read off the machine code.  Needs the card and the
CUDA toolkit:

    python -m vulcan_tpu_torch.tools.bench_bilateral [--sass-of LIBRARY.so]

Input: ``default_rng(0)`` depths uniform in [0.5, 3) m with 10% zero holes,
480x640, the default ``Config``.
"""
from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..ops import cuda_kernels, preprocess
from .sass import sass_counts
from .timing import device_ms, max_abs_err

TOL = 1e-5  # m: ex2.approx and the folded exponent (csrc/bilateral.cu)
# (rows a thread, thread rows a block): the tile is 32 x (rows * thread rows).
TILES = ((1, 8), (2, 4), (2, 8), (4, 2), (4, 4), (4, 8), (5, 4), (6, 4), (8, 2), (8, 4))
KERNEL = r"bilateral_kernelILi2E"   # the radius-2 instantiations, mangled


def make_input(h: int, w: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    d[rng.random((h, w)) < 0.10] = 0.0
    return torch.from_numpy(d).to(device)


def print_sass(library: Path, taps: int) -> None:
    """``taps``: the taps one thread computes (25 a pixel at radius 2)."""
    for f in sass_counts(library, KERNEL):
        top = ", ".join(f"{op} {n}" for op, n in f["ops"].most_common(12))
        staging = {"Lb1E": "16-byte staging", "Lb0E": "word staging"}.get(
            f["function"].split("bilateral_kernelILi2E")[1][:4], "one form")
        print(f"sass radius-2 kernel, {staging}: {f['total']} instructions, "
              f"{f['total'] / taps:.2f} a tap over {taps} taps a thread; "
              f"MUFU.EX2 {f['ops']['MUFU.EX2']}; {top}", flush=True)


def run(device, h: int = 480, w: int = 640) -> list[dict]:
    """Build, check and time every tile of ``TILES``; print the times, the
    registers ptxas reports and the instruction count a tap."""
    cfg = Config()
    x = make_input(h, w, device)
    want = preprocess._bilateral_math(x, cfg)
    k = preprocess._bilateral_constants(cfg)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for per_thread, block_rows in TILES:
        defines = (f"K1_ROWS_PER_THREAD={per_thread}", f"K1_BLOCK_ROWS={block_rows}")
        lib, log = cuda_kernels.build_variant("bilateral.cu", defines)
        fn = cuda_kernels.bind(lib, ("vulcan_bilateral",)).vulcan_bilateral

        def call(fn=fn):
            err = fn(x.data_ptr(), out.data_ptr(), h, w, k.radius, k.pointer, k.neg_a, None,
                     stream)
            if err:
                raise RuntimeError(f"bilateral {defines}: CUDA error {err}")

        call()
        err = max_abs_err(out, want)
        if not err <= TOL:
            raise RuntimeError(f"bilateral {defines}: max abs error {err} above {TOL} m")
        ms = device_ms(call)
        regs = re.findall(r"bilateral_kernelILi2ELb1.*?Used (\d+) registers", log, re.S)
        tiles = -(-w // 32) * -(-h // (per_thread * block_rows))
        print(f"K1 tile 32x{per_thread * block_rows:<3d} ({per_thread} rows a thread, "
              f"{32 * block_rows:3d} threads, {tiles:4d} tiles): {ms:.6f} ms, "
              f"max_abs_err {err:.3e}, registers {regs[0] if regs else '?'}", flush=True)
        rows.append(dict(rows_per_thread=per_thread, block_rows=block_rows, ms=ms,
                         max_abs_err=err))
        if (per_thread, block_rows) in ((1, 8), (2, 8)):
            lib_path = cuda_kernels.library_path([cuda_kernels.CSRC / "bilateral.cu"], defines)
            print_sass(lib_path, 25 * per_thread)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass-of", type=Path, default=None,
                        help="only count the radius-2 kernel's instructions in this "
                             "library (one output a thread assumed)")
    args = parser.parse_args(argv)
    if args.sass_of is not None:
        return print_sass(args.sass_of, 25)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_bilateral times CUDA kernels: it needs the card")
    return run(torch.device("cuda:0"))


if __name__ == "__main__":
    main()
