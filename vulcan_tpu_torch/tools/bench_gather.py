"""Chained-gather rate probe (T2-T4): the port of
``tools/bench_pallas_gather.py``.

Each case runs ``rounds`` chained lookups in ONE kernel launch, for every
element (i, j) of an index array:

    v = table[idx[i, j], j];  idx = |idx + int(v) + k| % T;  acc += v

  T2  f32 table (2048, 128), 32 rounds: the table sliced by column into
      shared memory (``csrc/gather.cu``, smem path);
  T3  the same on an int32 table with values in [-128, 127];
  T4  f32 table (16384, 128), 4 rounds: 8 MB read through L2.

Inputs come from ``default_rng(0)`` in the JAX tool's order (table, idx0,
table_i, table2, idx2).  Every case is checked equal to the plain version
(a loop of ``torch.gather``) before it is timed; it prints M lookups/s,
and the time of ``torch.gather`` for one round times the round count as a
reference point (no single PyTorch call computes the chain).

    python -m vulcan_tpu_torch.tools.bench_gather [--device cpu]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils.device import resolve_device
from .timing import clock_name, device_parser, time_ms

ROUNDS = 32
ROUNDS_L2 = 4


def chained_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                         rounds: int) -> torch.Tensor:
    """Plain version of the kernel, round by round in int32 like the
    reference (``astype(int32)`` truncates toward zero, as ``.to`` does)."""
    t = table.shape[0]
    acc = torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    for k in range(rounds):
        v = torch.gather(table, 0, idx.long())
        vi = v if v.dtype == torch.int32 else v.to(torch.int32)
        idx = torch.abs(idx + vi + k) % t
        acc = acc + v
    return acc


def chained_gather(table: torch.Tensor, idx: torch.Tensor,
                   rounds: int) -> torch.Tensor:
    """``rounds`` chained lookups.  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/gather.cu`` and counts it in
    ``chained_gather.launches["<dtype>/<smem|l2>"]``."""
    if table.is_cpu:
        return chained_gather_plain(table, idx, rounds)
    out = cuda_kernels.chained_gather(table, idx, rounds)
    chained_gather.launches[launch_key(table)] += 1
    return out


chained_gather.launches = {
    f"{dt}/{path}": 0 for dt in ("float32", "int32") for path in ("smem", "l2")
}


def launch_key(table: torch.Tensor) -> str:
    """Which of the kernel's paths a table takes, as a launch-count key."""
    dtype = str(table.dtype).removeprefix("torch.")
    return f"{dtype}/{cuda_kernels.gather_path(table.shape[0])}"


class Case(NamedTuple):
    name: str               # the TPU probe it ports: T2, T3 or T4
    tag: str
    table: torch.Tensor
    idx: torch.Tensor
    rounds: int

    @property
    def lookups(self) -> int:
        return self.idx.numel() * self.rounds


def make_cases(device) -> list[Case]:
    """The JAX tool's three cases."""
    rng = np.random.default_rng(0)
    t, lanes = 2048, 128
    table = rng.standard_normal((t, lanes)).astype(np.float32)
    idx0 = rng.integers(0, t, (t, lanes)).astype(np.int32)
    table_i = rng.integers(-128, 127, (t, lanes)).astype(np.int32)
    t2 = 16384
    table2 = rng.standard_normal((t2, lanes)).astype(np.float32)
    idx2 = rng.integers(0, t2, (t2, lanes)).astype(np.int32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return [
        Case("T2", f"take_along_axis f32 ({t}x{lanes}) x{ROUNDS}",
             dev(table), dev(idx0), ROUNDS),
        Case("T3", f"take_along_axis i32 ({t}x{lanes}) x{ROUNDS}",
             dev(table_i), dev(idx0), ROUNDS),
        Case("T4", f"take_along_axis f32 ({t2}x{lanes}) x{ROUNDS_L2}",
             dev(table2), dev(idx2), ROUNDS_L2),
    ]


def gather_rounds(case: Case) -> torch.Tensor:
    """``torch.gather`` for one round, ``case.rounds`` times (reference
    point only: it does not chain the indices)."""
    idx = case.idx.long()
    for _ in range(case.rounds):
        v = torch.gather(case.table, 0, idx)
    return v


def run(device, reps: int = 10) -> list[dict]:
    """Check each case's kernel against the plain version (exact), time
    kernel, plain version and gather x rounds, print M lookups/s."""
    device = torch.device(device)
    results = []
    for case in make_cases(device):
        got = chained_gather(case.table, case.idx, case.rounds)
        want = chained_gather_plain(case.table, case.idx, case.rounds)
        if not torch.equal(got, want):
            raise RuntimeError(f"{case.name} {case.tag}: kernel differs from the plain version")
        ms = time_ms(lambda c=case: chained_gather(c.table, c.idx, c.rounds),
                     device, reps=reps)
        plain_ms = time_ms(lambda c=case: chained_gather_plain(c.table, c.idx, c.rounds),
                           device, reps=reps)
        ref_ms = time_ms(lambda c=case: gather_rounds(c), device, reps=reps)
        rate = case.lookups / ms * 1e3 / 1e6
        print(f"{case.name} {case.tag:42s} {ms:9.4f} ms ({clock_name(device)})",
              flush=True)
        print(f"    -> {rate:.0f} M lookups/s ({case.lookups / 1e6:.1f}M total); "
              f"plain {plain_ms:.4f} ms; torch.gather x{case.rounds} {ref_ms:.4f} ms",
              flush=True)
        results.append(dict(name=case.name, tag=case.tag, ms=ms, plain_ms=plain_ms,
                            gather_rounds_ms=ref_ms, m_lookups_per_s=rate))
    return results


def main(argv=None) -> list[dict]:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
