"""Chained-gather rate probe (T2-T4): the port of
``tools/bench_pallas_gather.py``.

Each case runs ``rounds`` chained lookups in ONE kernel launch, for every
element (i, j) of an index array:

    v = table[idx[i, j], j];  idx = |idx + int(v) + k| % T;  acc += v

  T2  f32 table (2048, 128), 32 rounds: the table sliced by column into
      shared memory (``csrc/gather.cu``, smem path);
  T3  the same on an int32 table with values in [-128, 127];
  T4  f32 table (16384, 128), 4 rounds: 8 MB held in shared memory, two
      whole columns a block (columns path); printed beside it, "T4/l2":
      the same case forced through L2 (``path="l2"``), the card's gather
      rate from a table too large for shared memory.

Inputs come from ``default_rng(0)`` in the JAX tool's order (table, idx0,
table_i, table2, idx2).  Every case is checked equal to the plain version
(a loop of ``torch.gather``) before it is timed; it prints M lookups/s,
and the time of ``torch.gather`` for one round times the round count as a
reference point (no single PyTorch call computes the chain).

``variant_times`` times the columns path's alternatives on one case: a
block alone or a thread-block cluster of 2 to 16 blocks that owns a group
of columns in distributed shared memory, one or two columns a block,
planar or interleaved.

    python -m vulcan_tpu_torch.tools.bench_gather [--device cpu]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils.device import resolve_device
from .timing import clock_name, device_ms, device_parser, time_ms

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


def chained_gather(table: torch.Tensor, idx: torch.Tensor, rounds: int,
                   path: str | None = None) -> torch.Tensor:
    """``rounds`` chained lookups.  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/gather.cu`` and counts it in
    ``chained_gather.launches["<dtype>/<smem|columns|l2>"]``.  ``path``
    forces one of the kernel's paths and raises if it cannot hold the
    table."""
    key = launch_key(table, path)
    if table.is_cpu:
        return chained_gather_plain(table, idx, rounds)
    out = cuda_kernels.chained_gather(table, idx, rounds, path=path)
    chained_gather.launches[key] += 1
    return out


chained_gather.launches = {
    f"{dt}/{path}": 0 for dt in ("float32", "int32") for path in cuda_kernels.GATHER_PATHS
}


def launch_key(table: torch.Tensor, path: str | None = None) -> str:
    """Which of the kernel's paths a table takes (``path`` forces one), as a
    launch-count key."""
    dtype = str(table.dtype).removeprefix("torch.")
    return f"{dtype}/{cuda_kernels.check_gather_path(table.shape[0], path)}"


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


# The columns path's alternatives: (name, cluster_blocks, cols_per_block,
# row_slabs or None for the plan's own, interleaved).  In a cluster a block
# takes rows across all of the group's columns and asks the shared memory of
# the block that holds the column for every lookup.
VARIANTS = (
    ("block alone, 1 column", 1, 1, None, False),
    ("block alone, 2 columns, 1 row slab", 1, 2, 1, False),
    ("block alone, 2 columns", 1, 2, None, False),
    ("block alone, 2 columns, interleaved", 1, 2, None, True),
    ("cluster of 2, 2 columns a block", 2, 2, None, False),
    ("cluster of 4, 2 columns a block", 4, 2, None, False),
    ("cluster of 8, 1 column a block", 8, 1, None, False),
    ("cluster of 8, 2 columns a block", 8, 2, None, False),
    ("cluster of 8, 2 columns, interleaved", 8, 2, None, True),
    ("cluster of 16, 1 column a block", 16, 1, None, False),
)


def variant_times(case: Case, reps: int = 20) -> list[dict]:
    """Device ms of ``case`` under each of ``VARIANTS`` (each first checked
    equal to the plain version) with the clusters the card runs at once
    beside the clusters the plan launches, then on the default plan and
    forced through L2."""
    want = chained_gather_plain(case.table, case.idx, case.rounds)
    sms = cuda_kernels._sm_count(case.table.get_device())
    t_rows, cols = case.table.shape
    calls = []
    for name, blocks, cpb, slabs, interleaved in VARIANTS:
        plan = cuda_kernels.gather_plan(t_rows, cols, case.idx.shape[0], sms, blocks,
                                        cpb, slabs, interleaved)
        calls.append((name, dict(path="columns", plan=plan)))
    calls += [("default (gather_plan)", {}), ("l2", dict(path="l2"))]
    rows = []
    for name, kw in calls:
        def call(kw=kw):
            return cuda_kernels.chained_gather(case.table, case.idx, case.rounds, **kw)
        if not torch.equal(call(), want):
            raise RuntimeError(f"{case.name} {name}: kernel differs from the plain version")
        ms = device_ms(call, reps=reps)
        plan = kw.get("plan")
        row = dict(name=name, ms=ms, m_lookups_per_s=case.lookups / ms / 1e3, plan=plan)
        if plan is not None and plan.cluster_blocks > 1:
            gx, gy = plan.grid(cols)
            row["clusters"] = gx * gy // plan.cluster_blocks
            row["clusters_at_once"] = cuda_kernels.gather_max_clusters(t_rows, cols, plan)
        rows.append(row)
    return rows


def run(device, reps: int = 10) -> list[dict]:
    """Check each case's kernel against the plain version (exact), time
    kernel, plain version and gather x rounds, print M lookups/s.  T4 runs
    twice: on its own path and forced through L2."""
    device = torch.device(device)
    cases = [(c.name, c, None) for c in make_cases(device)]
    cases.append(("T4/l2", cases[-1][1], "l2"))
    results = []
    for name, case, path in cases:
        def kernel(c=case, path=path):
            return chained_gather(c.table, c.idx, c.rounds, path=path)
        want = chained_gather_plain(case.table, case.idx, case.rounds)
        if not torch.equal(kernel(), want):
            raise RuntimeError(f"{name} {case.tag}: kernel differs from the plain version")
        ms = time_ms(kernel, device, reps=reps)
        plain_ms = time_ms(lambda c=case: chained_gather_plain(c.table, c.idx, c.rounds),
                           device, reps=reps)
        ref_ms = time_ms(lambda c=case: gather_rounds(c), device, reps=reps)
        rate = case.lookups / ms * 1e3 / 1e6
        where = launch_key(case.table, path).split("/")[1]
        print(f"{name:5s} {case.tag:38s} {ms:9.4f} ms ({clock_name(device)}, {where})",
              flush=True)
        print(f"    -> {rate:.0f} M lookups/s ({case.lookups / 1e6:.1f}M total); "
              f"plain {plain_ms:.4f} ms; torch.gather x{case.rounds} {ref_ms:.4f} ms",
              flush=True)
        results.append(dict(name=name, tag=case.tag, path=where, ms=ms, plain_ms=plain_ms,
                            gather_rounds_ms=ref_ms, m_lookups_per_s=rate))
    return results


def main(argv=None) -> list[dict]:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
