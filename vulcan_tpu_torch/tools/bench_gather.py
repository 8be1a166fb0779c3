"""Chained-gather rate probe (T2-T4): the port of
``tools/bench_pallas_gather.py``.

Each case runs ``rounds`` chained lookups in ONE kernel launch, for every
element (i, j) of an index array:

    v = table[idx[i, j], j];  idx = |idx + int(v) + k| % T;  acc += v

  T2  f32 table (2048, 128), 32 rounds: the table sliced by column into
      shared memory (``csrc/gather.cu``, smem path: a block owns 16
      columns, ``cuda_kernels.smem_plan``);
  T3  the same on an int32 table with values in [-128, 127];
  T4  f32 table (16384, 128), 4 rounds: 8 MB held in shared memory, two
      whole columns a block (columns path, ``cuda_kernels.gather_plan``);
      printed beside it, "T4/l2": the same case forced through L2
      (``path="l2"``), the card's gather rate from a table too large for
      shared memory.

Inputs come from ``default_rng(0)`` in the JAX tool's order (table, idx0,
table_i, table2, idx2).  Every case is checked equal to the plain version
(a loop of ``torch.gather``) before it is timed; it prints M lookups/s,
and the time of ``torch.gather`` for one round times the round count as a
reference point (no single PyTorch call computes the chain).

``variant_times`` times the alternatives of the path a case takes, each
first checked exact.  On the smem path (``SMEM_VARIANTS``): 16, 8, 4 or 2
columns a block with 1, 2, 4 or 8 copies of each, and thread-block clusters
of 2 row slabs that share one staging pass; the first row is the first
port's partition and the plan's own choice.  On the columns path (``VARIANTS``): a block alone or a
cluster of 2 or 8 blocks that owns a group of columns in distributed
shared memory, one or two columns a block, planar or interleaved.
``round_costs`` splits one launch's time: device ms at 0, 1, 16, 32 and 64
rounds (0 rounds is the launch, the staging, idx in and out; the slope is
one round), on 16 rows of idx (the staging nearly alone) and on a table of
64 rows (the same grid with next to nothing to stage).

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
                   path: str | None = None, plan=None) -> torch.Tensor:
    """``rounds`` chained lookups.  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/gather.cu`` and counts it in
    ``chained_gather.launches["<dtype>/<smem|columns|l2>"]``.  ``path``
    forces one of the kernel's paths and ``plan`` a partition of it
    (``cuda_kernels.smem_plan``, ``gather_plan``); either raises, for a CPU
    tensor too, if it cannot hold the table."""
    key = launch_key(table, path)
    if plan is not None:
        cuda_kernels.check_gather_plan(key.split("/")[1], plan, table.shape[0], idx.shape[0])
    if table.is_cpu:
        return chained_gather_plain(table, idx, rounds)
    out = cuda_kernels.chained_gather(table, idx, rounds, path=path, plan=plan)
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
    ("cluster of 8, 1 column a block", 8, 1, None, False),
)

# The smem path's alternatives: (name, cols_per_block, cluster_blocks).  The
# first is the first port's partition and the plan's own choice.
SMEM_VARIANTS = (
    ("16 columns a block, 1 copy", 16, 1),
    ("8 columns, 2 copies", 8, 1),
    ("4 columns, 4 copies", 4, 1),
    ("2 columns, 8 copies", 2, 1),
    ("8 columns, 2 copies, cluster of 2 stages once", 8, 2),
    ("16 columns, 1 copy, cluster of 2 stages once", 16, 2),
)


def variant_plans(case: Case) -> list[tuple[str, dict]]:
    """``(name, chained_gather keywords)`` of every alternative of the path
    ``case``'s table takes, then the path's own plan."""
    sms = cuda_kernels._sm_count(case.table.get_device())
    shape = (*case.table.shape, case.idx.shape[0], sms)
    if cuda_kernels.gather_path(shape[0]) == "smem":
        calls = [(name, dict(plan=cuda_kernels.smem_plan(*shape, cpb, blocks)))
                 for name, cpb, blocks in SMEM_VARIANTS]
        return calls + [("default (smem_plan)", {})]
    calls = [(name, dict(path="columns", plan=cuda_kernels.gather_plan(
                 *shape, blocks, cpb, slabs, interleaved)))
             for name, blocks, cpb, slabs, interleaved in VARIANTS]
    return calls + [("default (gather_plan)", {}), ("l2", dict(path="l2"))]


def variant_times(case: Case, reps: int = 20) -> list[dict]:
    """Device ms of ``case`` under each of ``variant_plans`` (each first
    checked equal to the plain version) with the clusters the card runs at
    once beside the clusters the plan launches."""
    want = chained_gather_plain(case.table, case.idx, case.rounds)
    t_rows, cols = case.table.shape
    rows = []
    for name, kw in variant_plans(case):
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


ROUND_STEPS = (0, 1, 16, 32, 64)


def round_costs(case: Case, reps: int = 50, **kw) -> dict[str, float]:
    """Device ms of one launch on ``case``'s table and idx at each round
    count of ``ROUND_STEPS``, on its first 16 rows of idx alone, and on a
    table cut to 64 rows: 0 rounds is the launch, the staging, idx in and
    out; the slope is one round; 16 rows leave the staging nearly alone; 64
    rows of table leave the same grid with next to nothing to stage.  ``kw``
    goes to ``cuda_kernels.chained_gather`` (a plan)."""
    few = case.idx[:16].contiguous()
    short = case.table[:64].contiguous()
    steps = [(f"{r} rounds", case.table, case.idx, r) for r in ROUND_STEPS]
    steps += [(f"{r} rounds, 16 rows of idx", case.table, few, r) for r in (0, case.rounds)]
    steps += [("0 rounds, 64 rows of table", short, case.idx % 64, 0)]
    return {
        name: device_ms(lambda table=table, idx=idx, r=r: cuda_kernels.chained_gather(
            table, idx, r, **kw), reps=reps)
        for name, table, idx, r in steps
    }


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
