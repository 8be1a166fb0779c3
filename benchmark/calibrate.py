"""Readings for the limits of ``correct``: runs one workload on several
seeds in one process, each with the bfloat16 control computed beside the
program's numbers (unless ``--control 0``), and writes one JSON line a
seed.

    python3 -m benchmark.calibrate --workload <name> --seconds <s> --seeds <n> [<n> ...] \\
        [--control 0|1] [--out calibrate.jsonl]

Not part of a measured run: the benchmark's own runs never compute the
control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default="calibrate.jsonl")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            r = run.execute(cell, seed, args.seconds, False, control=bool(args.control))
            line = {"workload": cell.name, "seed": seed, "seconds": args.seconds,
                    "attempted": r["attempted"], "correct": r["correct"],
                    "control_correct": r.get("control_correct"), "checks": r["checks"],
                    "metrics": r["metrics"], "device": r["device"]}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
