"""Instruction counts of built kernels, read from ``cuobjdump -sass``: a
whole function by opcode (``sass_counts``) and its loops (``sass_loops``:
the instructions between a backward branch and its target), so the cost of
a tap or a lookup can be read off the machine code.  Needs the CUDA
toolkit, not the card.
"""
from __future__ import annotations

import collections
import re
import subprocess
from pathlib import Path

from ..ops import cuda_kernels

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTRUCTION = re.compile(
    r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\s*$")


def disassemble(library: Path, kernel: str) -> dict[str, list[tuple[int, str, str]]]:
    """``{mangled name: [(address, opcode, operands), ...]}`` of every
    function of ``library`` whose mangled name matches ``kernel``."""
    cuobjdump = Path(cuda_kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    found: dict[str, list[tuple[int, str, str]]] = {}
    body = None
    for line in text.splitlines():
        head = _FUNCTION.match(line)
        if head:
            body = found.setdefault(head[1], []) if re.search(kernel, head[1]) else None
            continue
        inst = _INSTRUCTION.match(line)
        if inst and body is not None:
            body.append((int(inst[1], 16), inst[2], inst[3].strip()))
    return found


def sass_counts(library: Path, kernel: str) -> list[dict]:
    """Instruction counts of every function of ``library`` whose mangled
    name matches ``kernel``: total and by opcode."""
    return [dict(function=name, ops=(ops := collections.Counter(op for _, op, _ in body)),
                 total=sum(ops.values()))
            for name, body in disassemble(library, kernel).items()]


def sass_loops(library: Path, kernel: str) -> list[dict]:
    """The loops of every matching function: for each backward ``BRA``, the
    instructions from its target to the branch, total and by opcode,
    innermost (shortest) first."""
    rows = []
    for name, body in disassemble(library, kernel).items():
        loops = []
        for addr, op, operands in body:
            target = _TARGET.search(operands)
            if op.startswith("BRA") and target and int(target[1], 16) <= addr:
                inside = collections.Counter(
                    o for a, o, _ in body if int(target[1], 16) <= a <= addr)
                loops.append(dict(start=int(target[1], 16), end=addr, ops=inside,
                                  total=sum(inside.values())))
        rows.append(dict(function=name, total=len(body),
                         loops=sorted(loops, key=lambda lp: lp["total"])))
    return rows


def print_loops(library: Path, kernel: str, per: str, unit: str) -> list[dict]:
    """Print each matching function's loops with instructions per ``per``
    opcode prefix (``"LDS"``: a shared-memory lookup), called ``unit``."""
    rows = sass_loops(library, kernel)
    for f in rows:
        print(f"sass {f['function']}: {f['total']} instructions", flush=True)
        for lp in f["loops"]:
            n = sum(c for op, c in lp["ops"].items() if op.startswith(per))
            top = ", ".join(f"{op} {c}" for op, c in lp["ops"].most_common(10))
            each = f"{lp['total'] / n:.2f} a {unit} over {n}" if n else f"no {per}"
            print(f"  loop {lp['start']:#06x}-{lp['end']:#06x}: {lp['total']} "
                  f"instructions, {each}; {top}", flush=True)
    return rows
