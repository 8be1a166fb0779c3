"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names each workload's configuration and traffic mix, and each metric;
``configs/<name>.json``, ``traffic/<name>.json``, ``limits/<workload>.json``
and ``metrics/<metric>.py`` hold them, and the configuration's ``checks``
names the modules ``checks/<check>.py`` that decide ``correct``
(``check.py``).  A new cell, metric or check is new files and new entries
(a new check: its file under ``checks/`` and its name in a
configuration's ``checks``), never an edit of a file here."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # the limits of the numbers `correct` compares
    end_to_end: list      # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list       # BENCHMARK.json's per_layer entries this cell reports
    root: Path = ROOT     # the checkout whose ``benchmark/`` holds its checks and readers


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reported(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root``'s ``BENCHMARK.json``; KeyError if
    it names no such workload."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    here = root / "benchmark"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        root=root,
    )


def _module(kind: str, name: str, root: Path):
    """``benchmark/<kind>/<name>.py`` of ``root``, loaded by its path."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric, root).read


def traced_kernels(metric: str, root: Path = ROOT) -> tuple:
    """The counted kernels (``trace.KERNEL_NAMES``' keys) whose traced
    launches ``metrics/<metric>.py`` reads: its ``TRACED``, if any."""
    return tuple(getattr(_module("metrics", metric, root), "TRACED", ()))


def check_module(name: str, root: Path = ROOT):
    """The module ``checks/<name>.py``; ValueError if there is none."""
    if not (root / "benchmark" / "checks" / f"{name}.py").is_file():
        raise ValueError(f"no module benchmark/checks/{name}.py for the check {name!r}")
    return _module("checks", name, root)
