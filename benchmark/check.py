"""The comparison that decides ``correct``: what the timed path produced,
held against the plain references of ``benchmark/reference`` by the
checks that the cell's configuration names.

A check is a module ``checks/<name>.py``, loaded by its path.  A
configuration lists its checks in ``checks``; the run refuses it before
set-up (``prepare``) if it lists none or one without a module, and runs
them in the listed order once the window has closed.  A check declares:

* ``NUMBERS``: the names of the numbers it produces.  Each has its limit
  in ``limits/<workload>.json`` or in the configuration's ``guarantees``
  (which wins), or the run is refused;
* ``FOLLOWS``: ``{key: allowed values}`` of the configuration (a key of
  the file, such as ``mode``, else a setting) that its reference follows;
  another value is refused;
* ``TRACK`` (optional): it judges the track, and a workload fused at given
  poses (``known_pose``) runs it not;
* ``NEEDS``, ``SHARES`` (optional): the intermediate results it takes from
  a check listed before it, and those it leaves for later ones, in the
  ``shared`` dict (``render``: the reference's render of the program's
  final volume at the last pose, float32);
* ``before_frame(pipe)`` (optional): what it copies of the program before
  each of the frames tracked after the window, ``{key: value}``: the
  program readings then hold ``[(frame, value), ...]`` under the key;
* ``read(pipe)`` (optional): what it keeps of the program after the last
  frame, before the pipeline is freed, ``{key: value}``;
* ``numbers(inp, shared)``: its numbers, from plain references that import
  nothing of the program;
* ``control(inp, shared)``: the same numbers with the references in
  bfloat16 put in the program's place, the control that has to come out
  not correct.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spec

RENDER_DEPTH_TOL = 1e-4   # m


@dataclasses.dataclass
class Plan:
    """The checks a run runs, in order, and each of their numbers' limit."""

    checks: list
    limits: dict


def _value(config: dict, key: str):
    return config[key] if key in config else config["settings"][key]


def prepare(cell: spec.Cell) -> Plan:
    """The cell's checks and limits; ValueError for a configuration that
    lists no check, names one that has no module, sets a value one of its
    references does not follow, or leaves a number without a limit."""
    conf = cell.config
    names = conf.get("checks")
    if not names:
        raise ValueError(f"the configuration {conf.get('name')!r} lists no checks")
    mods = [spec.check_module(n, cell.root) for n in names]
    known = bool(cell.traffic.get("known_pose"))
    guarantees = conf.get("guarantees", {})
    shared, limits, checks = set(), {}, []
    for name, mod in zip(names, mods):
        if known and getattr(mod, "TRACK", False):
            continue
        for key, allowed in mod.FOLLOWS.items():
            if _value(conf, key) not in allowed:
                raise ValueError(f"the check {name!r} follows {key} in {list(allowed)}, "
                                 f"not {_value(conf, key)!r}")
        missing = set(getattr(mod, "NEEDS", ())) - shared
        if missing:
            raise ValueError(f"the check {name!r} needs {sorted(missing)} of a check "
                             "listed before it")
        shared |= set(getattr(mod, "SHARES", ()))
        for number in mod.NUMBERS:
            if number in limits:
                raise ValueError(f"two checks produce {number!r}")
            if number in guarantees:
                limits[number] = guarantees[number]
            elif number in cell.limits:
                limits[number] = cell.limits[number]
            else:
                raise ValueError(f"{number!r} (check {name!r}) has no limit in "
                                 f"limits/{cell.name}.json or the configuration's guarantees")
        checks.append(mod)
    return Plan(checks, limits)


def before_frame(plan: Plan, pipe, frame: int, program: dict) -> None:
    """Each check's copies of the program before frame ``frame`` runs."""
    for mod in plan.checks:
        if hasattr(mod, "before_frame"):
            for key, value in mod.before_frame(pipe).items():
                program.setdefault(key, []).append((frame, value))


def read(plan: Plan, pipe, program: dict) -> None:
    """What each check keeps of the program after its last frame."""
    for mod in plan.checks:
        if hasattr(mod, "read"):
            program.update(mod.read(pipe))


def program_volume(pipe) -> dict:
    """The program's volume (its buffers, not copied): TSDF, weight,
    packed colour, block coordinates and the allocation counter."""
    v = pipe.state.volume
    return {"tsdf": v.tsdf, "weight": v.weight, "colorpack": v.colorpack,
            "block_coords": v.block_coords, "free_count": int(v.free_count)}


def program_model(pipe) -> dict:
    """A copy of the last frame's model maps: depth, validity, normals and
    the intensity (the model colour's first channel)."""
    m = pipe.state.model
    return {"depth": m.depth.clone(), "valid": m.valid.clone(),
            "normal": torch.stack([m.nx, m.ny, m.nz], -1).clone(),
            "intensity": m.color[..., 0].clone()}


def fused_frames(failures: np.ndarray, degenerate: np.ndarray) -> np.ndarray:
    """(n,) whether each frame was fused: its track neither distrusted nor
    degenerate (the counters after each frame did not move)."""
    prev_f = np.concatenate([[0], failures[:-1]])
    prev_d = np.concatenate([[0], degenerate[:-1]])
    return (failures == prev_f) & (degenerate == prev_d)


def render_mismatch(got: dict, want: dict, differ=None) -> float:
    """Share of the pixels valid on either side where two renders differ:
    validity, the depth by more than ``RENDER_DEPTH_TOL``, or, where both
    are valid, what ``differ(got, want)`` marks."""
    either = got["valid"] | want["valid"]
    both = got["valid"] & want["valid"]
    bad = (got["valid"] != want["valid"]) | (
        both & (torch.abs(got["depth"] - want["depth"]) > RENDER_DEPTH_TOL))
    if differ is not None:
        bad |= both & differ(got, want)
    n = int(either.sum())
    return float((bad & either).sum()) / n if n else 1.0


class Inputs:
    """What the references need: the run's frames on ``device`` (one turn,
    uploaded once), the true positions, the frames fused, the seed, and
    what the checks kept of the program (``program``)."""

    def __init__(self, stream, run: dict, program: dict, config: dict, traffic: dict,
                 device, seed: int):
        self.depth = torch.from_numpy(stream.depth.astype(np.int32)).to(device)
        self.color = torch.from_numpy(stream.color).to(device)
        self.turn = len(stream)
        self.run = run
        self.program = program
        self.config = config
        self.traffic = traffic
        self.device = device
        self.seed = seed
        idx = np.arange(len(run["rot"])) % self.turn
        self.gt_trans = stream.translation[idx]
        self.fused = fused_frames(run["failures"], run["degenerate"])

    def frames(self, i):
        k = i % self.turn
        return self.depth[k], self.color[k]

    def last_pose(self):
        r = self.run
        return (torch.from_numpy(r["rot"][-1]).to(self.device),
                torch.from_numpy(r["trans"][-1]).to(self.device))


def _produced(mod, got: dict) -> dict:
    if set(got) != set(mod.NUMBERS):
        raise RuntimeError(f"{mod.__name__} produced {sorted(got)}, not {sorted(mod.NUMBERS)}")
    return got


def numbers(plan: Plan, inp: Inputs) -> tuple[dict, dict]:
    """The program's numbers, check by check, and the intermediate results
    the checks shared (the control is held against them)."""
    values, shared = {}, {}
    for mod in plan.checks:
        values.update(_produced(mod, mod.numbers(inp, shared)))
    return values, shared


def control_numbers(plan: Plan, inp: Inputs, shared: dict) -> dict:
    """The bfloat16 control's numbers, check by check."""
    out = {}
    for mod in plan.checks:
        out.update(mod.control(inp, shared))
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; ``correct`` when every one is within."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
