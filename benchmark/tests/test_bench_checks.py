"""The checks that decide ``correct`` as modules a configuration names, and
the per-layer metrics read from the program's spans: a check added by new
files alone, each configuration the checks refuse before set-up, the
numbers each cell compares, and the span readers on spans made here."""
import copy
import dataclasses
import json
import shutil

import pytest

from benchmark import check, run, spec
from benchmark.tests.host import HostCard, small_cell
from benchmark.tests.test_bench_run import _loaded

HARNESS = ("run.py", "check.py", "spec.py")

# What each cell compared before its checks became modules.
NUMBERS = {
    "splat-desk": ["ate_m", "track_gap_mm", "track_gap_deg", "render_mismatch",
                   "volume_mismatch", "overflows"],
    "march-orbit": ["ate_m", "track_gap_mm", "track_gap_deg", "render_mismatch",
                    "volume_mismatch", "overflows"],
    "splat-desk-known": ["render_mismatch", "volume_mismatch", "overflows"],
}

DUMMY = '''\
"""dummy: one number the test chooses."""
NUMBERS = ("dummy_gap",)
FOLLOWS = {{"mode": ("combined",)}}


def read(pipe):
    return {{"dummy_frame": int(pipe.state.frame_idx)}}


def numbers(inp, shared):
    assert inp.program["dummy_frame"] > 0 and "render" in shared
    return {{"dummy_gap": {value}}}


def control(inp, shared):
    return {{"dummy_gap": 2.0}}
'''


@pytest.mark.parametrize("workload", sorted(NUMBERS))
def test_number_names_per_cell(workload):
    plan = check.prepare(spec.cell(workload))
    assert list(plan.limits) == NUMBERS[workload]
    conf = spec.cell(workload).config
    assert plan.limits["overflows"] == conf["guarantees"]["overflows"] == 0
    if "ate_m" in plan.limits:
        assert plan.limits["ate_m"] == conf["guarantees"]["ate_m"]


@pytest.mark.parametrize("value, correct", [(0.5, True), (1.5, False)])
def test_check_added_by_new_files_alone(tmp_path, monkeypatch, value, correct):
    monkeypatch.setattr(run, "THROWAWAY_FRAMES", 1)
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    (root / "benchmark/checks/dummy.py").write_text(DUMMY.format(value=value))
    conf_file = root / "benchmark/configs/splat-combined.json"
    conf = json.loads(conf_file.read_text())
    conf["checks"].append("dummy")
    conf_file.write_text(json.dumps(conf))
    limits_file = root / "benchmark/limits/splat-desk-known.json"
    limits = json.loads(limits_file.read_text())
    limits["dummy_gap"] = 1.0
    limits_file.write_text(json.dumps(limits))
    r = run.execute(small_cell("splat-desk-known", root), 2**31 + 13, 0.5, False,
                    control=True, card=HostCard())
    assert r["checks"]["dummy_gap"] == {"value": value, "limit": 1.0, "control": 2.0}
    assert list(r["checks"]) == NUMBERS["splat-desk-known"] + ["dummy_gap"]
    assert r["correct"] is correct, r["checks"]
    assert r["control_correct"] is False
    for name in HARNESS:
        assert (root / "benchmark" / name).read_bytes() == (spec.HERE / name).read_bytes()


def _settings(**kw):
    return lambda conf: conf["settings"].update(kw)


REFUSED = {
    "splat polished": ("splat-desk", _settings(splat_polish=2), "splat_polish"),
    "splat direct": ("splat-desk", _settings(splat_source="direct"), "splat_source"),
    "splat rgb": ("splat-desk-known", _settings(model_color="rgb"), "model_color"),
    "track light": ("splat-desk", lambda conf: conf.update(mode="light"), "mode"),
    "march as splat": ("march-orbit", _settings(render_mode="splat"), "render_mode"),
    "no checks": ("splat-desk", lambda conf: conf.pop("checks"), "lists no checks"),
    "no module": ("splat-desk", lambda conf: conf["checks"].append("no-such-check"),
                  "no module"),
    "volume first": ("march-orbit", lambda conf: conf["checks"].insert(0, "volume"),
                     "needs"),
}


@pytest.mark.parametrize("case", sorted(REFUSED) + ["no limit"])
def test_refused_before_set_up(monkeypatch, case):
    def set_up(*args, **kw):
        raise AssertionError("set-up began")

    monkeypatch.setattr(run.scene, "make_stream", set_up)
    if case == "no limit":
        cell = small_cell("splat-desk")
        limits = {k: v for k, v in cell.limits.items() if k != "render_mismatch"}
        cell, match = dataclasses.replace(cell, limits=limits), "render_mismatch"
    else:
        workload, edit, match = REFUSED[case]
        cell = small_cell(workload)
        conf = copy.deepcopy(cell.config)
        edit(conf)
        cell = dataclasses.replace(cell, config=conf)
    with pytest.raises(ValueError, match=match):
        run.execute(cell, 1, 0.1, False, card=HostCard())


def test_checks_load_nothing_of_the_program():
    top = _loaded("from benchmark import spec\n"
                  "for p in sorted((spec.HERE / 'checks').glob('*.py')):\n"
                  "    spec.check_module(p.stem)")
    assert not top & {"jax", "jaxlib", "flax", "vulcan_tpu", "vulcan_tpu_torch"}


def _spans(frames, gap_ns=400_000, track=True):
    """Spans as ``Pipeline.trace_spans`` gives them: each frame's step of
    2.9 ms split 0.3 / 1.0 / 0.8 / 0.1 / 0.7 ms among the stages (the track
    left out when ``track`` is false), ``gap_ns`` between steps, and the
    host's upload (0.4 ms) and launch (0.15 ms)."""
    out, t = [], 10**12
    stages = [("preprocess", 300), ("track", 1000), ("allocate", 800), ("integrate", 100),
              ("render", 700)]
    for f in frames:
        host = t - 600_000
        out += [(f, "process", None, host, host + 600_000),
                (f, "upload", "process", host, host + 400_000),
                (f, "launch", "process", host + 400_000, host + 550_000)]
        s = t
        for name, us in stages:
            if name == "track" and not track:
                continue
            out.append((f, name, "step", s, s + us * 1000))
            s += us * 1000
        out.append((f, "step", None, t, s))
        t = s + gap_ns
    return {"spans": out, "error_ns": 500, "drift_ns": 10, "interval_s": 1.0}


def _read(metric, spans):
    return spec.reader(metric)({"spans": spans})


def test_span_readers():
    spans = _spans(range(20, 30))
    want = {"step.device_ms": 2.9, "stage.preprocess_ms": 0.3, "stage.track_ms": 1.0,
            "stage.allocate_ms": 0.8, "stage.integrate_ms": 0.1, "stage.render_ms": 0.7,
            "entry.upload_ms": 0.4, "entry.launch_ms": 0.15, "gap.host_ms": 0.4}
    for metric, ms in want.items():
        assert _read(metric, spans) == pytest.approx(ms, rel=1e-12), metric
    known = _spans(range(20, 30), track=False)
    assert _read("stage.track_ms", known) is None
    assert _read("step.device_ms", known) == pytest.approx(1.9, rel=1e-12)
    for metric in want:
        assert _read(metric, None) is None


def test_span_metrics_are_the_program_spans():
    from vulcan_tpu_torch.utils.timing import HOST_SPANS, SPANS

    bench = spec.benchmark()
    names = {m["name"] for m in bench["per_layer"] if m["source"] == "program_span"}
    assert {f"stage.{s}_ms" for s in SPANS[1:]} | {"step.device_ms", "gap.host_ms"} \
        | {f"entry.{s}_ms" for s in HOST_SPANS[1:]} <= names
    track = [m for m in bench["per_layer"] if m["name"] == "stage.track_ms"][0]
    assert track["workloads"] == ["splat-desk", "march-orbit"]


class RingPipe:
    """A pipeline that has run ``ran`` frames, of which its span ring holds
    the last ``ring``."""

    def __init__(self, ring, ran):
        self.ring, self.ran, self.asked = ring, ran, None

    def trace_spans(self, first, stop):
        self.asked = (first, stop)
        if not max(0, self.ran - self.ring) <= first <= stop <= self.ran:
            return None
        return _spans(range(first, stop))


@pytest.mark.parametrize("n_win", [100, 8192 - run.WARM_FRAMES, 9400])
def test_window_spans_hold_what_the_ring_holds(monkeypatch, n_win):
    from vulcan_tpu_torch.utils import timing

    stop = run.WARM_FRAMES + n_win
    pipe = RingPipe(timing.RING_FRAMES, stop)
    spans = run.window_spans(pipe, stop)
    first = max(run.WARM_FRAMES, stop - timing.RING_FRAMES)
    assert pipe.asked == (first, stop) and spans is not None
    assert {f for f, *_ in spans["spans"]} == set(range(first, stop))
    assert _read("stage.render_ms", spans) == pytest.approx(0.7, rel=1e-12)
    assert _read("gap.host_ms", spans) == pytest.approx(0.4, rel=1e-12)
