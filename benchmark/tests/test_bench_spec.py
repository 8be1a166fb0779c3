"""BENCHMARK.json against the benchmark's contract, and its cells,
configurations, traffic mixes and metrics found by name."""
import json
import re
import shutil

import pytest

from benchmark import scene, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
BENCH = spec.benchmark()


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"} | ({"workloads"} & set(m))
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_units_and_text():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.config["settings"] and cell.traffic["scene"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_configs_are_the_programs_config():
    from vulcan_tpu_torch.config import Config

    from benchmark.run import build_config

    for c in BENCH["configs"]:
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["reduced"] == c["reduced"] == []
        build_config(conf)               # every key is a Config field
        assert set(conf["settings"]) == set(Config.__dataclass_fields__)


def test_new_traffic_file_is_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "benchmark", root / "benchmark")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "benchmark/traffic/desk.json").read_text())
    traffic["trajectory"]["radius"] = 1.2
    (root / "benchmark/traffic/desk-wide.json").write_text(json.dumps(traffic))
    (root / "benchmark/limits/splat-desk-wide.json").write_text(
        (root / "benchmark/limits/splat-desk.json").read_text())
    bench["workloads"].append({"name": "splat-desk-wide", "config": "splat-combined",
                               "traffic": "desk-wide", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (spec.ROOT / "benchmark").rglob("*.json")}
    cell = spec.cell("splat-desk-wide", root)
    assert cell.traffic["trajectory"]["radius"] == 1.2
    rot, trans = scene.trajectory(cell.traffic)
    assert abs(float((trans[0, :2]).norm()) - 1.2) < 1e-9
    assert before == {p: p.read_bytes() for p in (spec.ROOT / "benchmark").rglob("*.json")}


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
