"""The run as a whole, on the CPU at a small size: the last line's schema,
no result without a card, the modules it loads, and ``correct`` coming
out false for the bfloat16 control and for a broken timed path.  The
card's own run is ``test_cell_on_the_card``."""
import json
import subprocess
import sys

import pytest

from benchmark import run, spec
from benchmark.tests.host import HostCard, small_cell, small_run

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def short_profile(monkeypatch):
    monkeypatch.setattr(run, "THROWAWAY_FRAMES", 1)
    monkeypatch.setattr(run, "PROFILED_FRAMES", 2)


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_schema(traced):
    cell = spec.cell("splat-desk")
    r = small_run("splat-desk", traced=traced)
    assert list(r)[:3] == ["correct", "attempted", "failed"] and list(r)[-1] == "checks"
    assert {"metrics", "device"} <= set(r)
    assert isinstance(r["correct"], bool) and r["attempted"] >= 1
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(r["metrics"]) <= want
    if not traced:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_known_pose_traffic_runs_correct():
    cell = small_cell("splat-desk-known")
    assert cell.traffic["known_pose"] is True
    r = run.execute(cell, 2**31 + 9, 0.5, False, card=HostCard())
    assert r["correct"] is True, r["checks"]
    assert "ate_m" not in r["checks"] and "volume_mismatch" in r["checks"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "splat-desk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _loaded(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded("import torch, torch.profiler, benchmark.calibrate\n"
                  "from benchmark.tests.host import small_run\n"
                  "torch.set_num_threads(2)\n"
                  "small_run('march-orbit', traced=True, control=True, seconds=0.2, seed=3)")
    assert not top & {"jax", "jaxlib", "flax", "vulcan_tpu"}


def test_references_load_nothing_of_the_program():
    top = _loaded("import benchmark.reference.integrate, benchmark.reference.splat, "
                  "benchmark.reference.march, benchmark.reference.trajectory, benchmark.scene, "
                  "benchmark.trace, benchmark.roofline")
    assert not top & {"jax", "jaxlib", "flax", "vulcan_tpu", "vulcan_tpu_torch"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    r = small_run(workload, control=True)
    assert r["correct"] is True, r["checks"]
    assert r["control_correct"] is False, r["checks"]


def _broken(monkeypatch, how):
    from vulcan_tpu_torch.pipeline.api import Pipeline

    real = Pipeline.process

    def unchanged(self, depth, color=None, pose=None):
        return None

    def half_frame(self, depth, color=None, pose=None):
        depth = depth.copy()
        depth[depth.shape[0] // 2:] = 0
        return real(self, depth, color, pose)

    def altered(self, depth, color=None, pose=None):
        real(self, depth, color, pose)
        self.state.model.depth.mul_(1.001)

    monkeypatch.setattr(Pipeline, "process", {"unchanged": unchanged, "half_frame": half_frame,
                                              "altered": altered}[how])


# The number each fault has to push over its limit.
CAUGHT_BY = {"unchanged": ("ate_m", "volume_mismatch"), "half_frame": ("volume_mismatch",),
             "altered": ("render_mismatch",)}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("how", sorted(CAUGHT_BY))
def test_broken_timed_path_is_not_correct(monkeypatch, workload, how):
    _broken(monkeypatch, how)
    r = small_run(workload)
    assert r["correct"] is False, r["checks"]
    caught = [name for name in CAUGHT_BY[how] if name in r["checks"]]   # no ate_m untracked
    assert caught, r["checks"]
    for name in caught:
        assert r["checks"][name]["value"] > r["checks"][name]["limit"], (name, r["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                        "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_frame_fault_on_the_card(card, monkeypatch, workload):
    """Half of each depth frame left out, at the cell's own size."""
    _broken(monkeypatch, "half_frame")
    r = run.execute(spec.cell(workload), 2**31 + 5, 3.0, False)
    print(workload, json.dumps(r["checks"]), file=sys.stderr)
    assert r["correct"] is False, r["checks"]
    c = r["checks"]["volume_mismatch"]
    assert c["value"] > c["limit"], r["checks"]
