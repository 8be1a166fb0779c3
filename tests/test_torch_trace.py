"""The step's spans on the CPU (``utils/timing.py``): a traced ``Pipeline``
over tracked and known-pose frames, the spans' nesting and frame numbers,
the untraced step's lack of marks, the clock calibration and the ring's
cover.  On the CPU a mark writes the host clock; the card's marks
(``csrc/trace.cu``) are held in ``tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu_torch.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu_torch.utils import timing

CFG = dataclasses.replace(P.TINY, voxel_size=0.015, trunc_dist=0.06, num_blocks=8192,
                          hash_size=32768, max_visible=8192, depth_max=4.0)
CAM = P.PinholeCamera.create(80.0, 80.0, 49.5, 37.5)
H, W = 75, 100
SPHERES = (((0.0, 0.0, 0.0), 0.5), ((0.6, 0.3, 0.2), 0.25))
TRACKED, KNOWN = 3, 2
STAGES = ("preprocess", "track", "allocate", "integrate", "render")


@pytest.fixture(scope="module")
def traced():
    """A traced pipeline after TRACKED tracked frames, then KNOWN frames at
    a given pose, and its spans of every frame."""
    poses = orbit_poses(TRACKED + KNOWN, radius=1.6, height=0.35, span=0.25)
    pipe = P.Pipeline(CFG, CAM, H, W, init_pose=poses[0], device="cpu", trace=True)
    for k, pose in enumerate(poses):
        d, c = render_scene_depth(CAM, pose, H, W, SPHERES, -0.6, device="cpu")
        pipe.process(d.numpy(), c.numpy(), pose=pose if k >= TRACKED else None)
    return pipe, pipe.trace_spans(0, TRACKED + KNOWN)


def _by_frame(got):
    frames = {}
    for f, name, parent, start, end in got["spans"]:
        frames.setdefault(f, {})[name] = (parent, start, end)
    return frames


def test_every_frame_has_its_stages_inside_step(traced):
    _, got = traced
    frames = _by_frame(got)
    for f, spans in frames.items():
        want = STAGES if f < TRACKED else tuple(s for s in STAGES if s != "track")
        assert [n for n in spans if n in timing.SPANS] == ["step", *want], f
        assert spans["step"][0] is None
        _, s0, e0 = spans["step"]
        prev_end = s0
        for name in want:
            parent, s, e = spans[name]
            assert parent == "step"
            assert prev_end <= s <= e <= e0, (f, name)
            prev_end = e


def test_process_holds_upload_and_launch(traced):
    _, got = traced
    for f, spans in _by_frame(got).items():
        parent, p0, p1 = spans["process"]
        assert parent is None
        assert spans["upload"][0] == spans["launch"][0] == "process"
        _, u0, u1 = spans["upload"]
        _, l0, l1 = spans["launch"]
        assert p0 <= u0 <= u1 <= l0 <= l1 <= p1, f
        # The step runs inside the launch, on the CPU with no other clock
        # than the host's but the calibration's error.
        _, s0, s1 = spans["step"]
        assert l0 - got["error_ns"] <= s0 <= s1 <= l1 + got["error_ns"], f


def test_frame_numbers_are_consecutive(traced):
    pipe, got = traced
    assert sorted(_by_frame(got)) == list(range(TRACKED + KNOWN))
    assert int(pipe._tracer.frame) == pipe._tracer.begun == TRACKED + KNOWN
    assert got["error_ns"] >= 0 and got["interval_s"] > 0
    later = pipe.trace_spans(1, 3)
    assert sorted(_by_frame(later)) == [1, 2]


def test_untraced_step_places_no_mark(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a mark outside a traced pipeline")

    monkeypatch.setattr(timing.SpanTracer, "mark", refuse)
    monkeypatch.setattr(timing, "mark_plain", refuse)
    pose = orbit_poses(1, radius=1.6, height=0.35, span=0.05)[0]
    pipe = P.Pipeline(CFG, CAM, H, W, init_pose=pose, device="cpu")
    d, c = render_scene_depth(CAM, pose, H, W, SPHERES, -0.6, device="cpu")
    pipe.process(d.numpy(), c.numpy())
    pipe.process(d.numpy(), c.numpy(), pose=pose)
    assert timing._tracer is None
    with pytest.raises(RuntimeError, match="trace=False"):
        pipe.trace_spans(0, 1)


def test_calibration_keeps_the_narrowest_window():
    offset = 1_000_000_007
    # (host before, device, host after): the device read sits anywhere in
    # its window; the third is the narrowest.
    triples = [(100, 50 - offset + 40, 160), (300, 300 - offset, 340),
               (500, 510 - offset, 520), (700, 700 - offset + 80, 900)]
    clock = timing.fit_clock(triples)
    assert clock == timing.Clock(510 - offset, offset, 10)
    assert timing.to_host(2_000 - offset, clock, clock) == 2_000


def test_mapping_follows_the_drift():
    start = timing.Clock(device_ns=10**18, offset_ns=500, error_ns=3)
    end = timing.Clock(device_ns=10**18 + 10**10, offset_ns=1_500, error_ns=4)
    d = np.array([10**18, 10**18 + 5 * 10**9, 10**18 + 10**10])
    assert timing.to_host(d, start, end).tolist() == [10**18 + 500, 10**18 + 5 * 10**9 + 1_000,
                                                      10**18 + 10**10 + 1_500]


def _frame(tracer):
    with timing.tracing(tracer), timing.stage("step"), timing.stage("preprocess"):
        pass
    t = timing.host_ns()
    tracer.record_host((t, t + 3), (t, t + 1), (t + 1, t + 2))


def test_a_window_longer_than_the_ring_is_not_covered():
    tracer = timing.SpanTracer(torch.device("cpu"), frames=3)
    for _ in range(5):
        _frame(tracer)
    assert tracer.spans(0, 5) is None       # longer than the ring
    assert tracer.spans(1, 3) is None       # frame 1 overwritten by frame 4
    assert tracer.spans(4, 6) is None       # frame 5 not run yet
    got = tracer.spans(2, 5)
    assert sorted(_by_frame(got)) == [2, 3, 4]
    assert {n for _, n, *_ in got["spans"]} == {"step", "preprocess", *timing.HOST_SPANS}
