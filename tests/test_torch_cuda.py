"""The port's ``Pipeline`` on the card: what only a captured CUDA graph can
show.  The tests marked ``cuda`` skip without a card.  This file imports
neither JAX nor the JAX package, so that it runs on a machine without
them, and without ``tests/conftest.py`` (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu_torch.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

torch.set_num_threads(1)

CFG = dataclasses.replace(P.TINY, voxel_size=0.015, trunc_dist=0.06, num_blocks=8192,
                          hash_size=32768, max_visible=8192, depth_max=4.0)
CAM = P.PinholeCamera.create(160.0, 160.0, 99.5, 74.5)
H, W = 150, 200
SPHERES = (((0.0, 0.0, 0.0), 0.5), ((0.6, 0.3, 0.2), 0.25))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


def _frames(n, device):
    poses = orbit_poses(n, radius=1.6, height=0.35, span=0.05 * n)
    frames = []
    for pose in poses:
        d, c = render_scene_depth(CAM, pose, H, W, SPHERES, -0.6, device=device)
        frames.append((d.cpu().numpy(), c.cpu().numpy()))
    return poses, frames


def _pose_kept_across_a_frame(device):
    """(pose kept after frame k, the same pose read again after frame k +
    1, the pose of frame k + 1) where frame k is the first one past the
    warm-up (on the card: the first replay of the captured step)."""
    poses, frames = _frames(WARMUP_FRAMES + 2, device)
    pipe = P.Pipeline(CFG, CAM, H, W, init_pose=poses[0], device=device)
    for d, c in frames[:-1]:
        pipe.process(d, c)
    kept = pipe.pose
    snapshot = (kept.rotation.cpu().numpy().copy(), kept.translation.cpu().numpy().copy())
    pipe.process(*frames[-1])
    after = (kept.rotation.cpu().numpy(), kept.translation.cpu().numpy())
    return pipe, snapshot, after, pipe.pose


def test_kept_pose_is_a_copy_on_the_cpu():
    """``Pipeline.pose`` is a copy of the state's pose, which a later frame
    leaves as it was."""
    pipe, snapshot, after, new = _pose_kept_across_a_frame(torch.device("cpu"))
    assert not pipe.captured
    for a, b in zip(snapshot, after):
        np.testing.assert_array_equal(a, b)
    assert pipe.pose.translation.data_ptr() != pipe.state.pose.translation.data_ptr()
    assert not np.array_equal(snapshot[1], new.translation.numpy())


@pytest.mark.cuda
def test_kept_pose_survives_a_replay(card):
    """On the card the step is a captured graph that writes the new state
    into the buffers it read: a pose kept from frame k must still hold
    frame k's values after frame k + 1 has been replayed."""
    pipe, snapshot, after, new = _pose_kept_across_a_frame(card)
    assert pipe.captured and pipe.graph_stats
    for a, b in zip(snapshot, after):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(snapshot[1], new.translation.cpu().numpy())


REPLAYS = 3     # replayed frames of each kind, after the warm-up and the capture


@pytest.fixture(scope="module")
def marked():
    """The same frames through an untraced and a traced pipeline on the
    card: each kind's warm-up, capture and REPLAYS replays (tracked, then
    at a given pose).  Per pipeline: the card's launch counts of each
    replayed frame by kind, the final pose and volume, and the pipeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from vulcan_tpu_torch.ops import cuda_kernels

    n = WARMUP_FRAMES + 1 + REPLAYS
    poses, frames = _frames(2 * n, torch.device("cuda:0"))
    out = {}
    for trace in (False, True):
        pipe = P.Pipeline(CFG, CAM, H, W, init_pose=poses[0], device="cuda:0", trace=trace)
        counts = {"tracked": [], "known": []}
        for k, (d, c) in enumerate(frames):
            kind, i = ("tracked", k) if k < n else ("known", k - n)
            before = cuda_kernels.launch_counts()
            pipe.process(d, c, pose=poses[k] if kind == "known" else None)
            after = cuda_kernels.launch_counts()
            if i > WARMUP_FRAMES:
                counts[kind].append({key: after[key] - before[key] for key in after})
        volume = {f.name: getattr(pipe.state.volume, f.name).clone()
                  for f in dataclasses.fields(pipe.state.volume)}
        out[trace] = (counts, pipe.pose, volume, pipe)
    return out


@pytest.mark.cuda
def test_marks_twice_a_span_and_nothing_else(marked):
    """A replayed frame launches ``trace_mark`` twice a span (six spans
    tracked, five at a given pose) with tracing on and never with it off,
    and every other counted kernel as often either way."""
    want = {"tracked": 12, "known": 10}
    for kind in want:
        off, on = marked[False][0][kind], marked[True][0][kind]
        assert len(off) == len(on) == REPLAYS
        for a, b in zip(off, on):
            assert a["trace_mark"] == 0 and b["trace_mark"] == want[kind], (kind, a, b)
            assert {k: v for k, v in a.items() if k != "trace_mark"} == \
                {k: v for k, v in b.items() if k != "trace_mark"}, kind


@pytest.mark.cuda
def test_traced_replay_is_bit_identical(marked):
    _, pose_off, vol_off, _ = marked[False]
    _, pose_on, vol_on, _ = marked[True]
    assert torch.equal(pose_off.rotation, pose_on.rotation)
    assert torch.equal(pose_off.translation, pose_on.translation)
    for name, t in vol_off.items():
        assert torch.equal(t, vol_on[name]), name


@pytest.mark.cuda
def test_spans_of_replayed_frames_nest(marked):
    """Every frame's stages lie inside its ``step``, in order, on the host
    clock, and each frame's ``step`` inside its ``launch`` widened by the
    calibration's error (the replay runs after the launch call returns, so
    only its start is bound by it)."""
    pipe = marked[True][3]
    n = WARMUP_FRAMES + 1 + REPLAYS
    got = pipe.trace_spans(0, 2 * n)
    assert got is not None and 0 <= got["error_ns"] < 100_000
    frames = {}
    for f, name, parent, s, e in got["spans"]:
        frames.setdefault(f, {})[name] = (parent, s, e)
    assert sorted(frames) == list(range(2 * n))
    for f, spans in frames.items():
        stages = ["preprocess", "track", "allocate", "integrate", "render"]
        if f >= n:
            stages.remove("track")
        assert [k for k in spans if k not in ("process", "upload", "launch")] == ["step", *stages]
        _, s0, e0 = spans["step"]
        prev = s0
        for name in stages:
            _, s, e = spans[name]
            assert prev <= s <= e <= e0, (f, name)
            prev = e
        assert spans["launch"][1] - got["error_ns"] <= s0, f
