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
