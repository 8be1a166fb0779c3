"""Kernel R1, the march's range image (``csrc/range_image.cu``), on the card
at the main path's shapes: 640x480 under ``Config(render_mode="march")``.
The stamps and the upsample must give the plain version's maps
(``raycast._range_image_plain``, the same stamps through scatter_reduce_)
bit for bit, eagerly and in a replayed graph.  The tests marked ``cuda``
skip without a card.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_range.py
"""
import dataclasses

import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu_torch.core.se3 import SE3
from vulcan_tpu_torch.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu_torch.ops import allocate, cuda_kernels, raycast
from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

torch.set_num_threads(1)

H, W = 480, 640
CFG = P.Config(render_mode="march")
CAM = P.PinholeCamera.tum_default()
# bench.py's orbit scene: four spheres over a floor.
SPHERES = (((0.0, 0.0, 0.0), 0.5), ((0.6, 0.3, 0.2), 0.25), ((-0.5, 0.4, -0.1), 0.3),
           ((0.2, -0.5, 0.3), 0.2))
FLOOR = -0.6
FRAMES = 8
# The "overflow" case moves the camera this far along its optical axis: 0.2
# m in front of the big sphere, so that listed blocks lie behind it and
# others cover more than the stamp.
OVERFLOW_STEP = 0.9


def _frames(n, device):
    poses = orbit_poses(n, radius=1.6, height=0.35, span=0.05 * n)
    return poses, [tuple(x.cpu().numpy() for x in render_scene_depth(
        CAM, pose, H, W, SPHERES, FLOOR, device=device)) for pose in poses]


@pytest.fixture(scope="module")
def fused():
    """The orbit's frames fused at their true poses on the card, the
    volume's visible list at the last pose (a copy of every array), and
    that pose."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    poses, frames = _frames(FRAMES, dev)
    pipe = P.Pipeline(CFG, CAM, H, W, init_pose=poses[0], device=dev)
    for pose, (d, c) in zip(poses, frames):
        pipe.process(d, c, pose=pose)
    pose = poses[-1].to(dev)
    vol = allocate.update_visibility(pipe.state.volume, CAM, pose, H, W, CFG)
    vol = dataclasses.replace(vol, **{f.name: getattr(vol, f.name).clone()
                                      for f in dataclasses.fields(vol)})
    return vol, pose


def _case(fused, case):
    """(volume, pose) of a case: the fused volume at its pose; the same list
    from a camera moved OVERFLOW_STEP forward; an empty list; a full one
    (every row lists an allocated block)."""
    vol, pose = fused
    if case == "overflow":
        pose = SE3(pose.rotation, pose.translation + pose.rotation[:, 2] * OVERFLOW_STEP)
    elif case == "empty":
        vol = dataclasses.replace(vol, num_visible=torch.zeros_like(vol.num_visible))
    elif case == "full":
        v = vol.visible_ids.shape[0]
        blocks = int(vol.free_count) - 1
        ids = 1 + torch.arange(v, device=vol.visible_ids.device) % blocks
        vol = dataclasses.replace(vol, visible_ids=ids.to(torch.int32),
                                  num_visible=torch.full_like(vol.num_visible, v))
    return vol, pose


def _bits(maps):
    return [m.contiguous().view(torch.int32) for m in maps]


def _kernel_and_plain(vol, pose, cfg):
    got = raycast.compute_range_image(vol, CAM, pose, H, W, cfg)
    rows = raycast._range_rows(vol, CAM, pose, cfg)
    want = raycast._range_image_plain(rows, H, W, cfg)
    return got, want, rows


def _check_case(vol, pose, cfg, case):
    got, want, rows = _kernel_and_plain(vol, pose, cfg)
    for name, a, b in zip(("t_min", "t_first_max", "t_max"), _bits(got), _bits(want)):
        assert torch.equal(a, b), (case, name, int((a != b).sum()))
    listed = int(vol.num_visible)
    if case == "empty":
        assert not rows.stampable.any() and torch.isneginf(got[2]).all()
    else:
        assert rows.stampable.any() and bool((got[0] <= got[2]).any())
    if case == "overflow":
        behind, oversize = rows.behind[:listed], rows.oversize[:listed]
        assert behind.any() and (oversize & ~behind).any() and rows.any_overflow
    if case == "full":
        assert listed == cfg.max_visible


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused", "overflow", "empty", "full"])
def test_range_image_kernel_is_bit_identical_to_plain(fused, case):
    """The images stay in shared memory at 640x480 / 16 (3 x 1200 cells)."""
    assert cuda_kernels.range_image_path(30 * 40) == "smem"
    _check_case(*_case(fused, case), CFG, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused", "overflow"])
def test_global_path_is_bit_identical_to_plain(fused, case):
    """At range_scale 2 the three coarse images (3 x 240 x 320 cells, 900
    KB) exceed a CTA's shared memory: the stamps go to global memory."""
    cfg = dataclasses.replace(CFG, range_scale=2)
    assert cuda_kernels.range_image_path(240 * 320) == "global"
    _check_case(*_case(fused, case), cfg, case)


@pytest.mark.cuda
def test_captured_range_image_replays_match_eager(fused):
    """A graph captured around ``compute_range_image`` reads the visible
    count on the card: replayed at other counts it gives the eager call's
    maps bit for bit, and each replay launches each kernel once."""
    vol, pose = _case(fused, "full")
    raycast.compute_range_image(vol, CAM, pose, H, W, CFG)     # counters, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = raycast.compute_range_image(vol, CAM, pose, H, W, CFG)
    listed = int(fused[0].num_visible)
    for k in (listed, 0, 1, listed // 2, CFG.max_visible, listed):
        vol.num_visible.fill_(k)
        before = cuda_kernels.launch_counts()
        graph.replay()
        after = cuda_kernels.launch_counts()
        want = raycast.compute_range_image(vol, CAM, pose, H, W, CFG)
        for a, b in zip(_bits(out), _bits(want)):
            assert torch.equal(a, b), k
        assert {key: after[key] - before[key] for key in ("range_stamp", "range_expand")} \
            == {"range_stamp": 1, "range_expand": 1}, k


@pytest.mark.cuda
@pytest.mark.parametrize("render_mode,want", [("march", 1), ("splat", 0)])
def test_replayed_step_launches_the_range_image_once(render_mode, want):
    """A replayed frame of the captured step launches each of R1's kernels
    once under the march and never under the splat."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    poses, frames = _frames(WARMUP_FRAMES + 3, dev)
    cfg = P.Config(render_mode=render_mode)
    pipe = P.Pipeline(cfg, CAM, H, W, init_pose=poses[0], device=dev)
    for k, (d, c) in enumerate(frames):
        before = cuda_kernels.launch_counts()
        pipe.process(d, c)
        after = cuda_kernels.launch_counts()
        if k > WARMUP_FRAMES:
            got = {key: after[key] - before[key] for key in ("range_stamp", "range_expand")}
            assert got == {"range_stamp": want, "range_expand": want}, (k, got)
    assert pipe.captured
