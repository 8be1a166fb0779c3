"""Kernel S1, the surfel splat's z-buffer (``csrc/splat_zbuf.cu``), on the
card at the main path's shapes: 640x480 under ``Config()`` on the desk
fused at its true poses.  One launch (two for rgb) must give the plain
version's buffers (``splat._splat_zbuf_surfels_plain``, the two tiers of
chunk loops of PyTorch ops, on the same card) bit for bit in all three
modes (float depth, packed luma word, rgb888), eagerly and in a replayed
graph; the captured step splats with one launch a frame (two in rgb) and
no WHILE node, and equals the eager step bit for bit.  The tests marked
``cuda`` skip without a card.  This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_splat.py
"""
import dataclasses

import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu_torch.io.synthetic import orbit_poses, render_desk_depth
from vulcan_tpu_torch.ops import allocate, cuda_kernels, splat
from vulcan_tpu_torch.ops import blocks as B
from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

torch.set_num_threads(1)

H, W = 480, 640
CAM = P.PinholeCamera.tum_default()
FRAMES = 8              # frames fused before the pose the cases render at
MODES = ("depth", "luma", "rgb")
LAUNCHES = {"depth": 1, "luma": 1, "rgb": 2}
EMPTY = {"depth": float("inf"), "luma": splat._LUMA_EMPTY, "rgb": -1}


def _desk(n, dev):
    """The desk orbit (``splat-combined``'s scene): ``n`` poses and frames."""
    poses = orbit_poses(n, center=(0.0, 0.0, -0.25), radius=1.5, height=0.55,
                        span=0.05 * n)
    return poses, [render_desk_depth(CAM, p, H, W, device=dev) for p in poses]


def _copy(vol):
    return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).clone()
                                       for f in dataclasses.fields(vol)})


@pytest.fixture(scope="module")
def desk():
    """(config, the volume after FRAMES desk frames fused at their true
    poses with its visible list at the next pose, that pose)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    cfg = P.Config()
    poses, frames = _desk(FRAMES + 1, dev)
    pipe = P.Pipeline(cfg, CAM, H, W, init_pose=poses[0], device=dev)
    for pose, (d, c) in zip(poses[:FRAMES], frames[:FRAMES]):
        pipe.process(d, c, pose=pose)
    pose = poses[FRAMES].to(dev)
    vol = allocate.update_visibility(_copy(pipe.state.volume), CAM, pose, H, W, cfg)
    torch.cuda.synchronize()
    return cfg, _copy(vol), pose


def _case(desk, case):
    cfg, vol, _ = desk
    vol = _copy(vol)
    n = int(vol.num_visible)
    if case == "zeros":            # empty rows (id 0) inside the listed ones
        vol.visible_ids[n // 3:n // 3 + 7] = 0
        vol.visible_ids[n // 2] = 0
    elif case == "empty":
        vol.num_visible.zero_()
    elif case == "full":           # every row listed at max_visible (blocks repeat)
        real = torch.arange(1, int(vol.free_count), dtype=torch.int32, device=vol.tsdf.device)
        cap = vol.visible_ids.shape[0]
        vol.visible_ids.copy_(real.repeat(-(-cap // real.shape[0]))[:cap])
        vol.num_visible.fill_(cap)
    return cfg, vol


def _splat(vol, pose, cfg, mode, plain=False):
    fn = splat._splat_zbuf_surfels_plain if plain else splat._splat_zbuf_surfels
    out = fn(vol, CAM, pose, H, W, cfg, with_color=mode == "rgb", luma=mode == "luma")
    return out if mode == "rgb" else (out,)


def _assert_same(got, want, what):
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, int((a != b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["visible", "zeros", "empty", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_splat_zbuf_kernel_is_bit_identical_to_plain(desk, mode, case):
    cfg, vol = _case(desk, case)
    pose = desk[2]
    before = cuda_kernels.launch_counts()["splat_zbuf"]
    got = _splat(vol, pose, cfg, mode)
    after = cuda_kernels.launch_counts()["splat_zbuf"]
    want = _splat(vol, pose, cfg, mode, plain=True)
    _assert_same(got, want, (mode, case))
    assert after - before == LAUNCHES[mode]
    hit = float((got[-1] != EMPTY[mode]).float().mean())
    assert hit == 0.0 if case == "empty" else hit > 0.2


@pytest.mark.cuda
def test_splat_zbuf_refuses_more_than_512_surfel_slots(desk):
    """A surfel row wider than the kernel takes raises; nothing falls back
    to the plain version."""
    cfg, vol, pose = desk
    wide = dataclasses.replace(vol, surfpack=torch.full(
        (vol.surfpack.shape[0], 513), B.EMPTY_SURFEL, dtype=torch.int32,
        device=vol.tsdf.device))
    before = cuda_kernels.launch_counts()["splat_zbuf"]
    with pytest.raises(ValueError, match="surfel slots"):
        splat._splat_zbuf_surfels(wide, CAM, pose, H, W, cfg, luma=True)
    assert cuda_kernels.launch_counts()["splat_zbuf"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_captured_splat_replays_match_plain(desk, mode):
    """A graph captured around ``_splat_zbuf_surfels`` reads the visible
    count and the pose on the card: replayed at other counts (0 and
    max_visible among them) and at a moved pose it gives the plain
    version's buffers bit for bit, with one launch a replay (two in rgb)
    and no WHILE node."""
    cfg, vol0, pose0 = desk
    vol = _copy(vol0)
    pose = dataclasses.replace(pose0, rotation=pose0.rotation.clone(),
                               translation=pose0.translation.clone())
    _splat(vol, pose, cfg, mode)        # the launch counters, before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _splat(vol, pose, cfg, mode)
    n = int(vol0.num_visible)
    moved = pose0.translation + pose0.rotation[:, 2] * 0.02
    for k, t in ((n, None), (0, None), (1, None), (n // 2, None),
                 (cfg.max_visible, None), (n, moved)):
        vol.num_visible.fill_(k)
        pose.translation.copy_(pose0.translation if t is None else t)
        before = cuda_kernels.launch_counts()
        graph.replay()
        after = cuda_kernels.launch_counts()
        want = _splat(vol, pose, cfg, mode, plain=True)
        _assert_same(out, want, (mode, k, t is not None))
        assert after["splat_zbuf"] - before["splat_zbuf"] == LAUNCHES[mode], k
        assert after["graph_while"] == before["graph_while"], k


@pytest.mark.cuda
@pytest.mark.parametrize("mode,color", [("combined", "luma"), ("depth", "luma"),
                                        ("combined", "rgb")])
def test_replayed_step_splats_without_a_while_node(mode, color):
    """Every replayed frame of the captured step, tracked and at a given
    pose, launches S1 once (twice with rgb model colour) and evaluates no
    WHILE node: the surfel splat was the desk's last loop (the two
    captures' own frames aside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    cfg = P.Config(model_color=color)
    poses, frames = _desk(2 * WARMUP_FRAMES + 6, dev)
    pipe = P.Pipeline(cfg, CAM, H, W, init_pose=poses[0], mode=mode, device=dev)
    for k, (d, c) in enumerate(frames):
        known = k >= len(frames) // 2
        before = cuda_kernels.launch_counts()
        pipe.process(d, c, pose=poses[k] if known else None)
        after = cuda_kernels.launch_counts()
        if k in (WARMUP_FRAMES, len(frames) // 2 + WARMUP_FRAMES):
            continue
        got = {n: after[n] - before[n] for n in ("splat_zbuf", "graph_while")}
        splats = 2 if color == "rgb" and (known or mode != "depth") else 1
        if k < WARMUP_FRAMES or len(frames) // 2 <= k < len(frames) // 2 + WARMUP_FRAMES:
            assert got["splat_zbuf"] >= splats and got["graph_while"] == 0, (k, got)
        else:
            assert got == {"splat_zbuf": splats, "graph_while": 0}, (k, got)
    assert pipe.captured


@pytest.mark.cuda
def test_captured_step_equals_eager_step():
    """The desk fused and rendered at its true poses: the captured step's
    volume and model maps equal the eager step's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    cfg = P.Config()
    poses, frames = _desk(WARMUP_FRAMES + 6, dev)
    runs = []
    for eager in (True, False):
        pipe = P.Pipeline(cfg, CAM, H, W, init_pose=poses[0], mode="combined", device=dev)
        if eager:
            pipe.captured, pipe._graphs = False, None
        for pose, (d, c) in zip(poses, frames):
            pipe.process(d, c, pose=pose)
        assert pipe.captured != eager
        s = pipe.state
        runs.append({**{f.name: getattr(s.volume, f.name).clone()
                        for f in dataclasses.fields(s.volume)},
                     **{f"model.{k}": getattr(s.model, k).clone()
                        for k in ("depth", "valid", "nx", "ny", "nz", "color")}})
    for name, a in runs[0].items():
        b = runs[1][name]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (name, int((a != b).sum()))
