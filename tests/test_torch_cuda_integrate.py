"""Kernel I1, the integrate layer (``csrc/integrate.cu``), on the card at the
main path's shapes: 640x480 under both benchmark configurations
(``Config()`` on the desk, ``Config(render_mode="march")`` on the orbit).
One launch must give the plain version's volume (``sparse._integrate_plain``,
the chunk loop of PyTorch ops, on the same card) bit for bit on all seven
outputs (tsdf, weight, colorpack, surfpack, surf_count, mesh_dirty,
surf_overflow), eagerly and in a replayed graph.  The tests marked ``cuda``
skip without a card.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_integrate.py
"""
import dataclasses

import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.io.synthetic import orbit_poses, render_desk_depth, render_scene_depth
from vulcan_tpu_torch.ops import allocate, cuda_kernels, sparse
from vulcan_tpu_torch.ops import blocks as B
from vulcan_tpu_torch.pipeline.graphs import WARMUP_FRAMES

torch.set_num_threads(1)

H, W = 480, 640
CAM = P.PinholeCamera.tum_default()
# bench.py's orbit scene: four spheres over a floor.
SPHERES = (((0.0, 0.0, 0.0), 0.5), ((0.6, 0.3, 0.2), 0.25), ((-0.5, 0.4, -0.1), 0.3),
           ((0.2, -0.5, 0.3), 0.2))
FLOOR = -0.6
FRAMES = 8              # frames fused before the one the cases integrate
CONFIGS = {"splat-combined": P.Config(), "march-depth": P.Config(render_mode="march")}
OUTPUTS = ("tsdf", "weight", "colorpack", "surfpack", "surf_count", "mesh_dirty",
           "surf_overflow")


def _poses_and_frames(name, n, dev):
    """The benchmark configuration's scene: the desk (``splat-combined``)
    or the four spheres (``march-depth``), ``n`` orbit frames in metres."""
    if name == "splat-combined":
        poses = orbit_poses(n, center=(0.0, 0.0, -0.25), radius=1.5, height=0.55,
                            span=0.05 * n)
        return poses, [render_desk_depth(CAM, p, H, W, device=dev) for p in poses]
    poses = orbit_poses(n, radius=1.6, height=0.35, span=0.05 * n)
    return poses, [render_scene_depth(CAM, p, H, W, SPHERES, FLOOR, device=dev)
                   for p in poses]


def _copy(vol):
    return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).clone()
                                       for f in dataclasses.fields(vol)})


@pytest.fixture(scope="module", params=list(CONFIGS))
def fused(request):
    """(config name, config, the volume after FRAMES frames fused at their
    true poses, the next frame, its band list and count from allocation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    name, cfg = request.param, CONFIGS[request.param]
    poses, frames = _poses_and_frames(name, FRAMES + 1, dev)
    pipe = P.Pipeline(cfg, CAM, H, W, init_pose=poses[0], device=dev)
    for pose, (d, c) in zip(poses[:FRAMES], frames[:FRAMES]):
        pipe.process(d, c, pose=pose)
    d, c = frames[FRAMES]
    frame = Frame(d, c, CAM, poses[FRAMES].to(dev))
    vol, band, n_band = allocate.allocate_for_frame(
        _copy(pipe.state.volume), d, CAM, frame.pose, cfg)
    vol = allocate.update_visibility(vol, CAM, frame.pose, H, W, cfg)
    torch.cuda.synchronize()
    return name, cfg, _copy(vol), frame, band, n_band


def _case(fused, case):
    """(config, volume, ids, count) of a case; ids None: the visible list."""
    _, cfg, vol, _, band, n_band = fused
    vol, ids, count = _copy(vol), band.clone(), n_band.clone()
    n = int(n_band)
    if case == "zeros":            # empty rows (id 0) inside the listed ones
        ids[n // 3:n // 3 + 7] = 0
        ids[n // 2] = 0
    elif case == "empty":
        count.zero_()
    elif case == "full":           # every row listed, unique real blocks
        blocks = int(vol.free_count) - 1
        real = 1 + torch.randperm(blocks, device=ids.device)[:ids.shape[0]]
        ids.zero_()
        ids[:real.shape[0]] = real.to(ids.dtype)
        count.fill_(ids.shape[0])
    elif case == "overflow":       # 48 slots: most band blocks shed outer voxels
        cfg = dataclasses.replace(cfg, surfel_slots=48)
        vol = dataclasses.replace(vol, surfpack=torch.full(
            (vol.surfpack.shape[0], 48), B.EMPTY_SURFEL, dtype=torch.int32,
            device=ids.device))
    elif case == "eps0":
        cfg = dataclasses.replace(cfg, mesh_dirty_eps=0.0)
    elif case == "mu":             # 1 / 0.06: float64's reciprocal, not float32's
        cfg = dataclasses.replace(cfg, trunc_dist=0.06)
    elif case == "visible":
        ids = count = None
    if case in ("band", "eps0", "zeros"):
        vol.mesh_dirty.zero_()
    return cfg, vol, ids, count


def _run(cfg, vol, frame, ids, count, kernel):
    if kernel:
        return sparse.integrate_sparse(_copy(vol), frame, cfg, ids=ids, count=count)
    if ids is None:
        ids, count = vol.visible_ids, vol.num_visible
    return sparse._integrate_plain(_copy(vol), frame, cfg, ids, count)


def _assert_same(got, want, what):
    for name in OUTPUTS:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, name, int((a != b).sum()))


CASES = ["band", "zeros", "empty", "full", "overflow", "eps0", "mu", "visible"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_integrate_kernel_is_bit_identical_to_plain(fused, case):
    name, frame = fused[0], fused[3]
    cfg, vol, ids, count = _case(fused, case)
    got = _run(cfg, vol, frame, ids, count, kernel=True)
    want = _run(cfg, vol, frame, ids, count, kernel=False)
    _assert_same(got, want, (name, case))
    changed = int((got.weight != vol.weight).any(dim=1).sum())
    if case == "empty":
        assert changed == 0 and int(got.surf_overflow) == 0
    else:
        assert changed > 0
    if case == "overflow":
        assert int(got.surf_overflow) > 0 and int((got.surf_count == 48).sum()) > 0
    if case == "eps0":
        listed = ids[:int(count)]
        assert int(got.mesh_dirty.sum()) == int((listed > 0).sum())
    if case == "band":
        assert 0 < int(got.mesh_dirty.sum()) <= int((ids > 0).sum())
    if case == "visible":
        assert vol.visible_ids.shape[0] == cfg.max_visible and int(vol.num_visible) > 0


@pytest.mark.cuda
def test_integrate_refuses_more_than_512_surfel_slots(fused):
    """A surfel row wider than a CTA's 512 threads raises; nothing falls
    back to the plain version."""
    _, cfg, vol, frame, band, n_band = fused
    wide = dataclasses.replace(vol, surfpack=torch.full(
        (vol.surfpack.shape[0], 513), B.EMPTY_SURFEL, dtype=torch.int32, device=band.device))
    before = cuda_kernels.launch_counts()["integrate"]
    with pytest.raises(ValueError, match="surfel slots"):
        sparse.integrate_sparse(wide, frame, cfg, ids=band, count=n_band)
    assert cuda_kernels.launch_counts()["integrate"] == before


@pytest.mark.cuda
def test_captured_integrate_replays_match_eager(fused):
    """A graph captured around ``integrate_sparse`` reads the list's count
    and the pose on the card: replayed at other counts and at the next
    pose it gives the plain version's volume bit for bit, with one launch a
    replay."""
    name, cfg, vol0, frame, band, n_band = fused
    vol = _copy(vol0)
    count = n_band.clone()
    pose = dataclasses.replace(frame.pose, rotation=frame.pose.rotation.clone(),
                               translation=frame.pose.translation.clone())
    live = Frame(frame.depth, frame.color, CAM, pose)
    sparse.integrate_sparse(_copy(vol0), live, cfg, ids=band, count=count)   # counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sparse.integrate_sparse(vol, live, cfg, ids=band, count=count)
    n = int(n_band)
    moved = frame.pose.translation + frame.pose.rotation[:, 2] * 0.01
    for k, t in ((n, None), (0, None), (1, None), (n // 2, None), (cfg.alloc_capacity, None),
                 (n, moved)):
        for f in dataclasses.fields(vol):
            getattr(vol, f.name).copy_(getattr(vol0, f.name))
        count.fill_(k)
        pose.translation.copy_(frame.pose.translation if t is None else t)
        before = cuda_kernels.launch_counts()
        graph.replay()
        after = cuda_kernels.launch_counts()
        want = _run(cfg, vol0, live, band, count, kernel=False)
        got = dataclasses.replace(vol, surf_overflow=out.surf_overflow)
        _assert_same(got, want, (name, k, t is not None))
        assert after["integrate"] - before["integrate"] == 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_replayed_step_launches_the_integrate_kernel_once(name):
    """Every frame of the captured step launches I1 once, tracked and at a
    given pose (the two captures' own frames aside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda:0")
    cfg = CONFIGS[name]
    poses, frames = _poses_and_frames(name, 2 * WARMUP_FRAMES + 6, dev)
    pipe = P.Pipeline(cfg, CAM, H, W, init_pose=poses[0], device=dev)
    for k, (d, c) in enumerate(frames):
        known = k >= len(frames) // 2
        before = cuda_kernels.launch_counts()
        pipe.process(d, c, pose=poses[k] if known else None)
        after = cuda_kernels.launch_counts()
        if k not in (WARMUP_FRAMES, len(frames) // 2 + WARMUP_FRAMES):
            got = after["integrate"] - before["integrate"]
            assert got == 1, (k, got)
    assert pipe.captured
