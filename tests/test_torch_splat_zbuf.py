"""Kernel S1's contract on the CPU: the surfel z-buffer's plain version
(``splat._splat_zbuf_surfels_plain``, the reference's two tiers of chunk
loops) equals ONE pass over the tiers' slots of every listed block, the
pass that S1 (``csrc/splat_zbuf.cu``) makes with integer atomics, in all
three modes (float depth, packed luma word, rgb888 after the depth
buffer).  A CPU volume takes the plain version; the entry point refuses
what the kernel does not take before anything is built.  The card tests
(``tests/test_torch_cuda_splat.py``) hold S1 to the plain version bit for
bit."""
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.ops import splat as tsplat

from ._torch_port import CAM_T, CFG_T, H, W, fused_orbit_volumes, no_kernel  # noqa: F401

MODES = ("depth", "luma", "rgb")
NARROW = 32             # surfel slots of the repacked volume: most blocks use tier 2


@pytest.fixture(scope="module")
def carried():
    """The reference's volume after two orbit frames, on the port's side,
    its visible list re-run at the second pose."""
    _, tv, _, pose_t = fused_orbit_volumes()
    return tal.update_visibility(tv, CAM_T, pose_t, H, W, CFG_T), pose_t


def _copy(vol):
    return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).clone()
                                       for f in dataclasses.fields(vol)})


def _narrow(vol):
    """The volume's surfel rows packed again into NARROW slots (the
    integrate layer's own rule), and the config that says so."""
    band = tB.surfel_band(CFG_T)
    surf, kept, _ = tB.pack_surfels(vol.tsdf, vol.weight, band, NARROW)
    cfg = dataclasses.replace(CFG_T, surfel_slots=NARROW)
    return dataclasses.replace(vol, surfpack=surf, surf_count=kept), cfg


def _case(carried, case):
    """(volume, config) of a case; each copies the carried volume."""
    vol, cfg = _copy(carried[0]), CFG_T
    n = int(vol.num_visible)
    if case in ("tier2", "counts"):
        vol, cfg = _narrow(vol)
        half = NARROW // 2
        assert int((vol.surf_count[vol.visible_ids[:n].long()] > half).sum()) > 50
    if case == "counts":           # counts below the rows' live words: they stay unread
        ids = vol.visible_ids[:n].long()
        cut = vol.surf_count[ids].clone()
        cut[::3] = 0
        cut[1::3] = torch.clamp(cut[1::3], max=NARROW // 2)
        vol.surf_count[ids] = cut
    elif case == "zeros":          # empty rows (id 0) inside the listed ones
        vol.visible_ids[n // 3:n // 3 + 7] = 0
        vol.visible_ids[n // 2] = 0
    elif case == "empty":
        vol.num_visible.zero_()
    elif case == "full":           # every row listed (blocks repeat), the count past it
        real = torch.arange(1, int(vol.free_count), dtype=torch.int32)
        cap = vol.visible_ids.shape[0]
        vol.visible_ids.copy_(real.repeat(-(-cap // real.shape[0]))[:cap])
        vol.num_visible.fill_(cap + 5)
    return vol, cfg


def _one_pass(vol, pose, cfg, mode, zref=None):
    """What S1 computes, as PyTorch ops: one scatter over every listed row
    (below the count and the list's length, id > 0) of the slots its tiers
    cover, [0, S/2) of a block with a surfel and [0, S) of one with more
    than S/2."""
    S = cfg.surfel_slots
    ids = vol.visible_ids.to(torch.int64)
    held = vol.surf_count[ids]
    stop = torch.where(held > S // 2, S, torch.where(held > 0, S // 2, 0))
    rows_ok = (torch.arange(ids.shape[0]) < vol.num_visible) & (ids > 0)
    lanes_ok = rows_ok[:, None] & (torch.arange(S)[None, :] < stop[:, None])
    fill, dtype = {"depth": (float("inf"), torch.float32),
                   "luma": (tsplat._LUMA_EMPTY, torch.int32), "rgb": (-1, torch.int32)}[mode]
    buf = torch.full((H * W + 1,), fill, dtype=dtype)
    tsplat._scatter_surfels(buf, vol, CAM_T, pose.inverse(), pose.translation, ids,
                            lanes_ok, 0, S, H, W, cfg, mode == "luma", zref)
    return buf[:H * W]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", ["visible", "tier2", "counts", "zeros", "empty", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_two_tiers_equal_one_pass_over_the_listed_blocks(carried, mode, case):
    vol, cfg = _case(carried, case)
    pose = carried[1]
    tiers = tsplat._splat_zbuf_surfels_plain(vol, CAM_T, pose, H, W, cfg,
                                             with_color=mode == "rgb", luma=mode == "luma")
    if mode == "rgb":
        zbuf, want = tiers
        assert torch.equal(_bits(zbuf), _bits(_one_pass(vol, pose, cfg, "depth")))
        got = _one_pass(vol, pose, cfg, "rgb", zref=zbuf)
    else:
        want, got = tiers, _one_pass(vol, pose, cfg, mode)
    assert torch.equal(_bits(got), _bits(want))
    empty = {"depth": float("inf"), "luma": tsplat._LUMA_EMPTY, "rgb": -1}[mode]
    hit = float((want != empty).float().mean())
    assert hit == 0.0 if case == "empty" else hit > 0.05


@pytest.mark.parametrize("mode", MODES)
def test_cpu_volume_takes_the_plain_version(carried, mode, no_kernel):  # noqa: F811
    vol, pose = carried
    kw = dict(with_color=mode == "rgb", luma=mode == "luma")
    got = tsplat._splat_zbuf_surfels(vol, CAM_T, pose, H, W, CFG_T, **kw)
    want = tsplat._splat_zbuf_surfels_plain(vol, CAM_T, pose, H, W, CFG_T, **kw)
    for a, b in zip(got if mode == "rgb" else (got,), want if mode == "rgb" else (want,)):
        assert torch.equal(_bits(a), _bits(b))


def test_splat_zbuf_constants_match_the_kernel():
    """The wrapper's modes and slot limit are the kernel's, and so are the
    empty surfel word and the top of the depth quantization."""
    src = (Path(cuda_kernels.CSRC) / "splat_zbuf.cu").read_text()
    assert int(re.search(r"kMaxSlots = (\d+);", src).group(1)) == cuda_kernels.SPLAT_MAX_SLOTS
    enum = re.search(r"enum Mode \{ kDepth = 0, kLuma = 1, kColor = 2 \};", src)
    assert enum and cuda_kernels.SPLAT_ZBUF_MODES == ("depth", "luma", "rgb")
    assert int(re.search(r"kEmptySurfel = (0x[0-9A-F]+);", src).group(1), 16) == (
        tB.EMPTY_SURFEL)
    assert re.search(r"kZqTop = \(1 << (\d+)\) - 2;", src).group(1) == str(tsplat._ZQ_BITS)
    assert tsplat.splat_scalars(CFG_T).zq_scale == tsplat._ZQ_MAX / CFG_T.ray_far


@pytest.mark.parametrize("bad", ["slots", "ray_near", "mode"])
def test_splat_zbuf_refuses_what_the_kernel_does_not_take(bad):
    """More than SPLAT_MAX_SLOTS surfel slots, a negative ray_near (depths
    are ordered as their bits) or an unknown mode raise before anything is
    built or loaded; nothing falls back to the plain version."""
    i32 = dict(dtype=torch.int32)
    slots = cuda_kernels.SPLAT_MAX_SLOTS + 1 if bad == "slots" else 8
    cfg = dataclasses.replace(CFG_T, ray_near=-0.1) if bad == "ray_near" else CFG_T
    with pytest.raises(ValueError, match={"slots": "surfel slots", "ray_near": "ray_near",
                                          "mode": "mode"}[bad]):
        cuda_kernels.splat_zbuf(
            torch.zeros((4, 4)), "nearest" if bad == "mode" else "depth",
            torch.arange(4, **i32), torch.tensor(2, **i32),
            (torch.zeros((4, slots), **i32), torch.zeros(4, **i32)),
            torch.zeros((4, 512), **i32), torch.zeros((4, 3), **i32), torch.zeros(15),
            (1.0, 1.0, 2.0, 2.0), tsplat.splat_scalars(cfg))
    assert cuda_kernels._lib is None
