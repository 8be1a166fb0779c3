"""The port's TUM reader, native runtime, trajectory helpers, StageTimer
and frame feed against the JAX package's (tests/test_native.py,
tests/test_utils.py and tests/test_pipeline.py's TUM reader test): the
same mini sequence read by both, PNGs written with every PNG row filter,
and PLY files byte for byte against the reference's native writer."""
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from vulcan_tpu.io import tum as jtum
from vulcan_tpu.utils import evaluate as jev
from vulcan_tpu_torch import native
from vulcan_tpu_torch.core.se3 import SE3
from vulcan_tpu_torch.io import tum
from vulcan_tpu_torch.io.ply import read_ply, write_ply
from vulcan_tpu_torch.utils import evaluate as tev
from vulcan_tpu_torch.utils.runtime import prefetch_to_device
from vulcan_tpu_torch.utils.timing import StageTimer

from ._torch_port import TUM_H, TUM_W, make_mini_tum


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return make_mini_tum(tmp_path_factory.mktemp("tum") / "seq", n=5)


def test_tum_dataset_matches_reference(seq):
    ds, ref = tum.TumDataset(str(seq)), jtum.TumDataset(str(seq))
    assert len(ds) == len(ref) == 5
    for a, b in zip(ds.frames, ref.frames):
        assert (a.timestamp, a.depth_path, a.rgb_path) == (
            b.timestamp, b.depth_path, b.rgb_path)
        np.testing.assert_array_equal(a.gt_pose, b.gt_pose)
        assert a.gt_pose.shape == (4, 4)
    assert (ds.camera.fx, ds.camera.fy, ds.camera.cx, ds.camera.cy) == tuple(
        float(getattr(ref.camera, k)) for k in ("fx", "fy", "cx", "cy"))
    assert ds.size == (TUM_W, TUM_H)


def test_load_equals_reference_decode(seq):
    """``load`` is bit-equal to the reference's OpenCV decode (division by
    the scale, as ``astype(float32) / 5000`` does), pose included."""
    ds, ref = tum.TumDataset(str(seq)), jtum.TumDataset(str(seq))
    for i in range(len(ds)):
        d, c, pose = ds.load(i)
        dj, cj, pj = ref.load(i)
        assert d.dtype == c.dtype == np.float32
        np.testing.assert_array_equal(d, dj)
        np.testing.assert_array_equal(c, cj)
        assert (d > 0).mean() > 0.1
        assert pose.rotation.device.type == "cpu"
        np.testing.assert_array_equal(pose.rotation.numpy(), np.asarray(pj.rotation))
        np.testing.assert_array_equal(pose.translation.numpy(),
                                      np.asarray(pj.translation))


def test_prefetch_loader_yields_every_frame_in_order(seq):
    ds = tum.TumDataset(str(seq))
    got = list(ds)
    assert len(got) == len(ds)
    for i, (d, c, pose) in enumerate(got):
        dl, cl, pl = ds.load(i)
        np.testing.assert_array_equal(d, dl)
        np.testing.assert_array_equal(c, cl)
        np.testing.assert_array_equal(pose.translation.numpy(), pl.translation.numpy())
    # A ring smaller than the sequence, more threads than slots.
    loader = native.PrefetchLoader([f.depth_path for f in ds.frames],
                                   [f.rgb_path for f in ds.frames],
                                   TUM_W, TUM_H, capacity=2, n_threads=3)
    for (d, c), (dl, cl, _) in zip(loader, got):
        np.testing.assert_array_equal(d, dl)
        np.testing.assert_array_equal(c, cl)
    loader.close()


def test_loader_raises_on_a_frame_it_cannot_decode(seq, tmp_path):
    ds = tum.TumDataset(str(seq))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    loader = native.PrefetchLoader([ds.frames[0].depth_path, str(bad)],
                                   [ds.frames[0].rgb_path, None], TUM_W, TUM_H)
    it = iter(loader)
    next(it)
    with pytest.raises(IOError, match="frame 1 decode failed: not a PNG"):
        next(it)
    loader.close()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(img, filters, interlace=0, color_type=None):
    """A PNG of ``img`` whose row y uses PNG filter ``filters[y % len]``."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    bd = 16 if img.dtype == np.uint16 else 8
    ct = {1: 0, 3: 2, 4: 6}[ch] if color_type is None else color_type
    raw = (img.astype(">u2").view(np.uint8) if bd == 16 else img).reshape(h, -1)
    raw = raw.astype(np.int64)
    bpp = ch * bd // 8
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        preds = [0 * cur, left, up, (left + up) >> 1, _paeth(left, up, upleft)]
        pred = preds[f] if f < len(preds) else 0 * cur
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bd, ct, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_decode_each_filter(filters, tmp_path):
    """16-bit and 8-bit gray depth, RGB and RGBA colour, each PNG row
    filter: decoded exactly as OpenCV decodes the same file."""
    import cv2

    rng = np.random.default_rng(sum(filters) + len(filters))
    h, w = 23, 37
    imgs = {
        "d16": rng.integers(0, 65536, (h, w)).astype(np.uint16),
        "g8": rng.integers(0, 256, (h, w)).astype(np.uint8),
        "rgb": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
        "rgba": rng.integers(0, 256, (h, w, 4)).astype(np.uint8),
    }
    for name, img in imgs.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(_png(img, filters))
        assert native.png_probe(path) == (w, h)
        if name in ("d16", "g8"):
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 5000.0
            np.testing.assert_array_equal(native.decode_depth(path, w, h), want)
        else:
            want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32) / 255.0
            np.testing.assert_array_equal(native.decode_rgb(path, w, h), want)
            np.testing.assert_array_equal(
                native.decode_rgb(path, w, h), img[..., :3].astype(np.float32) / 255.0)


def test_png_errors_raise(tmp_path):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    good = _png(rgb, (1,))
    cases = {
        "missing": (None, "cannot open"),
        "text": (b"hello", "not a PNG"),
        "truncated": (good[:-20], "corrupt"),
        "crc": (good[:40] + bytes([good[40] ^ 1]) + good[41:], "corrupt"),
        "interlaced": (_png(rgb, (0,), interlace=1), "not decoded"),
        "palette": (_png(rgb[..., 0], (0,), color_type=3), "not decoded"),
        "bad filter": (_png(rgb, (7,)), "unknown filter"),
    }
    for name, (data, msg) in cases.items():
        path = tmp_path / f"{name}.png"
        if data is not None:
            path.write_bytes(data)
        with pytest.raises(IOError, match=msg):
            native.decode_rgb(str(path), 8, 8)
    path = tmp_path / "rgb.png"
    path.write_bytes(good)
    with pytest.raises(IOError, match="size differs"):
        native.decode_rgb(str(path), 9, 8)
    with pytest.raises(IOError, match="wrong kind"):
        native.decode_depth(str(path), 8, 8)


@pytest.mark.parametrize("weld", [True, False])
def test_write_ply_bytes_equal_reference_native(weld, tmp_path):
    """A welded marching-cubes-like soup (shared vertices, 1e-6 jitter
    under the weld resolution): the port's file is byte for byte the
    reference's native writer's."""
    from vulcan_tpu import native as jnative

    rng = np.random.default_rng(2)
    grid = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pos = grid[rng.integers(0, 300, (500, 3))]
    pos = pos + rng.normal(0, 1e-7, pos.shape).astype(np.float32)
    col = rng.uniform(-0.1, 1.1, pos.shape).astype(np.float32)
    a, b = tmp_path / "port.ply", tmp_path / "ref.ply"
    write_ply(str(a), pos, col, weld=weld)
    jnative.ply_write(str(b), pos, col, weld=weld)
    assert a.read_bytes() == b.read_bytes()
    assert b"comment vulcan-tpu mesh (native)" in a.read_bytes()[:80]
    verts, _, faces = read_ply(str(a))
    assert len(faces) == 500
    # The weld's plain version: one vertex per distinct float32 position
    # rounded to the 1e-5 grid (``lrintf(p * (1 / 1e-5f))``).
    keys = np.rint(pos.reshape(-1, 3) * (np.float32(1) / np.float32(1e-5)))
    assert len(verts) == (len(np.unique(keys, axis=0)) if weld else 1500)
    assert len(verts) < 400 or not weld
    np.testing.assert_allclose(verts[faces], pos, atol=1e-5)


def test_associate_rotmat_trajectory_match_reference(tmp_path):
    a = np.array([1.0, 2.0, 3.0, 10.0, 1.02])
    b = np.array([1.01, 2.05, 2.96, 5.0])
    for args in ((a, b, 0.1), (a, b, 0.02), (a[:2], b[:1], 0.1)):
        assert tev.associate_timestamps(*args) == jev.associate_timestamps(*args)
    rng = np.random.default_rng(0)
    rots, trans = [], []
    for th in [0.0, 0.3, np.pi - 1e-3, -2.5, 3.1]:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        np.testing.assert_array_equal(tev.rotmat_to_quat(R), jev.rotmat_to_quat(R))
        np.testing.assert_allclose(tum.quat_to_rotmat(tev.rotmat_to_quat(R)), R,
                                   atol=1e-9)
        rots.append(R.astype(np.float32))
        trans.append(rng.normal(size=3).astype(np.float32))
    stamps = [1.5 * i for i in range(len(rots))]
    tev.write_tum_trajectory(str(tmp_path / "a.txt"), stamps, rots, trans)
    jev.write_tum_trajectory(str(tmp_path / "b.txt"), stamps, rots, trans)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_se3_matrix_roundtrip_matches_reference():
    from vulcan_tpu.core.se3 import SE3 as JSE3

    xi = np.array([[0.1, -0.2, 0.3, 1.0, 2.0, -3.0], [0.0, 0.0, 0.0, 0.5, 0.0, 0.0]],
                  np.float32)
    T = SE3.exp(torch.from_numpy(xi))
    M = T.as_matrix()
    Mj = JSE3(np.asarray(T.rotation), np.asarray(T.translation)).as_matrix()
    assert M.shape == (2, 4, 4)
    np.testing.assert_array_equal(M.numpy(), np.asarray(Mj))
    back = SE3.from_matrix(M)
    assert torch.equal(back.rotation, T.rotation)
    assert torch.equal(back.translation, T.translation)
    assert torch.equal(SE3.from_matrix(M[:, :3]).translation, T.translation)


def test_stage_timer_matches_reference():
    from vulcan_tpu.utils.timing import StageTimer as JStageTimer

    timers = (StageTimer(), StageTimer("cpu"), JStageTimer())
    for t in timers:
        for _ in range(2):
            with t.stage("a"):
                time.sleep(0.01)
        with t.stage("b"):
            pass
    for t in timers:
        s = t.summary()
        assert set(s) == {"a", "b"} and set(t.last_ms) == {"a", "b"}
        assert 5 < s["a"] < 5000 and t.last_ms["a"] > 5
        assert dict(t.counts) == {"a": 2, "b": 1}
    assert not timers[1]._sync     # only a CUDA device is synchronized


def test_prefetch_to_device_on_cpu():
    """Arrays arrive as tensors on the device, in order, tensors already
    there and non-array leaves pass through untouched; every lookahead."""
    arrays = [np.full((2, 3), i, np.float32) for i in range(5)]
    ro = np.arange(4.0)
    ro.setflags(write=False)
    items = [(a, torch.tensor(float(i)), f"frame{i}", None, ro)
             for i, a in enumerate(arrays)]
    for lookahead in (0, 1, 2, 7):
        got = list(prefetch_to_device(iter(items), "cpu", lookahead))
        assert len(got) == 5
        for i, (a, t, name, none, r) in enumerate(got):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), arrays[i])
            assert t is items[i][1] and name == f"frame{i}" and none is None
            np.testing.assert_array_equal(r.numpy(), ro)
