"""The port's row-sharded step (``vulcan_tpu_torch.parallel.sharding``)
on spawned CPU ranks joined by gloo, as tests/test_parallel.py holds the
reference on 8 virtual devices: the dryrun on 2 and 8 ranks, and 2 and 4
ranks (4, not 8: 8 spawned ranks took ~24 s for this comparison alone)
on three frames of a camera that moves 1.6 cm and 0.6 degrees a frame,
so that the track has to solve.  Every rank's pose is bit-identical and
every rank makes the same host reads; rank 0 is held against the port's
single process and against the reference's ``Pipeline`` on the same
frames.  The track's inliers at every pyramid level must equal the
single process's: a rank that summed rows it does not own, or two ranks
that took the same rows, would scale them."""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vulcan_tpu_torch import TINY, PinholeCamera
from vulcan_tpu_torch.parallel import sharding
from vulcan_tpu_torch.pipeline import fusion
from vulcan_tpu_torch.utils.sync import read_int

from ._torch_port import jflat, rot_angle

H, W = 64, 128
CAM = PinholeCamera.create(80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5)
N_FRAMES = 3
RUNS = [(2, "depth"), (4, "depth"), (2, "light")]


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip(n):
    sharding.dryrun(n, height=H, width=W)


def _pose_j(k):
    """The reference's SE3 of frame k: 0.6 degrees about y and
    (12, -6, 8) mm a frame."""
    import jax.numpy as jnp

    from vulcan_tpu.core.se3 import SE3 as JSE3

    a = np.deg2rad(0.6 * k)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    m[:3, 3] = [0.012 * k, -0.006 * k, 0.008 * k]
    return JSE3.from_matrix(jnp.asarray(m))


def _camera_j():
    from vulcan_tpu.core.camera import PinholeCamera as JCam

    return JCam.create(80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5)


@functools.lru_cache(maxsize=None)
def _frames():
    """tests/test_parallel.py's scene (two spheres and a back wall
    constrain all 6 DoF), rendered by the reference at each frame's pose."""
    from vulcan_tpu.io.synthetic import render_scene_depth

    return tuple(
        tuple(np.array(x) for x in render_scene_depth(
            _camera_j(), _pose_j(k), H, W,
            (((0.0, 0.0, 1.5), 0.5), ((0.45, 0.25, 1.1), 0.2)), floor_z=2.5))
        for k in range(N_FRAMES))


@functools.lru_cache(maxsize=None)
def _reference(mode):
    """The reference Pipeline's state after each frame, flattened."""
    from vulcan_tpu import Pipeline as JPipeline
    from vulcan_tpu.config import TINY as J_TINY

    pipe = JPipeline(J_TINY, _camera_j(), H, W, mode=mode)
    out = []
    for d, c in _frames():
        pipe.process(d, c)
        out.append(jflat(pipe.state))
    return out


@functools.lru_cache(maxsize=None)
def _single(mode):
    """The port's single-process step: (final state, each frame's
    translation and level inliers, host reads)."""
    s1 = fusion.init_state(TINY, CAM, H, W, device="cpu")
    read_int.count = 0
    trans, level = [], []
    for d, c in _frames():
        s1 = fusion.step(s1, torch.from_numpy(d), torch.from_numpy(c), TINY, mode)
        trans.append(s1.pose.translation.numpy().copy())
        level.append(s1.track_level_inliers.numpy().copy())
    return s1, np.stack(trans), np.stack(level), read_int.count


@functools.lru_cache(maxsize=None)
def _ranks(n, mode):
    return sharding.run_ranks(n, sharding.run_frames,
                              (TINY, CAM, list(_frames()), None, mode))


@pytest.mark.parametrize("n,mode", RUNS)
def test_sharded_matches_single_process(n, mode):
    s1, trans, level, reads = _single(mode)
    ranks = _ranks(n, mode)
    r0 = ranks[0]
    for r in ranks[1:]:
        # No broadcast: every rank computes the same pose, bit for bit.
        np.testing.assert_array_equal(r["rotation"], r0["rotation"])
        np.testing.assert_array_equal(r["translation"], r0["translation"])
        np.testing.assert_array_equal(r["tsdf"], r0["tsdf"])
        assert r["reads"] == r0["reads"] and r["free_count"] == r0["free_count"]
    assert r0["reads"] == reads and r0["frame"] == N_FRAMES
    assert r0["track_failures"] == int(s1.track_failures) == 0
    # TINY's 1024 visible slots overflow on this scene, in both runs alike.
    assert r0["overflow"] == int(s1.volume.alloc_overflow) + int(s1.volume.visible_overflow)
    # The camera moved: frames 1 and 2 tracked, at every level.
    assert (level[1:] > 300).all()
    np.testing.assert_array_equal(r0["level_inliers"], level)
    # Only the order of the sums differs: measured <= 1.4e-7 m.
    np.testing.assert_allclose(r0["translation"], trans, rtol=0, atol=1e-6)

    # tests/test_parallel.py's physical tolerances, far inside them here.
    nf1, nfn = int(s1.volume.free_count), r0["free_count"]
    assert nf1 == nfn
    v1, vn = s1.model.valid.numpy(), r0["valid"]
    assert (v1 != vn).mean() < 1e-3
    both = v1 & vn
    assert both.sum() > 1000
    diff = np.abs(s1.model.depth.numpy()[both] - r0["depth"][both])
    assert np.quantile(diff, 0.99) < TINY.voxel_size
    # The ranks return the tsdf rows below their free count; the rows past
    # it are untouched in both runs.
    t1 = s1.volume.tsdf.numpy().astype(np.float64)
    assert (np.abs(t1[:nfn] - r0["tsdf"]) > 1e-3).sum() / t1.size < 1e-3


@pytest.mark.parametrize("n,mode", RUNS)
def test_sharded_matches_reference(n, mode):
    """Rank 0 against the reference's Pipeline on the same frames, to the
    per-frame handoff tolerances of tests/test_torch_pipeline.py (in light
    mode the port's single process is itself 6.5e-5 m and one level-0
    inlier from the reference at frame 2; depth mode 1.8e-7 m)."""
    ref = _reference(mode)
    r0 = _ranks(n, mode)[0]
    for k, rs in enumerate(ref):
        np.testing.assert_allclose(r0["translation"][k], rs["model.pose.translation"],
                                   rtol=0, atol=1e-4)
        assert rot_angle(r0["rotation"][k], rs["model.pose.rotation"]) < 1e-4
        # Inlier counts at quantization boundaries: ROADMAP section 3's 0.1%.
        got, want = r0["level_inliers"][k], rs["track_level_inliers"]
        assert (np.abs(got - want) <= 1e-3 * want).all(), (k, got, want)
    last = ref[-1]
    assert int(last["track_failures"]) == r0["track_failures"] == 0
    assert int(last["volume.free_count"]) == r0["free_count"]
    vj, vn = last["model.valid"], r0["valid"]
    assert (vj != vn).mean() < 2e-3
    both = vj & vn
    assert both.sum() > 1000
    diff = np.abs(last["model.depth"][both] - r0["depth"][both])
    assert np.quantile(diff, 0.99) < TINY.voxel_size


def test_state_sharding_follows_the_reference_rule():
    class Two:
        size = 2

    state = fusion.init_state(TINY, CAM, H, W, device="meta")
    spec = sharding.state_sharding(Two, state)
    maps = {"depth", "vx", "vy", "vz", "nx", "ny", "nz", "color", "valid"}
    assert set(spec) == {f"model.{m}" for m in maps}
    assert "model.pose.rotation" not in spec       # (3, 3): 3 rows do not split in 2


def test_make_mesh_needs_enough_ranks(tmp_path):
    with pytest.raises(RuntimeError, match="initialized"):
        sharding.make_mesh(2, device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match=r"make_mesh\(2\) found only 1"):
            sharding.make_mesh(2, device="cpu")
        mesh = sharding.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert mesh.bounds(480) == (0, 480)
        with pytest.raises(ValueError, match="do not divide"):
            sharding.make_sharded_step(TINY, sharding.Mesh(mesh.group, 0, 3, mesh.device),
                                       H, W)
    finally:
        dist.destroy_process_group()
