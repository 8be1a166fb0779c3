"""The port's five-class API (``pipeline/api.py``): ``make_frame``,
``Volume`` (setters, ``validate``, v4 snapshots both ways), ``Integrator``,
``Tracer``, the four trackers and ``Extractor``, held against the JAX
package's classes on tests/test_pipeline.py's scene.  (``Tracer`` under
the ray march: tests/test_torch_raycast.py.)"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu import Volume as JVolume
from vulcan_tpu import make_frame as j_make_frame
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.utils.evaluate import ate_rmse as j_ate_rmse
from vulcan_tpu_torch.io.ply import read_ply
from vulcan_tpu_torch.ops.raycast import Render
from vulcan_tpu_torch.utils.convert import flatten, volume_from_numpy
from vulcan_tpu_torch.utils.evaluate import ate_rmse

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, orbit, reference_five_class, rot_angle, scene,
    se3_t, t,
)

N = 6
PLANAR = ("depth", "vx", "vy", "vz", "nx", "ny", "nz", "color", "valid")
VOLUME_INT = ("hash_codes", "hash_values", "free_count", "block_coords",
              "visible_ids", "num_visible", "alloc_overflow", "visible_overflow")


def render_t(r) -> Render:
    """A JAX package ``Render`` -> the port's (CPU tensors)."""
    return Render(**{f: t(getattr(r, f)) for f in PLANAR}, camera=CAM_T,
                  pose=se3_t(r.pose))


@pytest.fixture(scope="module")
def reference_flow():
    """tests/test_pipeline.py's five-class flow in the reference (its
    Integrator, Tracer and Tracker methods, jitted) over N frames of the
    closed-loop orbit.  Keeps, per tracked frame, the volume before the
    trace, the model render and the pose it was traced from."""
    integrate, trace, track = reference_five_class()
    poses = orbit(N)
    frames = [scene(p) for p in poses]
    state = integrate(JVolume(CFG_J).state, *frames[0], poses[0])
    after_first = flatten(state)
    pose, steps, est = poses[0], [], []
    for d, c in frames[1:]:
        before = flatten(state)
        state, model = trace(state, pose)
        steps.append(dict(volume=before, model=model, pose=pose))
        pose = track(model, d, c, pose, "depth").pose
        state = integrate(state, d, c, pose)
        est.append(np.asarray(pose.translation))
    return dict(poses=poses, frames=frames, after_first=after_first, steps=steps,
                est=np.stack(est), final=flatten(state), track=track)


def _port_volume(arrays) -> P.Volume:
    v = P.Volume(CFG_T, device="cpu")
    v.state = volume_from_numpy(arrays)
    return v


def test_make_frame_matches_reference():
    """float32 conversion of the values as they are (no unit scaling), the
    default zero colour, TUM camera and identity pose, on the device
    asked for."""
    d16 = (np.arange(H * W, dtype=np.uint16) % 5000).reshape(H, W)
    ft = P.make_frame(d16, device="cpu")
    fj = j_make_frame(d16)
    assert ft.depth.dtype == torch.float32 and ft.depth.device.type == "cpu"
    np.testing.assert_array_equal(ft.depth.numpy(), np.asarray(fj.depth))
    np.testing.assert_array_equal(ft.color.numpy(), np.asarray(fj.color))
    assert (ft.height, ft.width) == (fj.height, fj.width) == (H, W)
    for k in ("fx", "fy", "cx", "cy"):
        assert getattr(ft.camera, k) == float(getattr(fj.camera, k))
    np.testing.assert_array_equal(ft.pose.rotation.numpy(), np.asarray(fj.pose.rotation))
    np.testing.assert_array_equal(ft.pose.translation.numpy(),
                                  np.asarray(fj.pose.translation))
    d, c = scene(orbit(1)[0])
    pose = se3_t(orbit(1)[0])
    f2 = P.make_frame(torch.tensor(d, dtype=torch.float64), c, CAM_T, pose, device="cpu")
    assert f2.depth.dtype == f2.color.dtype == torch.float32
    np.testing.assert_array_equal(f2.color.numpy(), c)
    assert f2.camera is CAM_T


def test_volume_setters_refuse_a_fused_volume():
    vol = P.Volume(CFG_T, device="cpu")
    assert vol.set_voxel_size(0.02) is vol and vol.config.voxel_size == 0.02
    vol.set_truncation_length(0.08)
    assert vol.config.trunc_dist == 0.08
    pose = orbit(1)[0]
    P.Integrator(vol).integrate(P.make_frame(*scene(pose), CAM_T, se3_t(pose), device="cpu"))
    assert vol.num_allocated > 20
    for setter in (vol.set_voxel_size, vol.set_truncation_length):
        with pytest.raises(RuntimeError, match="fused data"):
            setter(0.01)
    assert vol.config.voxel_size == 0.02


def test_integrator_matches_reference(reference_flow):
    """One ``Integrator.integrate`` at a given pose: every integer array
    exact, the TSDF to float32 rounding."""
    poses, frames = reference_flow["poses"], reference_flow["frames"]
    vol = P.Volume(CFG_T, device="cpu")
    P.Integrator(vol).integrate(P.make_frame(*frames[0], CAM_T, se3_t(poses[0]),
                                             device="cpu"))
    got, ref = flatten(vol.state), reference_flow["after_first"]
    for name in VOLUME_INT:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    np.testing.assert_allclose(got["tsdf"], ref["tsdf"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["weight"], ref["weight"])
    assert vol.num_visible == vol.num_allocated > 20


def test_validate_matches_reference(reference_flow):
    """``Volume.validate`` on the same fused state: every finding equal;
    the faults (bad or duplicate values, count mismatch, overflows, surfel
    mismatches) all zero."""
    arrays = reference_flow["final"]
    jv = JVolume(CFG_J)
    jv.state = dataclasses.replace(jv.state, **{k: jnp.asarray(v) for k, v in arrays.items()})
    got, want = _port_volume(arrays).validate(), jv.validate()
    assert got == want
    assert got["allocated_blocks"] == got["hash_entries"] > 100
    faults = {k: v for k, v in got.items() if k not in ("allocated_blocks", "hash_entries")}
    assert set(faults.values()) == {0}, faults


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_loads_in_the_other_package(reference_flow, tmp_path, writer):
    """A v4 snapshot written by either package loads in the other with
    every array bit-equal; both write the same keys, dtypes and shapes."""
    arrays = reference_flow["final"]
    tv = _port_volume(arrays)
    jv = JVolume(CFG_J)
    jv.state = dataclasses.replace(jv.state, **{k: jnp.asarray(v) for k, v in arrays.items()})
    paths = {"port": str(tmp_path / "port.npz"), "reference": str(tmp_path / "ref.npz")}
    tv.save(paths["port"])
    jv.save(paths["reference"])
    with np.load(paths["port"]) as a, np.load(paths["reference"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert int(a["__snapshot_version__"]) == 4
    if writer == "port":
        loaded = JVolume(CFG_J)
        loaded.load(paths["port"])
        got = {f.name: np.asarray(getattr(loaded.state, f.name))
               for f in dataclasses.fields(loaded.state)}
    else:
        loaded = P.Volume(CFG_T, device="cpu")
        loaded.load(paths["reference"])
        got = flatten(loaded.state)
        assert loaded.state.tsdf.device.type == "cpu"
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("fault,match", [
    ("legacy", "legacy positional"),
    ("v3", "format v3"),
    ("missing", "missing 'tsdf'"),
    ("dtype", "'tsdf' has dtype float64"),
    ("shape", "'tsdf' has shape"),
])
def test_snapshot_faults_raise_as_the_reference(tmp_path, fault, match):
    """Files the reference refuses, the port refuses with the same
    ``ValueError``: positional (legacy) files, other versions (v3 too),
    missing fields, other dtypes and shapes."""
    vol = P.Volume(CFG_T, device="cpu")
    good = flatten(vol.state)
    arrays = dict(good, __snapshot_version__=np.asarray(4))
    if fault == "legacy":
        arrays = {f"arr_{i}": v for i, v in enumerate(good.values())}
    elif fault == "v3":
        arrays["__snapshot_version__"] = np.asarray(3)
    elif fault == "missing":
        del arrays["tsdf"]
    elif fault == "dtype":
        arrays["tsdf"] = arrays["tsdf"].astype(np.float64)
    else:
        arrays["tsdf"] = arrays["tsdf"][:-1]
    path = str(tmp_path / "bad.npz")
    np.savez_compressed(path, **arrays)
    for volume in (vol, JVolume(CFG_J)):
        with pytest.raises(ValueError, match=match):
            volume.load(path)


def test_tracer_matches_reference(reference_flow):
    """``Tracer.trace`` of the same volume at the same pose: the render
    within tests/test_torch_splat.py's bounds (valid masks and depths
    equal but on 0.1-0.2% of pixels, the rgb colour but on 0.5%)."""
    step = reference_flow["steps"][2]
    vol = _port_volume(step["volume"])
    rt = P.Tracer(vol).trace(CAM_T, se3_t(step["pose"]), H, W)
    rj = step["model"]
    valid_j, valid_t = np.asarray(rj.valid), rt.valid.numpy()
    assert valid_j.mean() > 0.3
    assert np.mean(valid_j != valid_t) < 1e-3
    both = valid_j & valid_t
    for name in ("depth", "vx", "vy", "vz"):
        a, b = getattr(rt, name).numpy()[both], np.asarray(getattr(rj, name))[both]
        assert np.mean(np.abs(a - b) > 1e-5) < 2e-3, name
    ct, cj = rt.color.numpy(), np.asarray(rj.color)
    assert (cj.sum(-1) > 0).mean() > 0.3
    assert np.mean(np.any(np.abs(ct - cj) > 1e-6, axis=-1)) < 5e-3


def test_tracer_updates_visibility_as_the_reference(reference_flow):
    """The trace's visibility pass gives the reference's visible list; with
    ``update_visibility=False`` the list is left as it was."""
    from vulcan_tpu.ops import allocate as jal

    step = reference_flow["steps"][2]
    vol = _port_volume(step["volume"])
    P.Tracer(vol).trace(CAM_T, se3_t(step["pose"]), H, W)
    jstate = jal.update_visibility(
        jB.VolumeState(**{k: jnp.asarray(v) for k, v in step["volume"].items()}),
        CAM_J, step["pose"], H, W, CFG_J)
    np.testing.assert_array_equal(vol.state.visible_ids.numpy(), np.asarray(jstate.visible_ids))
    assert vol.num_visible == int(jstate.num_visible) > 0
    vol2 = _port_volume(step["volume"])
    P.Tracer(vol2).trace(CAM_T, se3_t(step["pose"]), H, W, update_visibility=False)
    np.testing.assert_array_equal(vol2.state.visible_ids.numpy(),
                                  step["volume"]["visible_ids"])


@pytest.mark.parametrize("cls,mode", [
    ("DepthTracker", "depth"), ("ColorTracker", "color"), ("Tracker", "combined"),
    ("LightTracker", "light"),
])
def test_tracker_matches_reference(reference_flow, cls, mode):
    """Each tracker on the reference's render and the same live frame:
    the pose within tests/test_torch_icp.py's 1e-5 m (depth) or
    tests/test_torch_photo.py's 1e-4 m and 1e-4 rad (photometric modes).
    The photometric modes run one association round a level (their
    reference compiles in half the time; tests/test_torch_photo.py holds
    ``icp.track`` at the full budget)."""
    step = reference_flow["steps"][2]
    d, c = reference_flow["frames"][3]
    kw = {} if mode == "depth" else dict(icp_assoc=(1, 1, 1))
    cfg_t = dataclasses.replace(CFG_T, **kw)
    tracker = (P.Tracker(cfg_t, mode=mode, device="cpu") if cls == "Tracker"
               else getattr(P, cls)(cfg_t, device="cpu"))
    assert tracker.mode == mode
    pose_t = se3_t(step["pose"])
    rt = tracker.track(render_t(step["model"]), P.make_frame(d, c, CAM_T, pose_t,
                                                             device="cpu"),
                       init_pose=pose_t)
    track = (reference_flow["track"] if mode == "depth"
             else reference_five_class(cfg_j=dataclasses.replace(CFG_J, **kw))[2])
    rj = track(step["model"], d, c, step["pose"], mode)
    tol = 1e-5 if mode == "depth" else 1e-4
    np.testing.assert_allclose(rt.pose.translation.numpy(), np.asarray(rj.pose.translation),
                               rtol=0, atol=tol)
    assert rot_angle(rt.pose.rotation.numpy(), rj.pose.rotation) < tol
    assert bool(rt.valid) == bool(rj.valid)
    np.testing.assert_allclose(rt.level_inliers.numpy(), np.asarray(rj.level_inliers),
                               rtol=5e-3)
    if mode != "color":
        truth = np.asarray(reference_flow["poses"][3].translation)
        assert np.abs(rt.pose.translation.numpy() - truth).max() < 0.02


def test_model_from_frame_maps_matches_reference():
    """World-space model maps lifted from one frame's camera-space maps
    (the tracker's bootstrap before a first render): the validity and the
    snapped origin exact, the packed vertex and normal words equal but
    where a rotated coordinate sits within an ulp of a quantization step
    (the reference fuses the rotation's FMAs; at most 0.1% of pixels)."""
    from vulcan_tpu.ops import icp as jicp
    from vulcan_tpu.ops.preprocess import build_pyramid as j_build_pyramid
    from vulcan_tpu_torch.core.frame import FrameMaps
    from vulcan_tpu_torch.ops import icp as ticp

    pose = orbit(2)[1]
    fj = j_build_pyramid(j_make_frame(*scene(pose), CAM_J, pose), CFG_J)[0]
    ft = FrameMaps(t(fj.depth), t(fj.vertices), t(fj.normals), t(fj.intensity), CAM_T)
    mj = jicp.model_from_frame_maps(fj, pose)
    mt = ticp.model_from_frame_maps(ft, se3_t(pose))
    valid = np.asarray(mj.valid)
    assert valid.mean() > 0.3
    np.testing.assert_array_equal(mt.valid.numpy(), valid)
    np.testing.assert_array_equal(mt.origin.numpy(), np.asarray(mj.origin))
    np.testing.assert_array_equal(mt.intensity.numpy(), np.asarray(mj.intensity))
    for name in ("vpack1", "vpack2", "npack"):
        assert np.mean(getattr(mt, name).numpy() != np.asarray(getattr(mj, name))) <= 1e-3, name
    np.testing.assert_allclose(mt.world_to_cam.translation.numpy(),
                               np.asarray(mj.world_to_cam.translation), rtol=0, atol=1e-6)


def test_five_class_flow_matches_reference(reference_flow, tmp_path):
    """tests/test_pipeline.py's explicit flow (Volume + Integrator +
    Tracer + DepthTracker + Extractor) on the closed-loop orbit: each
    frame within 1e-3 m of the reference's and the ATEs within 1e-3 m
    (tests/test_torch_pipeline.py's bounds); the mesh exports.  (That
    test's own 14.4 deg/frame orbit sits on a basin edge: a 1e-4 m
    difference at its second frame sends the reference's tracker, too,
    0.37 m off on its third; this orbit turns ~10 deg a frame.)"""
    poses, frames = reference_flow["poses"], reference_flow["frames"]
    volume = P.Volume(CFG_T, device="cpu")
    integrator, tracer = P.Integrator(volume), P.Tracer(volume)
    tracker, extractor = P.DepthTracker(CFG_T, device="cpu"), P.Extractor(volume)
    integrator.integrate(P.make_frame(*frames[0], CAM_T, se3_t(poses[0]), device="cpu"))
    assert volume.num_visible == volume.num_allocated > 20
    pose, est = se3_t(poses[0]), []
    for true_pose, (d, c) in zip(poses[1:], frames[1:]):
        model = tracer.trace(CAM_T, pose, H, W)
        pose = tracker.track(model, P.make_frame(d, c, CAM_T, pose, device="cpu"),
                             init_pose=pose).pose
        integrator.integrate(P.make_frame(d, c, CAM_T, pose, device="cpu"))
        est.append(pose.translation.numpy())
        assert np.linalg.norm(est[-1] - np.asarray(true_pose.translation)) < 0.02
    est, ref = np.stack(est), reference_flow["est"]
    np.testing.assert_allclose(est, ref, rtol=0, atol=1e-3)
    gt = np.stack([np.asarray(p.translation) for p in poses[1:]])
    assert abs(ate_rmse(est, gt) - j_ate_rmse(ref, gt)) < 1e-3
    path = str(tmp_path / "mesh.ply")
    n = extractor.export_ply(path)
    assert n > 500 and n == int(extractor.extract().count)
    assert len(read_ply(path)[2]) == n


def test_pipeline_export_ply(tmp_path):
    poses = orbit(3)
    pipe = P.Pipeline(CFG_T, CAM_T, H, W, init_pose=se3_t(poses[0]), device="cpu")
    for pose in poses:
        pipe.process(*scene(pose))
    mesh = pipe.extract_mesh()
    path = str(tmp_path / "scene.ply")
    count = pipe.export_ply(path)
    assert count == int(mesh.count) > 1000 and int(mesh.overflow) == 0
    verts, cols, faces = read_ply(path)
    assert len(faces) == count and len(verts) < 3 * count
    assert faces.max() < len(verts) and 0.0 <= cols.min() and cols.max() <= 1.0
