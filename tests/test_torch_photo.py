"""The photometric tracking path held against the JAX package: the
intensity pyramids, the model-side photometric maps, the flat bilinear
association and its rows, ``track`` in the color/combined/light modes, and
the combined-mode pipeline step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulcan_tpu import Pipeline as JPipeline
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import icp as jicp
from vulcan_tpu.ops import preprocess as jpp
from vulcan_tpu.ops import sparse as jsp
from vulcan_tpu.ops import splat as jsplat
from vulcan_tpu_torch.core.frame import Frame, FrameMaps
from vulcan_tpu_torch.ops import icp as ticp
from vulcan_tpu_torch.ops import preprocess as tpp
from vulcan_tpu_torch.ops.raycast import Render
from vulcan_tpu_torch.pipeline import fusion as tfusion
from vulcan_tpu_torch.utils.convert import (
    pipeline_state_from_numpy,
    pipeline_state_to_numpy,
)

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, jflat, orbit, rot_angle, scene, se3_t, t,
)

# The pipeline's silhouette threshold at this config: max(0.05, 6 voxels).
FLAT = max(0.05, 6.0 * CFG_T.voxel_size)
CAMS_T = [CAM_T, CAM_T.scaled(0.5), CAM_T.scaled(0.5).scaled(0.5)]


@pytest.mark.parametrize("shape", [(150, 200), (75, 100), (37, 51)])
def test_intensity_from_color_and_downsample_exact(shape):
    rng = np.random.default_rng(11)
    c = rng.random(shape + (3,)).astype(np.float32)
    i = rng.random(shape).astype(np.float32)
    np.testing.assert_array_equal(
        tpp.intensity_from_color(t(c)).numpy(),
        np.asarray(jpp.intensity_from_color(jnp.asarray(c))),
    )
    np.testing.assert_array_equal(
        tpp.downsample_intensity(t(i)).numpy(),
        np.asarray(jpp.downsample_intensity(jnp.asarray(i))),
    )


@pytest.fixture(scope="module")
def photo_inputs():
    """The reference's luma model render at orbit pose 2 (two fused
    frames) and the live pyramid, with intensity, of the frame at pose 3,
    in both packages; the model pyramids are built on each side."""
    poses = orbit(4)
    jv = jB.create_volume(CFG_J)
    for pose in poses[1:3]:
        d, c = scene(pose)
        frame = make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
        jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
        jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
        jv = jsp.integrate_sparse(jv, frame, CFG_J, ids=band, count=n_band)
    rj = jsplat.render_splat(jv, CAM_J, poses[2], H, W, CFG_J,
                             with_color=True, color_space="luma")
    rt = Render(
        **{k: t(getattr(rj, k)) for k in
           ("depth", "vx", "vy", "vz", "nx", "ny", "nz", "color", "valid")},
        camera=CAM_T, pose=se3_t(rj.pose),
    )
    d, c = scene(poses[3])
    live_j = jpp.build_pyramid(
        make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, poses[3]), CFG_J
    )
    live_t = tuple(
        FrameMaps(t(m.depth), t(m.vertices), t(m.normals), t(m.intensity), cam)
        for m, cam in zip(live_j, CAMS_T)
    )
    return dict(
        rj=rj, rt=rt, live_j=live_j, live_t=live_t, poses=poses, frame=(d, c),
        mj=jicp.model_pyramid(rj, 3, flat_thresh=FLAT),
        mt=ticp.model_pyramid(rt, 3, flat_thresh=FLAT),
    )


def test_build_pyramid_intensity_exact(photo_inputs):
    d, c = photo_inputs["frame"]
    pose = photo_inputs["poses"][3]
    got = tpp.build_pyramid(Frame(t(d), t(c), CAM_T, se3_t(pose)), CFG_T)
    for a, b in zip(got, photo_inputs["live_j"]):
        np.testing.assert_array_equal(a.intensity.numpy(), np.asarray(b.intensity))
    assert all(m.intensity is None for m in tpp.build_pyramid(
        Frame(t(d), t(c), CAM_T, se3_t(pose)), CFG_T, with_intensity=False))


@pytest.mark.parametrize("reach,thresh", [(2, 0.05), (2, FLAT), (1, 0.02)])
def test_depth_flat_mask_exact(photo_inputs, reach, thresh):
    """On the model render's depth and on a random image with holes and
    steps: the jump test and the dilation are exact."""
    rng = np.random.default_rng(4)
    steps = np.kron(rng.uniform(0.5, 3.0, (6, 8)), np.ones((8, 8)))
    noisy = (steps + rng.normal(0.0, 0.004, steps.shape)).astype(np.float32)
    noisy[rng.random(noisy.shape) < 0.01] = 0.0
    rj = photo_inputs["rj"]
    for depth, valid in ((np.asarray(rj.depth), np.asarray(rj.valid)),
                         (noisy, noisy > 0.0)):
        ref = np.asarray(jicp._depth_flat_mask(
            jnp.asarray(depth), jnp.asarray(valid), reach, thresh))
        got = ticp._depth_flat_mask(t(depth), t(valid), reach, thresh).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.sum() < valid.sum()


def test_model_pyramid_photometric_maps_exact(photo_inputs):
    for a, b in zip(photo_inputs["mt"], photo_inputs["mj"]):
        for name in ("vpack1", "vpack2", "npack", "intensity", "valid"):
            np.testing.assert_array_equal(
                getattr(a, name).numpy(), np.asarray(getattr(b, name)), err_msg=name
            )
    # The luma model carries intensity where the render is valid.
    assert float(photo_inputs["mt"][0].intensity.sum()) > 0.0
    # Without intensity: no luma image, and validity is the render's.
    plain = ticp.model_pyramid(photo_inputs["rt"], 3, with_intensity=False)
    assert plain[0].intensity is None
    np.testing.assert_array_equal(plain[1].valid.numpy(),
                                  photo_inputs["rt"].valid.numpy()[::2, ::2])


def test_intensity_grads_exact(photo_inputs):
    for a, b in zip(photo_inputs["mt"], photo_inputs["mj"]):
        for ga, gb in zip(ticp.intensity_grads(a.intensity),
                          jicp.intensity_grads(b.intensity)):
            np.testing.assert_array_equal(ga.numpy(), np.asarray(gb))


def test_sample_bilinear_matches_reference():
    rng = np.random.default_rng(8)
    img = rng.random((40, 60)).astype(np.float32)
    uv = rng.uniform(-3.0, 63.0, (32, 32, 2)).astype(np.float32)
    uv[0, :4] = -1e9                                  # a point behind the camera
    vj, okj = jicp._sample_bilinear(jnp.asarray(img), jnp.asarray(uv))
    vt, okt = ticp._sample_bilinear(t(img), t(uv))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # Four products summed in the reference's order: within an ulp.
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)


def test_color_assoc_matches_reference(photo_inputs):
    """The packed words decode to the same samples at the same warp; the
    validity mask is exact."""
    pose_j = photo_inputs["poses"][2]
    pose_t = se3_t(pose_j)
    for level in range(3):
        mj, mt = photo_inputs["mj"][level], photo_inputs["mt"][level]
        sj = jicp.color_assoc(photo_inputs["live_j"][level], mj,
                              jicp.intensity_grads(mj.intensity), pose_j, CFG_J)
        st = ticp.color_assoc(photo_inputs["live_t"][level], mt,
                              ticp.intensity_grads(mt.intensity), pose_t, CFG_T)
        ok = st[5].numpy()
        np.testing.assert_array_equal(ok, np.asarray(sj[5]))
        assert ok.sum() > 50
        # The warp agrees to float32 rounding (R @ v summed in another
        # order): pixel coordinates within an ulp (1e-6 relative), so the
        # bilinear weights and the samples on [-0.5, 1] within 1e-5.
        for a, b in zip(st[:3], sj[:3]):
            np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=0,
                                       atol=1e-5)
        for a, b in zip(st[3:5], sj[3:5]):
            np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-6)


def test_color_rows_fixed_matches_reference(photo_inputs):
    """Rows from the reference's own samples at a pose off the sample
    point: j, r, w within 1e-5 (relative to each row's scale)."""
    pose_j = photo_inputs["poses"][2]
    pose_t = se3_t(pose_j)
    for level in range(3):
        mj, mt = photo_inputs["mj"][level], photo_inputs["mt"][level]
        live_j, live_t = photo_inputs["live_j"][level], photo_inputs["live_t"][level]
        sj = jicp.color_assoc(live_j, mj, jicp.intensity_grads(mj.intensity),
                              pose_j, CFG_J)
        st = tuple(t(x) for x in sj)
        jj, rj, wj = jicp.color_rows_fixed(live_j, sj, mj, pose_j, CFG_J)
        jt, rt, wt = ticp.color_rows_fixed(live_t, st, mt, pose_t, CFG_T)
        on = np.asarray(wj) > 0
        np.testing.assert_array_equal(wt.numpy() > 0, on)
        assert on.sum() > 50
        # Gated-out rows (w = 0) carry no weight: a pixel with no live
        # depth projects a point ~0 m from the model camera there.
        for a, b in ((rt, rj), (wt, wj), *zip(jt, jj)):
            b = np.asarray(b)[on]
            np.testing.assert_allclose(a.numpy()[on], b, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("mode,photo_levels", [
    ("color", 2), ("combined", 2), ("light", 2), ("combined", 0),
])
def test_track_modes_match_reference(photo_inputs, mode, photo_levels):
    """``track`` from the same maps: the pose within 1e-4 m and 1e-4 rad,
    the observability scores (the gate's and the geometric-only one, with
    the photo_levels=0 fallback) within 1e-3 relative."""
    cfg_j = dataclasses.replace(CFG_J, photo_levels=photo_levels)
    cfg_t = dataclasses.replace(CFG_T, photo_levels=photo_levels)
    init_j = photo_inputs["poses"][2]
    rj = jax.jit(jicp.track, static_argnums=(3, 4))(
        photo_inputs["live_j"], photo_inputs["mj"], init_j, cfg_j, mode
    )
    rt = ticp.track(photo_inputs["live_t"], photo_inputs["mt"], se3_t(init_j),
                    cfg_t, mode)
    np.testing.assert_allclose(
        rt.pose.translation.numpy(), np.asarray(rj.pose.translation), atol=1e-4
    )
    assert rot_angle(rt.pose.rotation.numpy(), rj.pose.rotation) < 1e-4
    assert bool(rt.valid) == bool(rj.valid)
    np.testing.assert_allclose(rt.level_inliers.numpy(), np.asarray(rj.level_inliers),
                               rtol=5e-3)
    np.testing.assert_allclose(rt.level_degen.numpy(), np.asarray(rj.level_degen),
                               rtol=1e-3)
    for name in ("min_degen", "geo_degen"):
        np.testing.assert_allclose(float(getattr(rt, name)),
                                   float(getattr(rj, name)), rtol=1e-3, err_msg=name)
    if mode == "color":
        assert float(rt.geo_degen) == 1.0
    if mode != "color":
        # The photometric rows moved the pose onto the truth.
        truth = np.asarray(photo_inputs["poses"][3].translation)
        assert np.abs(rt.pose.translation.numpy() - truth).max() < 5e-3


@pytest.fixture(scope="module")
def combined_run():
    """The reference pipeline in combined mode over 4 orbit frames: every
    state, flattened."""
    poses = orbit(4)
    frames = [scene(p) for p in poses]
    pipe = JPipeline(CFG_J, CAM_J, H, W, init_pose=poses[0], mode="combined")
    states = [jflat(pipe.state)]
    for d, c in frames:
        pipe.process(d, c)
        states.append(jflat(pipe.state))
    return frames, states


def test_combined_step_matches_reference(combined_run):
    """Carry the reference's state s_t across, run one port step in
    combined mode, compare with the reference's s_t+1 (the bar of
    test_per_frame_handoff_matches_reference)."""
    frames, states = combined_run
    for i, (d, c) in enumerate(frames):
        ts = tfusion.step(pipeline_state_from_numpy(states[i], CFG_T), t(d), t(c),
                          CFG_T, "combined")
        got, ref = pipeline_state_to_numpy(ts), states[i + 1]
        np.testing.assert_allclose(
            got["model.pose.translation"], ref["model.pose.translation"], atol=1e-4
        )
        assert rot_angle(got["model.pose.rotation"], ref["model.pose.rotation"]) < 1e-4
        for name in ("frame_idx", "track_failures", "track_degen_frames", "photo_cnt"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        assert np.mean(got["model.valid"] != ref["model.valid"]) < 2e-3
        # The luma model render: equal but where a voxel's colour word
        # flipped at a quantization boundary (<= 0.1% of pixels).
        if i > 0:
            assert np.abs(ref["model.color"]).sum() > 0
        assert np.mean(np.abs(got["model.color"] - ref["model.color"]) > 1e-6) < 1e-3
    assert int(states[-1]["track_failures"]) == 0
