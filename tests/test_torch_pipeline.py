"""The online step (Pipeline.process -> fusion.step) held against the JAX
package on tests/test_pipeline.py's closed-loop orbit: depth mode, the
auto-photo rescue, fusion at given poses (step_known_pose), each
``Config.ablate`` stage, and the guards on the TPU-only layouts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu import Pipeline as JPipeline
from vulcan_tpu.pipeline import fusion as jfusion
from vulcan_tpu.utils.evaluate import ate_rmse as j_ate_rmse
from vulcan_tpu_torch.pipeline import fusion as tfusion
from vulcan_tpu_torch.utils.convert import (
    pipeline_state_from_numpy,
    pipeline_state_to_numpy,
)
from vulcan_tpu_torch.utils.evaluate import ate_rmse

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, close_frac, jflat, orbit, rot_angle, scene,
    se3_t, t,
)

N = 6
VOLUME_INT = ("hash_codes", "hash_values", "free_count", "block_coords",
              "visible_ids", "num_visible", "alloc_overflow", "visible_overflow")
COUNTERS = ("frame_idx", "track_failures", "track_degen_frames", "photo_cnt")


@pytest.fixture(scope="module")
def reference_run():
    """The reference pipeline over N orbit frames: every state, flattened."""
    poses = orbit(N)
    frames = [scene(p) for p in poses]
    pipe = JPipeline(CFG_J, CAM_J, H, W, init_pose=poses[0])
    states = [jflat(pipe.state)]
    for d, c in frames:
        pipe.process(d, c)
        states.append(jflat(pipe.state))
    return poses, frames, states


def _rot_angle(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def test_state_roundtrips_through_numpy(reference_run):
    _, _, states = reference_run
    ts = pipeline_state_from_numpy(states[2], CFG_T)
    back = pipeline_state_to_numpy(ts)
    assert set(back) == set(states[2])
    for k, v in states[2].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_per_frame_handoff_matches_reference(reference_run):
    """(a) Carry the reference's state s_t across, run ONE port step, and
    compare with the reference's s_t+1."""
    poses, frames, states = reference_run
    for i, (d, c) in enumerate(frames):
        ts = pipeline_state_from_numpy(states[i], CFG_T)
        ts = tfusion.step(ts, t(d), t(c), CFG_T)
        got, ref = pipeline_state_to_numpy(ts), states[i + 1]
        # One step's float32 reassociation (FMA fusion in the reference's
        # compiled step, another reduction order here) moves the pose by
        # well under 1e-4 m / 1e-4 rad.
        np.testing.assert_allclose(
            got["model.pose.translation"], ref["model.pose.translation"], atol=1e-4
        )
        assert _rot_angle(got["model.pose.rotation"], ref["model.pose.rotation"]) < 1e-4
        for name in VOLUME_INT:
            np.testing.assert_array_equal(
                got[f"volume.{name}"], ref[f"volume.{name}"], err_msg=f"frame {i} {name}"
            )
        for name in COUNTERS:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(
            got["track_level_inliers"] > 0, ref["track_level_inliers"] > 0
        )
        # TSDF after fusing at poses ~1e-6 m apart: within 1e-4 (mu units).
        # A voxel whose projection sits within an ulp of a pixel boundary
        # samples the neighbouring pixel instead (a float->int rounding
        # flip): at most 0.1% of voxels may differ more.
        assert close_frac(got["volume.tsdf"], ref["volume.tsdf"], 1e-4) <= 1e-3
        # The new model render covers the same pixels (a few silhouette
        # pixels may flip with the sub-micron pose difference).
        assert np.mean(got["model.valid"] != ref["model.valid"]) < 2e-3
    assert int(states[-1]["track_failures"]) == 0


def test_independent_runs_agree(reference_run):
    """(b) Each side runs alone from the same frames; trajectories agree."""
    poses, frames, states = reference_run
    pipe = P.Pipeline(CFG_T, CAM_T, H, W, init_pose=se3_t(poses[0]), device="cpu")
    est = []
    for d, c in frames:
        pipe.process(d, c)
        est.append(pipe.pose.translation.numpy())
    est = np.stack(est)
    ref = np.stack([s["model.pose.translation"] for s in states[1:]])
    gt = np.stack([np.asarray(p.translation) for p in poses])
    np.testing.assert_allclose(est, ref, atol=1e-3)
    ate_t, ate_j = ate_rmse(est, gt), j_ate_rmse(ref, gt)
    assert abs(ate_t - ate_j) < 1e-3
    assert ate_t < 0.01
    diag = pipe.diagnostics()
    assert diag["frame"] == N
    assert diag["track_failures"] == 0
    assert diag["alloc_overflow"] == diag["visible_overflow"] == 0
    assert diag["track_inliers"] > 1000


def test_step_seq_matches_step(reference_run):
    """step_seq is step in a loop, returning each frame's translation."""
    poses, frames, states = reference_run
    depths = torch.stack([t(d) for d, _ in frames[:2]])
    colors = torch.stack([t(c) for _, c in frames[:2]])
    seq_state, trans = tfusion.step_seq(
        pipeline_state_from_numpy(states[0], CFG_T), depths, colors, CFG_T
    )
    state = pipeline_state_from_numpy(states[0], CFG_T)
    for i in range(2):
        state = tfusion.step(state, depths[i], colors[i], CFG_T)
        np.testing.assert_array_equal(trans[i].numpy(), state.pose.translation.numpy())
    a, b = pipeline_state_to_numpy(seq_state), pipeline_state_to_numpy(state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_to_metric_matches_reference():
    rng = np.random.default_rng(6)
    d16 = rng.integers(0, 65535, (H, W)).astype(np.uint16)
    c8 = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    dj, cj = jfusion._to_metric(jnp.asarray(d16), jnp.asarray(c8), CFG_J)
    dt, ct = tfusion._to_metric(torch.from_numpy(d16), torch.from_numpy(c8), CFG_T)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize(
    "override,mode,error",
    [
        pytest.param(dict(integrate_gather="onehot"), "depth", NotImplementedError,
                     id="onehot"),
        pytest.param(dict(assoc_patch="on"), "depth", NotImplementedError,
                     id="patch-on"),
        pytest.param(dict(assoc_patch="geom"), "combined", NotImplementedError,
                     id="patch-geom"),
        pytest.param({}, "stereo", ValueError, id="unknown-mode"),
    ],
)
def test_unported_settings_raise(override, mode, error):
    cfg = dataclasses.replace(CFG_T, **override)
    with pytest.raises(error):
        P.Pipeline(cfg, CAM_T, H, W, mode=mode, device="cpu")


@pytest.fixture(scope="module")
def armed_run():
    """The reference pipeline in depth mode with auto_photo_enter=0.99
    (above this scene's geometric scores, so the rescue arms) over 5
    orbit frames: every state, flattened."""
    cfg = dataclasses.replace(CFG_J, auto_photo_enter=0.99)
    poses = orbit(5)
    frames = [scene(p) for p in poses]
    pipe = JPipeline(cfg, CAM_J, H, W, init_pose=poses[0])
    states = [jflat(pipe.state)]
    for d, c in frames:
        pipe.process(d, c)
        states.append(jflat(pipe.state))
    return poses, frames, states


def test_auto_photo_arming_matches_reference(armed_run):
    """The analogue of tests/test_pipeline.py's arming test: one port step
    from each reference state arms, counts down and tracks as the
    reference does (equal photo_cnt every frame, the handoff bar for the
    pose, the luma model rendered once armed); an independent port run,
    whose conds read the device countdown, gives the same photo_cnt
    sequence."""
    poses, frames, states = armed_run
    cfg = dataclasses.replace(CFG_T, auto_photo_enter=0.99)
    cnt_ref = [int(s["photo_cnt"]) for s in states[1:]]
    assert max(cnt_ref) > 0
    for i, (d, c) in enumerate(frames):
        ts = tfusion.step(pipeline_state_from_numpy(states[i], cfg), t(d), t(c), cfg)
        got, ref = pipeline_state_to_numpy(ts), states[i + 1]
        assert int(got["photo_cnt"]) == cnt_ref[i]
        np.testing.assert_allclose(
            got["model.pose.translation"], ref["model.pose.translation"], atol=1e-4
        )
        assert rot_angle(got["model.pose.rotation"], ref["model.pose.rotation"]) < 1e-4
        for name in COUNTERS:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        # Armed frames render the luma model for the next frame's track.
        assert (np.abs(got["model.color"]).sum() > 0) == (cnt_ref[i] > 0)
        assert np.mean(np.abs(got["model.color"] - ref["model.color"]) > 1e-6) < 2e-3
    pipe = P.Pipeline(cfg, CAM_T, H, W, init_pose=se3_t(poses[0]), device="cpu")
    cnt = []
    for d, c in frames:
        pipe.process(d, c)
        cnt.append(pipe.diagnostics()["photo_armed_frames"])
    assert cnt == cnt_ref
    assert pipe.diagnostics()["track_failures"] == 0


def test_known_pose_fusion_matches_reference():
    """``process(pose=...)`` (step_known_pose) over 4 frames at the true
    poses: the integer volume arrays and the weights equal the
    reference's; the packed colour and surfel words too, but where the
    reference's compiled integrate fused an FMA at a quantization boundary
    (1 and 12 of ~4M words: at most 1e-5 of them); the TSDF to 1e-6; the
    pose is the given one."""
    poses = orbit(4)
    frames = [scene(p) for p in poses]
    jpipe = JPipeline(CFG_J, CAM_J, H, W, init_pose=poses[0])
    tpipe = P.Pipeline(CFG_T, CAM_T, H, W, init_pose=se3_t(poses[0]), device="cpu")
    for pose, (d, c) in zip(poses, frames):
        jpipe.process(d, c, pose=pose)
        tpipe.process(d, c, pose=se3_t(pose))
    ref, got = jflat(jpipe.state), pipeline_state_to_numpy(tpipe.state)
    assert set(got) == set(ref)
    for name in VOLUME_INT + ("surf_count", "surf_overflow", "weight", "mesh_dirty"):
        np.testing.assert_array_equal(got[f"volume.{name}"], ref[f"volume.{name}"],
                                      err_msg=name)
    for name in ("colorpack", "surfpack"):
        assert np.mean(got[f"volume.{name}"] != ref[f"volume.{name}"]) <= 1e-5, name
    np.testing.assert_allclose(got["volume.tsdf"], ref["volume.tsdf"], rtol=0, atol=1e-6)
    assert int(got["frame_idx"]) == 4 and int(got["volume.free_count"]) > 100
    np.testing.assert_array_equal(got["model.pose.translation"],
                                  np.asarray(poses[-1].translation))
    # The model renders with (luma) colour.
    assert np.abs(got["model.color"]).sum() > 0
    assert np.mean(got["model.valid"] != ref["model.valid"]) < 2e-3
    assert np.mean(np.abs(got["model.color"] - ref["model.color"]) > 1e-6) < 2e-3


@pytest.fixture(scope="module")
def two_frame_state():
    """The reference's state after two orbit frames (depth mode), and the
    third frame."""
    poses = orbit(3)
    frames = [scene(p) for p in poses]
    pipe = JPipeline(CFG_J, CAM_J, H, W, init_pose=poses[0])
    for d, c in frames[:2]:
        pipe.process(d, c)
    return pipe.state, frames[2]


@pytest.mark.parametrize("stage", ["track", "alloc", "vis", "integrate", "render"])
def test_ablate_stage_matches_reference(two_frame_state, stage):
    """``Config(ablate=stage)``: one step skips the stage as the
    reference's does (the same volume arrays, counters, pose and model)."""
    base, (d, c) = two_frame_state
    cfg_j = dataclasses.replace(CFG_J, ablate=stage)
    cfg_t = dataclasses.replace(CFG_T, ablate=stage)
    before = jflat(base)
    copy = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), base)
    ref = jflat(jfusion.step(copy, jnp.asarray(d), jnp.asarray(c), cfg_j))
    ts = tfusion.step(pipeline_state_from_numpy(before, cfg_t), t(d), t(c), cfg_t)
    got = pipeline_state_to_numpy(ts)
    np.testing.assert_allclose(got["model.pose.translation"],
                               ref["model.pose.translation"], atol=1e-4)
    assert rot_angle(got["model.pose.rotation"], ref["model.pose.rotation"]) < 1e-4
    for name in VOLUME_INT:
        np.testing.assert_array_equal(got[f"volume.{name}"], ref[f"volume.{name}"],
                                      err_msg=name)
    for name in COUNTERS + ("track_inliers",):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    assert close_frac(got["volume.tsdf"], ref["volume.tsdf"], 1e-4) <= 1e-3
    assert np.mean(got["model.valid"] != ref["model.valid"]) < 2e-3
    skipped = {
        "track": ("model.pose.translation", True),   # the pose is held
        "alloc": ("volume.free_count", True),        # nothing allocated
        "vis": ("volume.visible_ids", True),         # the old visible list
        "integrate": ("volume.tsdf", True),          # nothing fused
        "render": ("model.depth", True),             # the old model
    }[stage]
    np.testing.assert_array_equal(got[skipped[0]], before[skipped[0]])
