"""The depth-mode slice (Pipeline.process -> fusion.step) held against the
JAX package on tests/test_pipeline.py's closed-loop orbit."""
import dataclasses

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
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, close_frac, jflat, orbit, scene, se3_t, t,
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
    "override,mode",
    [
        ({}, "combined"),
        ({}, "light"),
        (dict(render_mode="march"), "depth"),
        (dict(splat_source="direct"), "depth"),
        (dict(splat_polish=2), "depth"),
        (dict(integrate_gather="onehot"), "depth"),
        (dict(assoc_patch="on"), "depth"),
        (dict(assoc_patch="geom"), "depth"),
        (dict(ablate="track"), "depth"),
    ],
)
def test_unported_settings_raise(override, mode):
    cfg = dataclasses.replace(CFG_T, **override)
    with pytest.raises(NotImplementedError):
        P.Pipeline(cfg, CAM_T, H, W, mode=mode, device="cpu")


def test_auto_photo_arming_stops_loudly(reference_run):
    """A frame that would arm the combined-mode rescue raises before it
    touches the volume (the combined slice is not ported)."""
    poses, frames, _ = reference_run
    cfg = dataclasses.replace(CFG_T, auto_photo_enter=0.99)
    pipe = P.Pipeline(cfg, CAM_T, H, W, init_pose=se3_t(poses[0]), device="cpu")
    pipe.process(*frames[0])
    free = int(pipe.state.volume.free_count)
    with pytest.raises(NotImplementedError, match="combined-mode"):
        pipe.process(*frames[1])
    assert int(pipe.state.volume.free_count) == free
    with pytest.raises(NotImplementedError, match="step_known_pose"):
        pipe.process(*frames[1], pose=se3_t(poses[1]))
