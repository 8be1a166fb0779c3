"""The online reconstruction step, depth mode.

Counterpart of ``vulcan_tpu/pipeline/fusion.py`` for the depth-mode slice
under the default renderer: preprocess -> track -> fusion gate ->
allocate + visibility -> integrate -> splat render.  The reference runs
this as one jitted, donated function; here it runs eagerly, with the
volume updated in place.  The host reads the step makes (integrate chunk
count, splat tier lengths, the auto-photo arming check) are counted by
``utils.sync.read_int``.  Each stage runs under a
``torch.profiler.record_function`` range named ``vulcan.<stage>`` so a
profiler trace attributes host and device time per stage.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..config import Config
from ..core import se3
from ..core.camera import PinholeCamera
from ..core.frame import Frame
from ..core.se3 import SE3
from ..ops import allocate, icp, sparse, splat
from ..ops import blocks as B
from ..ops.preprocess import build_pyramid
from ..ops.raycast import Render
from ..utils.sync import read_int

_NOT_PORTED = "is not ported yet (vulcan_tpu_torch carries the depth-mode slice)"


def check_supported(config: Config, mode: str) -> None:
    """Raise for every setting outside the ported slice.  These are loud
    stops, never silent fallbacks to another path."""
    if mode != "depth":
        raise NotImplementedError(
            f"mode={mode!r} {_NOT_PORTED}: only mode='depth'"
        )
    bad = {
        "render_mode": (config.render_mode, "march", "the hierarchical ray march"),
        "splat_source": (config.splat_source, "direct", "the direct splat source"),
        "integrate_gather": (config.integrate_gather, "onehot",
                             "the TPU one-hot patch gather"),
    }
    for name, (value, unsupported, what) in bad.items():
        if value == unsupported:
            raise NotImplementedError(f"{name}={value!r}: {what} {_NOT_PORTED}")
    if config.splat_polish > 0:
        raise NotImplementedError(f"splat_polish={config.splat_polish} {_NOT_PORTED}")
    if config.assoc_patch in ("on", "geom"):
        raise NotImplementedError(
            f"assoc_patch={config.assoc_patch!r}: the TPU one-hot patch "
            f"association {_NOT_PORTED}"
        )
    if config.ablate:
        raise NotImplementedError(f"ablate={config.ablate!r} {_NOT_PORTED}")


@dataclasses.dataclass
class PipelineState:
    """State carried across frames (field for field the reference's).
    The current pose lives in ``model.pose``."""

    volume: B.VolumeState
    model: Render                   # last rendered model maps
    prev_pose: SE3                  # pose of the frame before model.pose's
    frame_idx: torch.Tensor         # () int32
    track_error: torch.Tensor       # () f32, last ICP robust rms
    track_inliers: torch.Tensor     # () int32
    track_failures: torch.Tensor    # () int32, frames held by the gate
    track_level_error: torch.Tensor     # (levels,) f32
    track_level_inliers: torch.Tensor   # (levels,) int32
    track_level_degen: torch.Tensor     # (levels,) f32 observability score
    track_degen_frames: torch.Tensor    # () int32, frames held as degenerate
    photo_cnt: torch.Tensor             # () int32 auto-photo countdown

    @property
    def pose(self) -> SE3:
        return self.model.pose


def init_state(
    config: Config,
    camera: PinholeCamera,
    height: int,
    width: int,
    init_pose: SE3 | None = None,
    device=None,
) -> PipelineState:
    pose = (init_pose or SE3.identity()).to(device)
    levels = config.pyramid_levels

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    empty = Render(
        depth=zeros(height, width),
        vx=zeros(height, width), vy=zeros(height, width), vz=zeros(height, width),
        nx=zeros(height, width), ny=zeros(height, width), nz=zeros(height, width),
        color=zeros(height, width, 3),
        valid=zeros(height, width, dtype=torch.bool),
        camera=camera,
        pose=pose,
    )
    return PipelineState(
        volume=B.create_volume(config, device),
        model=empty,
        prev_pose=pose,
        frame_idx=zeros(dtype=torch.int32),
        track_error=zeros(),
        track_inliers=zeros(dtype=torch.int32),
        track_failures=zeros(dtype=torch.int32),
        track_level_error=zeros(levels),
        track_level_inliers=zeros(levels, dtype=torch.int32),
        track_level_degen=torch.ones(levels, device=device),
        track_degen_frames=zeros(dtype=torch.int32),
        photo_cnt=zeros(dtype=torch.int32),
    )


def predict_pose(state: PipelineState, config: Config) -> SE3:
    """DAMPED constant-velocity tracker init:
    ``exp(a * log(pose @ prev_pose^-1)) @ pose`` with a = motion_prediction
    (a <= 0.5 keeps the tracked-pose feedback stable).  A non-finite twist
    (log of a degenerate delta) falls back to no extrapolation."""
    a = float(config.motion_prediction)
    if a == 0.0:
        return state.pose
    delta = state.pose @ state.prev_pose.inverse()
    if a != 1.0:
        xi = a * delta.log()
        xi = torch.where(torch.all(torch.isfinite(xi)), xi, 0.0)
        delta = SE3.exp(xi)
    return delta @ state.pose


def _to_metric(depth: torch.Tensor, color: torch.Tensor, config: Config):
    """uint16 depth (1/depth_raw_scale m) and uint8 colour -> float32 on
    the device they were uploaded to."""
    if depth.dtype == torch.uint16:
        depth = depth.to(torch.float32) * (1.0 / config.depth_raw_scale)
    if color.dtype == torch.uint8:
        color = color.to(torch.float32) * (1.0 / 255.0)
    return depth, color


def _gate(state: PipelineState, result: icp.TrackResult, config: Config):
    """Fusion gate, degeneracy hold and auto-photo countdown.

    A diverged or starved track is not fused: the previous pose is kept
    and the frame's depth masked to invalid (frame 0, with an empty model,
    bypasses the gate).  A degenerate track keeps its pose but is not
    fused.  Returns (pose, trusted, degenerate, fuse_ok, photo_cnt).
    """
    model_empty = ~torch.any(state.model.valid)
    levels_sane = torch.all(result.level_error < 3.0 * config.icp_max_error)
    trusted = model_empty | (
        result.valid & (result.error < config.icp_max_error) & levels_sane
    )
    pose = se3.where(trusted, result.pose, state.pose)
    degenerate = (
        (~model_empty) & trusted & (result.min_degen < config.degen_min_eig)
    )
    photo_cnt = state.photo_cnt
    if config.auto_photo and config.degen_min_eig > 0.0:
        weak = (~model_empty) & (result.geo_degen < config.auto_photo_enter)
        photo_cnt = torch.where(
            weak,
            torch.full_like(state.photo_cnt, config.auto_photo_hold),
            torch.clamp(state.photo_cnt - 1, min=0),
        )
        # Armed frames render the luma model and track in combined mode:
        # stop before this frame touches the volume.
        if read_int(photo_cnt) > 0:
            raise NotImplementedError(
                "auto-photo armed (geometric conditioning "
                f"< auto_photo_enter={config.auto_photo_enter}): the "
                "combined-mode slice (photometric tracking, luma model "
                f"render) {_NOT_PORTED}"
            )
    return pose, trusted, degenerate, trusted & ~degenerate, photo_cnt


def step(
    state: PipelineState,
    depth: torch.Tensor,
    color: torch.Tensor,
    config: Config,
    mode: str = "depth",
) -> PipelineState:
    """One online frame: track, gate, fuse, render.

    The returned state shares the volume's tensors with ``state``, which
    this call updates in place (see ``ops/sparse.py``).
    """
    check_supported(config, mode)
    depth, color = _to_metric(depth, color, config)
    h, w = depth.shape
    camera = state.model.camera
    frame = Frame(depth, color, camera, state.pose)
    with record_function("vulcan.preprocess"):
        live_pyr = build_pyramid(frame, config)

    # --- track against the previous model ---------------------------------
    with record_function("vulcan.track"):
        model_pyr = icp.model_pyramid(state.model, config.pyramid_levels)
        init_pose = predict_pose(state, config)
        result = icp.track(live_pyr, model_pyr, init_pose, config)

    with record_function("vulcan.gate"):
        pose, trusted, degenerate, fuse_ok, photo_cnt = _gate(
            state, result, config
        )
    fused_depth = torch.where(fuse_ok, depth, 0.0)
    filtered = torch.where(fuse_ok, live_pyr[0].depth, 0.0)

    # --- fuse + render with the tracked pose -------------------------------
    tracked = Frame(fused_depth, color, camera, pose)
    with record_function("vulcan.allocate"):
        volume, band_ids, n_band = allocate.allocate_for_frame(
            state.volume, filtered, camera, pose, config
        )
    with record_function("vulcan.visibility"):
        volume = allocate.update_visibility(volume, camera, pose, h, w, config)
    with record_function("vulcan.integrate"):
        volume = sparse.integrate_sparse(
            volume, tracked, config, ids=band_ids, count=n_band
        )
    with record_function("vulcan.render"):
        render = splat.render_splat(volume, camera, pose, h, w, config)
    return dataclasses.replace(
        state,
        volume=volume,
        model=render,
        prev_pose=state.pose,
        frame_idx=state.frame_idx + 1,
        track_error=result.error,
        track_inliers=result.inliers,
        track_failures=state.track_failures + (~trusted).to(torch.int32),
        track_level_error=result.level_error,
        track_level_inliers=result.level_inliers,
        track_level_degen=result.level_degen,
        track_degen_frames=state.track_degen_frames + degenerate.to(torch.int32),
        photo_cnt=photo_cnt,
    )


def step_seq(
    state: PipelineState,
    depths: torch.Tensor,
    colors: torch.Tensor,
    config: Config,
    mode: str = "depth",
) -> tuple[PipelineState, torch.Tensor]:
    """``step`` over a (k, H, W[,3]) frame sequence, as a Python loop.
    Returns ``(state, translations (k, 3))``."""
    trans = []
    for d, c in zip(depths, colors):
        state = step(state, d, c, config, mode)
        trans.append(state.pose.translation)
    return state, torch.stack(trans)
