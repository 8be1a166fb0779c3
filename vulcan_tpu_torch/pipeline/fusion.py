"""The online reconstruction step.

Counterpart of ``vulcan_tpu/pipeline/fusion.py`` in all four tracking
modes and under either renderer (``Config.render_mode``: the surfel splat
or the hierarchical march): preprocess -> track -> fusion gate ->
allocate + visibility -> integrate -> render, plus
``step_known_pose`` (fusion with a given pose) and ``Config.ablate``.  The
reference runs this as one jitted, donated function.  Here it runs
eagerly, with the volume updated in place, or, at every configuration
``check_supported`` accepts, as one CUDA graph that ``pipeline/api.py``'s
``Pipeline`` captures and replays on the card.  Its data-dependent loops
and branches go through ``utils.sync``: the splat's direct or cached
z-buffer chunks, the render cache's halo chunks, the march's compaction
branch a level and the auto-photo branches, and on the CPU the integrate
chunks and the splat's surfel tiers (on the card kernels I1 and S1 read
those counts on the device).  Eager, their counts and predicates are read on the
host (counted by ``utils.sync.read_int``); captured, they are WHILE and
IF/ELSE nodes on the device values.

Auto-photo (depth mode, ``Config.auto_photo``): a frame whose geometric
conditioning is weak arms combined tracking for ``auto_photo_hold``
frames.  As in the reference, a ``cond`` on the device countdown picks
the track (combined while armed) and one picks the render's colour (the
luma model an armed next frame tracks against).

The step and each of its stages (preprocess, track with the gate,
allocate with the visibility update, integrate, render) run under
``utils.timing.stage``: a ``torch.profiler`` range ``vulcan.<stage>``, which
a profiler trace of the eager step attributes time to (a graph's replay has
no ranges), and, in a ``Pipeline`` built with ``trace=True``, a mark at
entry and exit that the captured graph holds as a kernel node, so that the
spans time every replay (``utils/timing.py``, ``csrc/trace.cu``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..core import se3
from ..core.camera import PinholeCamera
from ..core.frame import Frame
from ..core.se3 import SE3
from ..ops import allocate, icp, raycast, sparse
from ..ops import blocks as B
from ..ops.preprocess import bilateral_filter, build_pyramid
from ..utils import sync
from ..utils.timing import stage

MODES = icp.MODES
_TPU_ONLY = "is a TPU layout that vulcan_tpu_torch does not carry"


def check_supported(config: Config, mode: str = "depth") -> None:
    """Raise for every setting outside the ported code: ValueError for a
    mode that does not exist, NotImplementedError for the reference's TPU
    layouts, which the port does not carry.  Loud stops, never silent
    fallbacks."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    if config.integrate_gather == "onehot":
        raise NotImplementedError(
            f"integrate_gather='onehot': the one-hot patch gather {_TPU_ONLY}")
    if config.assoc_patch in ("on", "geom"):
        raise NotImplementedError(
            f"assoc_patch={config.assoc_patch!r}: the one-hot patch "
            f"association {_TPU_ONLY}"
        )


def _ablated(config: Config) -> set[str]:
    """The stages ``Config.ablate`` skips (comma-separated names)."""
    return set(config.ablate.split(",")) if config.ablate else set()


@dataclasses.dataclass
class PipelineState:
    """State carried across frames, field for field the reference's.  The
    current pose lives in ``model.pose``."""

    volume: B.VolumeState
    model: raycast.Render           # last rendered model maps
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

    empty = raycast.Render(
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


def _gate(state: PipelineState, result: icp.TrackResult, config: Config,
          auto: bool):
    """Fusion gate, degeneracy hold and auto-photo countdown.

    A diverged or starved track is not fused: the previous pose is kept
    and the frame's depth masked to invalid (frame 0, with an empty model,
    bypasses the gate).  A degenerate track keeps its pose but is not
    fused.  Under ``auto`` a weak geometric score re-arms the countdown.
    Returns (pose, trusted, degenerate, fuse_ok, photo_cnt).
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
    if auto:
        weak = (~model_empty) & (result.geo_degen < config.auto_photo_enter)
        photo_cnt = torch.where(
            weak,
            torch.full_like(state.photo_cnt, config.auto_photo_hold),
            torch.clamp(state.photo_cnt - 1, min=0),
        )
    return pose, trusted, degenerate, trusted & ~degenerate, photo_cnt


def _no_track(state: PipelineState, config: Config) -> icp.TrackResult:
    """The ``ablate="track"`` stand-in: the pose held, every gate passed."""
    levels = config.pyramid_levels
    dev = state.photo_cnt.device
    return icp.TrackResult(
        pose=state.pose,
        error=torch.zeros((), device=dev),
        inliers=torch.full((), 10**6, dtype=torch.int32, device=dev),
        valid=torch.ones((), dtype=torch.bool, device=dev),
        level_error=torch.zeros(levels, device=dev),
        level_inliers=torch.full((levels,), 10**6, dtype=torch.int32, device=dev),
        level_degen=torch.ones(levels, device=dev),
        min_degen=torch.ones((), device=dev),
        geo_degen=torch.ones((), device=dev),
    )


def _fuse_and_render(volume: B.VolumeState, frame: Frame, filtered: torch.Tensor,
                     config: Config, h: int, w: int, with_color=True):
    """Allocate, update visibility, integrate and render at ``frame.pose``,
    skipping the stages ``Config.ablate`` names (integration needs the
    allocation's band list).  ``with_color``: a bool, or a 0-d device
    count that renders the colour where it is nonzero (the reference's
    ``lax.cond``; both renders are one ``Render``, the colour a zeros
    plane when off).  Returns (volume, render or None)."""
    skip = _ablated(config)
    band_ids = n_band = None
    with stage("allocate"):
        if "alloc" not in skip:
            volume, band_ids, n_band = allocate.allocate_for_frame(
                volume, filtered, frame.camera, frame.pose, config
            )
        if "vis" not in skip:
            volume = allocate.update_visibility(
                volume, frame.camera, frame.pose, h, w, config
            )
    integrate = "integrate" not in skip and "alloc" not in skip
    render_on = "render" not in skip
    n_host, color_on = None, with_color
    if (integrate and render_on and isinstance(with_color, torch.Tensor)
            and not sync.capturing()):
        # Eager, the chunk count and the colour branch in one transfer
        # (captured, nothing is read).
        n_host, color_on = sync.read_ints(n_band, with_color)
    if integrate:
        with stage("integrate"):
            volume = sparse.integrate_sparse(
                volume, frame, config, ids=band_ids, count=n_band, host_count=n_host
            )
    if not render_on:
        return volume, None
    with stage("render"):
        def render(wc: bool):
            return raycast.render(
                volume, frame.camera, frame.pose, h, w, config,
                with_color=wc, color_space=config.model_color,
            )

        if isinstance(with_color, bool):
            return volume, render(with_color)
        return volume, sync.cond(color_on, lambda: render(True),
                                 lambda: render(False))


@stage("step")
def step(
    state: PipelineState,
    depth: torch.Tensor,
    color: torch.Tensor,
    config: Config,
    mode: str = "depth",
    reduce: icp.Reducer = icp.LOCAL,
) -> PipelineState:
    """One online frame: track, gate, fuse, render.

    The returned state shares the volume's tensors with ``state``, which
    this call updates in place (see ``ops/sparse.py``).  ``reduce`` is the
    track's row split and sum (``icp.Reducer``; ``parallel/sharding.py``
    passes one per rank).
    """
    check_supported(config, mode)
    skip = _ablated(config)
    depth, color = _to_metric(depth, color, config)
    h, w = depth.shape
    camera = state.model.camera
    frame = Frame(depth, color, camera, state.pose)
    # Depth mode's collapse rescue: a weak geometric score arms combined
    # tracking, and the luma model render it needs, for auto_photo_hold
    # frames; armed at frame t, frame t+1 tracks with both terms.
    auto = (
        mode == "depth"
        and config.auto_photo
        and config.degen_min_eig > 0.0
        and "track" not in skip
    )
    with_int = mode != "depth" or auto
    with stage("preprocess"):
        live_pyr = build_pyramid(frame, config, with_intensity=with_int)

    # --- track against the previous model, then the fusion gate ------------
    with stage("track"):
        if "track" in skip:
            result = _no_track(state, config)
        else:
            model_pyr = icp.model_pyramid(
                state.model, config.pyramid_levels,
                with_intensity=with_int,
                # Silhouette erosion scaled so coarse voxels (voxel-size
                # depth steps) do not erode every photometric sample.
                flat_thresh=max(0.05, 6.0 * config.voxel_size),
            )
            init_pose = predict_pose(state, config)

            def track(mode_now: str):
                return icp.track(live_pyr, model_pyr, init_pose, config, mode_now,
                                 reduce)

            if auto:
                # The reference's lax.cond on the device countdown.
                result = sync.cond(state.photo_cnt, lambda: track("combined"),
                                   lambda: track("depth"))
            else:
                result = track(mode)

        pose, trusted, degenerate, fuse_ok, photo_cnt = _gate(
            state, result, config, auto
        )
        fused_depth = torch.where(fuse_ok, depth, 0.0)
        filtered = torch.where(fuse_ok, live_pyr[0].depth, 0.0)

    # --- fuse + render with the tracked pose -------------------------------
    # Depth-only tracking reads no model colour; an armed frame renders it
    # so that the next frame has both sides of the photometric term.
    volume, render = _fuse_and_render(
        state.volume, Frame(fused_depth, color, camera, pose), filtered,
        config, h, w,
        with_color=photo_cnt if auto else (mode != "depth"),
    )
    return dataclasses.replace(
        state,
        volume=volume,
        model=render if render is not None else state.model,
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


@stage("step")
def step_known_pose(
    state: PipelineState,
    depth: torch.Tensor,
    color: torch.Tensor,
    pose: SE3,
    config: Config,
) -> PipelineState:
    """Fusion-only frame with a given camera-to-world pose (ground-truth
    trajectories, evaluation): no tracking, no gate; the model renders
    with colour.  Of the reference's pyramid only the filtered depth is
    read, so only the filter runs."""
    check_supported(config, "depth")
    depth, color = _to_metric(depth, color, config)
    h, w = depth.shape
    frame = Frame(depth, color, state.model.camera, pose)
    with stage("preprocess"):
        filtered = (
            bilateral_filter(depth, config) if config.bilateral_enabled else depth
        )
    volume, render = _fuse_and_render(state.volume, frame, filtered, config, h, w)
    return dataclasses.replace(
        state,
        volume=volume,
        model=render if render is not None else state.model,
        prev_pose=state.pose,
        frame_idx=state.frame_idx + 1,
    )
