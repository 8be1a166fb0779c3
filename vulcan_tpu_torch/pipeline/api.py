"""Public five-class API: ``Volume``, ``Integrator``, ``Tracer``,
``Tracker`` (``DepthTracker``, ``ColorTracker``, ``LightTracker``) and
``Extractor``, plus the online ``Pipeline`` driver.

Counterpart of ``vulcan_tpu/pipeline/api.py``: thin object wrappers over
the functional ops.  Every class runs on ``device``: the CUDA card when
None (raising without one), the CPU with ``device="cpu"``.  Snapshots
(``Volume.save`` / ``load``) are the reference's format v4, byte for byte:
one ``.npz`` with each ``VolumeState`` field under its name plus
``__snapshot_version__``, so either package loads the other's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import Frame
from ..core.se3 import SE3
from ..io.ply import write_ply
from ..ops import allocate as _allocate
from ..ops import blocks as B
from ..ops import icp as _icp
from ..ops import mcubes as _mcubes
from ..ops import raycast as _raycast
from ..ops import sparse as _sparse
from ..ops.preprocess import build_pyramid
from ..utils import timing
from ..utils.device import resolve_device
from . import fusion
from .graphs import StepGraphs


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:       # torch tensors cannot wrap read-only memory
        x = x.copy()
    return torch.from_numpy(x).to(device)


def _frame_on(frame: Frame, device: torch.device) -> Frame:
    return dataclasses.replace(frame, depth=frame.depth.to(device),
                               color=frame.color.to(device),
                               pose=frame.pose.to(device))


def _export_ply(mesh: _mcubes.Mesh, path: str, weld: bool = True) -> int:
    count = int(mesh.count)
    write_ply(path, mesh.positions[:count].cpu().numpy(),
              mesh.colors[:count].cpu().numpy(), weld=weld)
    return count


class Volume:
    """Sparse voxel-block TSDF volume: voxel storage, hash table and
    visible list.  Geometry settings are constructor-time config; the
    setters refuse a volume that already holds fused data."""

    _SNAPSHOT_VERSION = 4  # v2: named per-field keys (packed int32 colour);
                           # v3: persistent surfel lists; v4: mesh dirty flags

    def __init__(self, config: Config = Config(), device=None):
        fusion.check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.state = B.create_volume(config, self.device)
        self.band = None  # (band_ids, n_band) of the last allocated frame

    # -- setters mirrored from the reference API --
    def _assert_empty(self, what: str) -> None:
        # Geometry constants are baked into fused TSDF values; changing them
        # under fused state would silently reinterpret every voxel.
        if int(self.state.free_count) > 1:
            raise RuntimeError(
                f"cannot change {what} on a volume with fused data "
                f"({self.num_allocated} blocks allocated); create a new "
                "Volume with the desired config instead"
            )

    def set_truncation_length(self, mu: float) -> "Volume":
        self._assert_empty("truncation length")
        self.config = dataclasses.replace(self.config, trunc_dist=float(mu))
        return self

    def set_voxel_size(self, vs: float) -> "Volume":
        self._assert_empty("voxel size")
        self.config = dataclasses.replace(self.config, voxel_size=float(vs))
        return self

    @property
    def num_allocated(self) -> int:
        return int(self.state.free_count) - 1

    @property
    def num_visible(self) -> int:
        return int(self.state.num_visible)

    def allocate(self, frame: Frame) -> None:
        """Allocate the blocks in the frame's truncation band and update
        the visible list.  The band list is kept on ``self.band``."""
        frame = _frame_on(frame, self.device)
        h, w = frame.depth.shape
        self.state, band_ids, n_band = _allocate.allocate_for_frame(
            self.state, frame.depth, frame.camera, frame.pose, self.config
        )
        self.band = (band_ids, n_band)
        self.state = _allocate.update_visibility(
            self.state, frame.camera, frame.pose, h, w, self.config
        )

    def update_visibility(self, camera: PinholeCamera, pose: SE3, height: int,
                          width: int) -> None:
        self.state = _allocate.update_visibility(
            self.state, camera, pose.to(self.device), height, width, self.config
        )

    def visible_blocks(self):
        """(block_ids (N,), block_coords (N, 3)) numpy arrays of the
        current visible set."""
        n = int(self.state.num_visible)
        ids = self.state.visible_ids[:n]
        return ids.cpu().numpy(), self.state.block_coords[ids.long()].cpu().numpy()

    def validate(self) -> dict:
        """Consistency pass over the hash table, the block counts and the
        persistent surfel lists.  Returns a dict of findings; all zero
        means healthy."""
        st = self.state
        codes = st.hash_codes.cpu().numpy()
        values = st.hash_values.cpu().numpy()
        free = int(st.free_count)
        occupied = codes != B.INVALID_CODE
        report = {
            "hash_entries": int(occupied.sum()),
            "allocated_blocks": free - 1,
            # every occupied slot must map to a valid block index
            "bad_values": int(
                ((values[occupied] < 1) | (values[occupied] >= free)).sum()
            ),
            # block indices must be unique across the table
            "duplicate_values": int(
                len(values[occupied]) - len(np.unique(values[occupied]))
            ),
            # one hash entry per allocated block
            "count_mismatch": int(occupied.sum() != free - 1),
            "alloc_overflow": int(st.alloc_overflow),
            "visible_overflow": int(st.visible_overflow),
        }
        # The persistent surfel lists must mirror the TSDF they were packed
        # from (a mismatch means a block changed outside integration).
        surf, count, _ = B.pack_surfels(
            st.tsdf, st.weight, B.surfel_band(self.config), self.config.surfel_slots
        )
        report["surfel_mismatch"] = int((surf != st.surfpack).sum())
        report["surfel_count_mismatch"] = int((count != st.surf_count).sum())
        return report

    # -- persistence --
    def save(self, path: str) -> None:
        """Snapshot the whole volume state to one .npz file (format v4)."""
        arrays = {
            f.name: getattr(self.state, f.name).cpu().numpy()
            for f in dataclasses.fields(self.state)
        }
        arrays["__snapshot_version__"] = np.asarray(self._SNAPSHOT_VERSION)
        np.savez_compressed(path, **arrays)

    def load(self, path: str) -> None:
        """Load a v4 snapshot onto this volume's device.  Refuses legacy
        positional snapshots, other versions (v3 included, as the
        reference does), missing fields and other dtypes or shapes."""
        data = np.load(path)
        if "__snapshot_version__" not in data:
            raise ValueError(
                f"{path} is a legacy positional snapshot (no version key); "
                "it predates the packed-color volume layout and cannot be "
                "loaded safely -- re-run the reconstruction to regenerate it"
            )
        version = int(data["__snapshot_version__"])
        if version != self._SNAPSHOT_VERSION:
            raise ValueError(
                f"{path}: snapshot format v{version} does not match this "
                f"build's v{self._SNAPSHOT_VERSION}"
            )
        new_state = {}
        for f in dataclasses.fields(self.state):
            cur = getattr(self.state, f.name)
            want = torch.empty((), dtype=cur.dtype).numpy().dtype
            if f.name not in data:
                raise ValueError(f"{path}: snapshot is missing '{f.name}'")
            arr = data[f.name]
            if arr.dtype != want:
                raise ValueError(
                    f"{path}: '{f.name}' has dtype {arr.dtype}, expected {want}"
                )
            if arr.shape != tuple(cur.shape):
                raise ValueError(
                    f"{path}: '{f.name}' has shape {arr.shape}, expected "
                    f"{tuple(cur.shape)} (snapshot config differs: check "
                    "num_blocks/hash_size/max_visible)"
                )
            new_state[f.name] = torch.from_numpy(np.array(arr)).to(self.device)
        self.state = dataclasses.replace(self.state, **new_state)


class Integrator:
    """Depth + colour TSDF fusion into a ``Volume``."""

    def __init__(self, volume: Volume):
        self.volume = volume

    def integrate(self, frame: Frame) -> None:
        """Allocate, update visibility, and fuse one posed frame."""
        frame = _frame_on(frame, self.volume.device)
        self.volume.allocate(frame)
        self.volume.state = _sparse.integrate_sparse(
            self.volume.state, frame, self.volume.config
        )


class Tracer:
    """Model renderer of a ``Volume``: the renderer ``Config.render_mode``
    names (the surfel splat or the hierarchical march), with cross-product
    or TSDF-gradient (``normals="gradient"``) normals."""

    def __init__(self, volume: Volume):
        self.volume = volume

    def trace(
        self,
        camera: PinholeCamera,
        pose: SE3,
        height: int,
        width: int,
        update_visibility: bool = True,
        normals: str = "cross",
    ) -> _raycast.Render:
        pose = pose.to(self.volume.device)
        if update_visibility:
            self.volume.update_visibility(camera, pose, height, width)
        return _raycast.render(
            self.volume.state, camera, pose, height, width,
            self.volume.config, normals,
        )


class Tracker:
    """Frame-to-model tracking.  ``mode``: depth | color | combined | light
    (``light`` refits a spherical-harmonics illumination gain every
    round; ``ops/light.py``)."""

    def __init__(self, config: Config = Config(), mode: str = "depth", device=None):
        fusion.check_supported(config, mode)
        self.config = config
        self.mode = mode
        self.device = resolve_device(device)

    def track(
        self,
        model: _raycast.Render,
        live_frame: Frame,
        init_pose: SE3 | None = None,
    ) -> _icp.TrackResult:
        init = (init_pose if init_pose is not None else model.pose).to(self.device)
        photo = self.mode != "depth"
        live_pyr = build_pyramid(_frame_on(live_frame, self.device), self.config,
                                 with_intensity=photo)
        model_pyr = _icp.model_pyramid(model, self.config.pyramid_levels,
                                       with_intensity=photo)
        return _icp.track(live_pyr, model_pyr, init, self.config, self.mode)


class DepthTracker(Tracker):
    """Geometric point-to-plane ICP."""

    def __init__(self, config: Config = Config(), device=None):
        super().__init__(config, mode="depth", device=device)


class ColorTracker(Tracker):
    """Photometric tracking; in practice use ``mode="combined"`` through
    the base class -- pure photometric tracking has no depth term to
    anchor scale-degenerate motion."""

    def __init__(self, config: Config = Config(), device=None):
        super().__init__(config, mode="color", device=device)


class LightTracker(Tracker):
    """Combined tracking with a per-frame SH illumination-gain estimate."""

    def __init__(self, config: Config = Config(), device=None):
        super().__init__(config, mode="light", device=device)


class Extractor:
    """Coloured marching-cubes mesher of a ``Volume``."""

    def __init__(self, volume: Volume):
        self.volume = volume

    def extract(self) -> _mcubes.Mesh:
        return _mcubes.extract_mesh(self.volume.state, self.volume.config)

    def export_ply(self, path: str, weld: bool = True) -> int:
        """Extract and write a PLY; returns the triangle count."""
        return _export_ply(self.extract(), path, weld)


class Pipeline:
    """Full online loop: track + fuse + render per frame on ``device``
    (the CUDA card when None; ``device="cpu"`` runs the plain versions).
    ``mode`` is the tracking mode: "depth", "color", "combined" or
    "light".

    On the card, at every configuration ``fusion.check_supported``
    accepts (every renderer and mode), each kind of frame (tracked, known
    pose) runs as a captured CUDA graph after two eager warm-up frames
    (``graphs.StepGraphs``): a frame is then one replay with no host read.
    ``captured`` says which path the pipeline takes, ``graph_stats`` what
    each capture cost.  The state's tensors are then the graph's buffers,
    which the next frame overwrites: ``pose`` and ``diagnostics()`` hand
    out copies; clone whatever else of ``state`` you keep.  Whatever
    replaces a part of ``state`` between frames (a snapshot's volume, a
    re-meshed volume) is copied into the buffers before the next replay.
    On the CPU every frame runs the eager step.  A capture that fails
    raises; nothing on the card falls back to the eager step.

    ``trace=True`` records every frame's spans in memory until
    ``trace_spans`` reads them: the step's stages on the device, from
    marks that the captured graph holds (``utils/timing.py``), and the
    host's part of ``process``.  Off (the default), the graph holds no
    mark.
    """

    def __init__(
        self,
        config: Config,
        camera: PinholeCamera,
        height: int,
        width: int,
        init_pose: SE3 | None = None,
        mode: str = "depth",
        device=None,
        trace: bool = False,
    ):
        fusion.check_supported(config, mode)
        self.config = config
        self.height = height
        self.width = width
        self.mode = mode
        self.device = resolve_device(device)
        self.state = fusion.init_state(
            config, camera, height, width, init_pose, self.device
        )
        self.captured = self.device.type == "cuda"
        self._graphs = StepGraphs(self.device) if self.captured else None
        self._tracer = timing.SpanTracer(self.device) if trace else None

    @property
    def graph_stats(self) -> dict:
        """Per captured kind of frame: capture ms, memory pool MiB, replays
        (empty before a capture and on the eager path)."""
        return {} if self._graphs is None else dict(self._graphs.stats)

    def _tracked(self, state, depth, color):
        return fusion.step(state, depth, color, self.config, self.mode)

    def _known_pose(self, state, depth, color, pose):
        return fusion.step_known_pose(state, depth, color, pose, self.config)

    def process(self, depth, color=None, pose: SE3 | None = None) -> None:
        """Feed one frame (numpy arrays or tensors).  With ``pose`` given
        (camera-to-world), fuse at that pose without tracking.  uint16
        depth (TUM raw units) and uint8 colour are uploaded as they are and
        converted on the device; other dtypes are converted to float32."""
        if self._tracer is not None:
            self._process_traced(depth, color, pose)
            return
        self._launch(*self._upload(depth, color, pose))

    def _upload(self, depth, color, pose):
        """The frame on the device: (the step to run, its arguments)."""
        depth = _as_tensor(depth, self.device)
        if depth.dtype not in (torch.uint16, torch.float32):
            depth = depth.to(torch.float32)
        if color is None:
            color = torch.zeros(depth.shape + (3,), device=self.device)
        color = _as_tensor(color, self.device)
        if color.dtype not in (torch.uint8, torch.float32):
            color = color.to(torch.float32)
        args = (depth, color) if pose is None else (depth, color, pose.to(self.device))
        return (self._tracked if pose is None else self._known_pose), args

    def _launch(self, step, args) -> None:
        """The step, eagerly or as its captured graph."""
        if self._graphs is None:
            self.state = step(self.state, *args)
        else:
            depth, color = args[:2]
            key = f"{step.__name__.lstrip('_')} {depth.dtype} {color.dtype}"
            self.state = self._graphs.run(key, step, self.state, *args)

    def _process_traced(self, depth, color, pose) -> None:
        """``process`` with its host spans (``timing.HOST_SPANS``) and the
        step's marks."""
        t0 = timing.host_ns()
        step, args = self._upload(depth, color, pose)
        t1 = timing.host_ns()
        with timing.tracing(self._tracer):
            self._launch(step, args)
        t2 = timing.host_ns()
        self._tracer.record_host((t0, timing.host_ns()), (t0, t1), (t1, t2))

    def trace_spans(self, first: int, stop: int) -> dict | None:
        """The spans of frames ``first`` to ``stop`` - 1 (the pipeline's
        first frame is 0), all on the host clock that ``torch.profiler``
        stamps its events with (``timing.host_ns``): the step's on the
        device (``step`` and, inside it, ``preprocess``, ``track`` (with
        the gate; none with a given pose), ``allocate``, ``integrate``,
        ``render``) and ``process``'s on the host (``upload``, ``launch``),
        as ``{"spans": [(frame, name, parent, start ns, end ns), ...],
        "error_ns", "drift_ns", "interval_s"}``: the clock calibration's
        half-width and its drift since tracing began (``timing.SpanTracer.
        spans``).  None where the ring (``timing.RING_FRAMES`` frames) no
        longer, or not yet, holds every frame of the window.  Copies the ring
        to the host once and waits for the card."""
        if self._tracer is None:
            raise RuntimeError("trace_spans: this Pipeline was built with trace=False")
        return self._tracer.spans(first, stop)

    @property
    def pose(self) -> SE3:
        """The current camera-to-world pose, as a copy: on the captured
        path the state's tensors are the graph's buffers, which the next
        frame overwrites in place, so a pose kept across frames must not
        be one of them."""
        p = self.state.pose
        return SE3(p.rotation.clone(), p.translation.clone())

    def diagnostics(self) -> dict:
        s = self.state
        return {
            "frame": int(s.frame_idx),
            "track_error": float(s.track_error),
            "track_inliers": int(s.track_inliers),
            "track_failures": int(s.track_failures),
            "track_level_error": [round(float(x), 6) for x in s.track_level_error],
            "track_level_inliers": [int(x) for x in s.track_level_inliers],
            "track_level_degen": [round(float(x), 6) for x in s.track_level_degen],
            "track_degen_frames": int(s.track_degen_frames),
            "photo_armed_frames": int(s.photo_cnt),
            "allocated_blocks": int(s.volume.free_count) - 1,
            "visible_blocks": int(s.volume.num_visible),
            "alloc_overflow": int(s.volume.alloc_overflow),
            "visible_overflow": int(s.volume.visible_overflow),
        }

    def extract_mesh(self) -> _mcubes.Mesh:
        return _mcubes.extract_mesh(self.state.volume, self.config)

    def export_ply(self, path: str) -> int:
        """Extract and write a welded PLY; returns the triangle count."""
        return _export_ply(self.extract_mesh(), path)
