"""The online step over several processes with ``torch.distributed``.

The counterpart of ``vulcan_tpu/parallel/sharding.py``, with the same
design:

  * **Images are sharded by rows**: rank r of n holds rows
    [r H / n, (r + 1) H / n) of depth and colour.  The rows are gathered
    where a stage needs the whole image: the replicated volume's allocate,
    integrate and render, and the preprocessing stencils' halos.
  * **The track sums each rank's own rows**: at every pyramid level each
    rank builds the Gauss-Newton rows of its share of the live rows only,
    and the stacked sums (the 29 of every 6x6 system, the 54 of the light
    gain's 9x9) are all-reduced before every solve (``RowSum``, threaded
    through ``icp.track`` as its ``reduce``).
  * **The volume is replicated.**  Every rank integrates the whole image
    into its own copy; the pose update is a function of the all-reduced
    sums, so every rank computes the identical pose, bit for bit, with no
    broadcast, and every host read of the step (``utils.sync.read_int``)
    reads the same value on every rank, so control flow never diverges.
  * **Model maps** are row-sharded in the returned state by the
    reference's rule (``state_sharding``) and gathered at the start of
    the next step, where association needs the whole map.

The all-reduce is an all-gather of each rank's stacked sums, added in rank
order on every rank: the same bits everywhere whatever order the backend
would reduce in.  Collectives go through whatever process group is
initialized; gloo takes CUDA tensors (staging them through host memory
itself), so several ranks can share one card, which NCCL refuses.  One
card gives no scaling number: the ranks share its compute.

``dryrun(n)`` spawns n CPU processes joined by gloo over a ``FileStore``
in a temporary directory (no fixed port) and runs two tiny frames.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..core.camera import PinholeCamera
from ..ops import icp
from ..pipeline import fusion
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group that run one step together."""

    group: object             # torch.distributed process group
    rank: int
    size: int
    device: torch.device

    def bounds(self, n_rows: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of an ``n_rows``-row image."""
        return self.rank * n_rows // self.size, (self.rank + 1) * n_rows // self.size

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds(x.shape[0])
        return x[lo:hi]


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A ``Mesh`` over the initialized process group, every rank computing
    on ``device`` (the CUDA card when None).  ``n_devices``, when given,
    must be the group's size: fewer ranks raise, as more would leave ranks
    out of every collective."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh wraps an initialized torch.distributed process group: "
            "call torch.distributed.init_process_group first (dryrun spawns "
            "its ranks and does)")
    world = dist.get_world_size()
    if n_devices is not None and world != n_devices:
        raise RuntimeError(
            f"make_mesh({n_devices}) found {'only ' if world < n_devices else ''}"
            f"{world} ranks in the process group (backend {dist.get_backend()}); "
            f"start {n_devices} processes, one a rank (see dryrun)")
    return Mesh(dist.group.WORLD, dist.get_rank(), world, resolve_device(device))


class RowSum(icp.Reducer):
    """A rank's share of the track: its own live rows, and the stacked
    sums all-reduced over the mesh (an all-gather, added in rank order)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.rows(x)

    def __call__(self, sums: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(sums) for _ in range(self.mesh.size)]
        dist.all_gather(parts, sums.contiguous(), group=self.mesh.group)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


def gather_rows(mesh: Mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The whole images of row-sharded tensors (each rank's rows of equal
    count), in ONE all-gather: every tensor rides a float64 column block,
    exact for float32, int32 and narrower integers and bool."""
    rows = tensors[0].shape[0]
    cols = [t.reshape(rows, -1).to(torch.float64) for t in tensors]
    block = torch.cat(cols, dim=1).contiguous()
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(parts, block, group=mesh.group)
    whole = torch.cat(parts, dim=0)
    out, k = [], 0
    for t, c in zip(tensors, cols):
        n = c.shape[1]
        out.append(whole[:, k:k + n].reshape(-1, *t.shape[1:]).to(t.dtype))
        k += n
    return out


def _model_leaves(model, prefix="model."):
    """(dotted path, tensor) of the model's tensor fields, nested
    dataclasses (the render pose) included; no copy."""
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _model_leaves(v, f"{prefix}{f.name}.")


def state_sharding(mesh: Mesh, state: fusion.PipelineState) -> set[str]:
    """The dotted paths of the leaves sharded by rows, the model maps
    (H, W, ...): the reference's rule, a model leaf with two or more
    dimensions whose first divides by the mesh size.  Everything else,
    the volume and the scalars, is replicated."""
    return {
        path for path, v in _model_leaves(state.model)
        if v.ndim >= 2 and v.shape[0] % mesh.size == 0
    }


def _map_model(state, spec: set[str], fn):
    """``state`` with ``fn`` applied to the model leaves ``spec`` names."""

    def walk(obj, prefix):
        new = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            path = prefix + f.name
            if isinstance(v, torch.Tensor) and path in spec:
                new[f.name] = fn(path, v)
            elif dataclasses.is_dataclass(v):
                new[f.name] = walk(v, path + ".")
        return dataclasses.replace(obj, **new)

    return dataclasses.replace(state, model=walk(state.model, "model."))


def shard_state(mesh: Mesh, state: fusion.PipelineState,
                spec: set[str] | None = None) -> fusion.PipelineState:
    """This rank's share of a whole state (model maps cut to its rows)."""
    spec = state_sharding(mesh, state) if spec is None else spec
    return _map_model(state, spec, lambda _, v: mesh.rows(v))


def gather_state(mesh: Mesh, state: fusion.PipelineState, spec: set[str],
                 extra: list[torch.Tensor] = ()):
    """The whole state from the ranks' shares (``spec`` as computed on a
    whole state), plus the whole images of ``extra`` row-sharded tensors:
    one all-gather for all of them.  Returns (state, extra_whole)."""
    leaves = dict(_model_leaves(state.model))
    paths = [p for p in leaves if p in spec]
    whole = gather_rows(mesh, [*extra, *(leaves[p] for p in paths)])
    by_path = dict(zip(paths, whole[len(extra):]))
    return _map_model(state, spec, lambda p, _: by_path[p]), whole[:len(extra)]


def make_sharded_step(config: Config, mesh: Mesh, height: int, width: int,
                      mode: str = "depth"):
    """``run(state, depth_rows, color_rows) -> state``: the online step
    with this rank's rows of the frame, on a state whose model maps are
    this rank's rows (``shard_state``)."""
    if height % mesh.size:
        raise ValueError(f"{height} rows do not divide over {mesh.size} ranks")
    fusion.check_supported(config, mode)
    reduce = RowSum(mesh)
    dummy = fusion.init_state(config, PinholeCamera.tum_default(), height, width,
                              device="meta")
    spec = state_sharding(mesh, dummy)

    def run(state, depth_rows, color_rows):
        whole, (depth, color) = gather_state(mesh, state, spec,
                                             [depth_rows, color_rows])
        out = fusion.step(whole, depth, color, config, mode, reduce=reduce)
        return shard_state(mesh, out, spec)

    return run


# ---------------------------------------------------------------------------
# Spawned ranks (CPU processes on gloo, or ranks sharing one card)
# ---------------------------------------------------------------------------

def _rank_main(rank, n, tmp, device, fn, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600))
    try:
        out = fn(make_mesh(n, device=device), *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn, args=(), device="cpu") -> list:
    """Spawn ``n`` processes joined in a gloo group over a ``FileStore`` in
    a temporary directory, call ``fn(mesh, *args)`` in each on ``device``
    and return the results in rank order.  ``fn`` must be importable (a
    module-level function); a rank's exception is raised here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n, tmp, device, fn, args), nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_frames(mesh: Mesh, config: Config, camera: PinholeCamera, frames,
               init_pose=None, mode: str = "depth") -> dict:
    """A rank's run of whole (depth, color) numpy frames through the
    sharded step (each rank uploads its rows).  Returns numpy results:
    the pose and the track's inliers at each pyramid level after each
    frame, each step's ms (host clock, the device synchronized), the host
    reads and kernel launches (K1, K2 and the track's entry points,
    ``track_launches``, as the card counts them: 0 on a CPU rank), the
    final volume's free count
    and the tsdf of its rows below it, and the final model depth and validity
    (gathered).  After the run it times the all-gather that opens each
    step, alone (``gather_ms``: the frame's rows and the model maps) and
    for the frame's rows only (``frame_gather_ms``), medians of 5."""
    import time

    from ..ops import cuda_kernels
    from ..utils.sync import read_int

    track_names = ("icp_associate", "icp_rows", "icp_solve", "icp_rows_solve")
    h, w = frames[0][0].shape
    dev = mesh.device
    step = make_sharded_step(config, mesh, h, w, mode)
    state = shard_state(mesh, fusion.init_state(config, camera, h, w, init_pose, dev))

    def launches():
        if dev.type != "cuda":
            return dict.fromkeys(cuda_kernels.COUNTED, 0)
        return cuda_kernels.launch_counts(dev)

    read_int.count = 0
    before = launches()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rot, trans, level, ms = [], [], [], []
    for d, c in frames:
        t0 = time.perf_counter()
        d_rows = mesh.rows(torch.from_numpy(d)).to(dev)
        c_rows = mesh.rows(torch.from_numpy(c)).to(dev)
        state = step(state, d_rows, c_rows)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        rot.append(state.pose.rotation.cpu().numpy())
        trans.append(state.pose.translation.cpu().numpy())
        level.append(state.track_level_inliers.cpu().numpy())
    reads = read_int.count
    made = {name: n - before[name] for name, n in launches().items()}
    track = {name: made[name] for name in track_names}

    spec = state_sharding(mesh, fusion.init_state(config, camera, h, w, device="meta"))
    gather_ms = {}
    for name, fn in (
        ("gather_ms", lambda: gather_state(mesh, state, spec, [d_rows, c_rows])),
        ("frame_gather_ms", lambda: gather_rows(mesh, [d_rows, c_rows])),
    ):
        times = []
        for _ in range(5):
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        gather_ms[name] = float(np.median(times))
    depth, valid = gather_rows(mesh, [state.model.depth, state.model.valid])
    return dict(
        rotation=np.stack(rot), translation=np.stack(trans),
        level_inliers=np.stack(level), reads=reads, ms=ms, **gather_ms,
        k1_launches=made["bilateral"], k2_launches=made["fill_smooth"], track_launches=track,
        frame=int(state.frame_idx), track_failures=int(state.track_failures),
        free_count=int(state.volume.free_count),
        tsdf=state.volume.tsdf[:int(state.volume.free_count)].cpu().numpy(),
        depth=depth.cpu().numpy(), valid=valid.cpu().numpy(),
        overflow=int(state.volume.alloc_overflow) + int(state.volume.visible_overflow),
    )


def _dryrun_rank(mesh: Mesh, height: int, width: int) -> None:
    from ..config import TINY
    from ..core.se3 import SE3
    from ..io.synthetic import render_sphere_depth

    config = TINY
    camera = PinholeCamera.create(80.0, 80.0, width / 2 - 0.5, height / 2 - 0.5)
    state = shard_state(mesh, fusion.init_state(config, camera, height, width,
                                                device=mesh.device))
    step = make_sharded_step(config, mesh, height, width)
    # A sphere in front of the camera so every stage does real work.
    depth, color = render_sphere_depth(
        camera, SE3.identity(), height, width, (0.0, 0.0, 1.5), 0.5,
        device=mesh.device)
    state = step(state, mesh.rows(depth), mesh.rows(color))
    # The second step tracks against a real model render.
    state = step(state, mesh.rows(depth), mesh.rows(color))
    n_alloc = int(state.volume.free_count) - 1
    if n_alloc <= 0:
        raise RuntimeError("sharded step allocated no blocks")
    if int(state.frame_idx) != 2:
        raise RuntimeError(f"sharded step ran {int(state.frame_idx)} frames, not 2")


def dryrun(n_devices: int, height: int = 64, width: int = 128,
           device="cpu") -> None:
    """Run two tiny frames through the sharded step on ``n_devices``
    spawned ranks (gloo; CPU processes unless ``device`` names the card).

    Raises on any failure; returns None on success.
    """
    if height % n_devices:
        raise ValueError("row count must divide over the ranks")
    run_ranks(n_devices, _dryrun_rank, (height, width), device)
