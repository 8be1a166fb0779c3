"""Carry state between the JAX package and the port as numpy.

Both packages' ``PipelineState``, ``VolumeState``, ``MeshCache``,
``Mesh``, ``RenderCache`` and ``DenseVolumeState`` are trees of
dataclasses with the same field names, so a state
flattens to one dict of numpy arrays keyed by the dotted field path:
``volume.tsdf``, ``model.pose.rotation``, ``model.camera.fx``,
``prev_pose.translation``, ``frame_idx``, ...  (a ``VolumeState`` alone:
``tsdf``, ``hash_codes``, ...).  The tests flatten a JAX state the same
way and start both implementations from identical arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..ops.blocks import VolumeState
from ..ops.dense import DenseVolumeState
from ..ops.mcubes import Mesh, MeshCache
from ..ops.raycast import Render
from ..ops.render_cache import RenderCache
from ..pipeline.fusion import PipelineState


def flatten(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """Dataclass tree -> {dotted path: numpy array}.  Works on any tree of
    dataclasses whose leaves are arrays, tensors or numbers."""
    out: dict[str, np.ndarray] = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, torch.Tensor):
        out[prefix[:-1]] = obj.detach().cpu().numpy()
    elif isinstance(obj, float):
        out[prefix[:-1]] = np.asarray(obj, np.float32)
    else:
        out[prefix[:-1]] = np.asarray(obj)
    return out


def pipeline_state_to_numpy(state: PipelineState) -> dict[str, np.ndarray]:
    return flatten(state)


def _tensor(arrays: dict[str, np.ndarray], key: str, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key], copy=True)).to(device)


def _dataclass_from_numpy(cls, arrays: dict[str, np.ndarray], device, prefix=""):
    return cls(**{f.name: _tensor(arrays, prefix + f.name, device)
                  for f in dataclasses.fields(cls)})


def volume_to_numpy(state: VolumeState) -> dict[str, np.ndarray]:
    """{field name: numpy array} of a volume (the snapshot's arrays)."""
    return flatten(state)


def volume_from_numpy(arrays: dict[str, np.ndarray], device=None) -> VolumeState:
    return _dataclass_from_numpy(VolumeState, arrays, device)


def mesh_cache_to_numpy(cache: MeshCache) -> dict[str, np.ndarray]:
    return flatten(cache)


def mesh_cache_from_numpy(arrays: dict[str, np.ndarray], device=None) -> MeshCache:
    return _dataclass_from_numpy(MeshCache, arrays, device)


def mesh_to_numpy(mesh: Mesh) -> dict[str, np.ndarray]:
    return flatten(mesh)


def render_cache_to_numpy(cache: RenderCache) -> dict[str, np.ndarray]:
    return flatten(cache)


def render_cache_from_numpy(arrays: dict[str, np.ndarray], device=None) -> RenderCache:
    return _dataclass_from_numpy(RenderCache, arrays, device)


def dense_volume_to_numpy(state: DenseVolumeState) -> dict[str, np.ndarray]:
    """{field name: numpy array}; ``shape`` becomes a (3,) array."""
    return flatten(state)


def dense_volume_from_numpy(arrays: dict[str, np.ndarray],
                            device=None) -> DenseVolumeState:
    return DenseVolumeState(
        shape=tuple(int(n) for n in arrays["shape"]),
        **{f.name: _tensor(arrays, f.name, device)
           for f in dataclasses.fields(DenseVolumeState) if f.name != "shape"},
    )


def pipeline_state_from_numpy(
    arrays: dict[str, np.ndarray], config: Config, device=None
) -> PipelineState:
    """Build the port's state from flattened arrays (see module doc)."""

    def t(key):
        return _tensor(arrays, key, device)

    def se3(key):
        return SE3(t(f"{key}.rotation"), t(f"{key}.translation"))

    volume = _dataclass_from_numpy(VolumeState, arrays, device, "volume.")
    expect = (config.num_blocks, config.block_volume)
    if tuple(volume.tsdf.shape) != expect:
        raise ValueError(
            f"volume.tsdf has shape {tuple(volume.tsdf.shape)}, the config "
            f"expects {expect}"
        )
    camera = PinholeCamera.create(
        *(float(arrays[f"model.camera.{k}"]) for k in ("fx", "fy", "cx", "cy"))
    )
    model = Render(
        **{
            f.name: t(f"model.{f.name}")
            for f in dataclasses.fields(Render)
            if f.name not in ("camera", "pose")
        },
        camera=camera,
        pose=se3("model.pose"),
    )
    scalars = {
        f.name: t(f.name)
        for f in dataclasses.fields(PipelineState)
        if f.name not in ("volume", "model", "prev_pose")
    }
    return PipelineState(
        volume=volume, model=model, prev_pose=se3("prev_pose"), **scalars)
