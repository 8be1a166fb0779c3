"""The integrate layer's plain version on the CPU (``ops/sparse.py``
``_integrate_plain``, kernel I1's yardstick on the card): one chunk of the
whole list against the chunk loop, the CPU's dispatch, and the surfel
overflow and mesh-dirty gate held against the JAX package.  Kernel I1
itself runs on the card only (``tests/test_torch_cuda_integrate.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import sparse as jsp
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import sparse as tsp
from vulcan_tpu_torch.utils import sync

from ._torch_port import CAM_J, CAM_T, CFG_J, CFG_T, jflat, no_kernel, orbit, scene, se3_t, t

OUTPUTS = ("tsdf", "weight", "colorpack", "surfpack", "surf_count", "mesh_dirty",
           "surf_overflow")


def _band_volume(cfg, frames=2):
    """The port's volume after ``frames - 1`` fused frames and the
    allocation of the next, with that frame and its band list."""
    vol = tB.create_volume(cfg)
    for k, pose in enumerate(orbit(frames)):
        d, c = scene(pose)
        frame = Frame(t(d), t(c), CAM_T, se3_t(pose))
        vol, band, n_band = tal.allocate_for_frame(vol, frame.depth, CAM_T, frame.pose, cfg)
        if k < frames - 1:
            vol = tsp.integrate_sparse(vol, frame, cfg, ids=band, count=n_band)
    return vol, frame, band, n_band


def _copy(vol):
    return dataclasses.replace(vol, **{f.name: getattr(vol, f.name).clone()
                                       for f in dataclasses.fields(vol)})


def _assert_same(a, b, what):
    for name in OUTPUTS:
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)


@pytest.mark.parametrize("chunk", [64, 1024])
def test_one_chunk_of_the_whole_list_equals_the_chunk_loop(chunk):
    """One chunk as long as the list's capacity (I1's one launch) gives the
    chunk loop's volume bit for bit on a list of unique ids: chunking
    changes no result."""
    cfg = dataclasses.replace(CFG_T, alloc_capacity=2048)
    vol, frame, band, n_band = _band_volume(cfg)
    assert 0 < int(n_band) < cfg.alloc_capacity
    ids = band[band > 0]
    assert ids.unique().numel() == ids.numel()
    whole = tsp.integrate_sparse(_copy(vol), frame,
                                 dataclasses.replace(cfg, integrate_chunk=cfg.alloc_capacity),
                                 ids=band, count=n_band)
    chunked = tsp.integrate_sparse(_copy(vol), frame,
                                   dataclasses.replace(cfg, integrate_chunk=chunk),
                                   ids=band, count=n_band)
    _assert_same(whole, chunked, chunk)
    assert int(whole.surf_count.sum()) > 0


def test_cpu_volume_takes_the_plain_version(no_kernel):
    """A CPU volume runs the chunk loop (its bodies counted) and never
    reaches a kernel."""
    vol, frame, band, n_band = _band_volume(CFG_T)
    before = sync.chunk_loop.count
    got = tsp.integrate_sparse(_copy(vol), frame, CFG_T, ids=band, count=n_band)
    assert sync.chunk_loop.count - before == -(-int(n_band) // CFG_T.integrate_chunk)
    want = tsp._integrate_plain(_copy(vol), frame, CFG_T, band, n_band)
    _assert_same(got, want, "cpu")


def test_i1_scalars_round_as_the_plain_version():
    """I1's scalars are the plain version's Python floats, and its
    reciprocal of mu the float64 one, which PyTorch's CUDA division by a
    Python float rounds to float32 and multiplies by: at this config's mu
    0.06 that differs from the float32 division of 1 by mu."""
    s = tsp.i1_scalars(CFG_T)
    f32 = np.float32
    assert f32(s.inv_mu) == f32(1.0 / CFG_T.trunc_dist)
    assert f32(s.inv_mu) != f32(1.0) / f32(CFG_T.trunc_dist)
    assert f32(s.mu) == f32(CFG_T.trunc_dist)
    assert f32(s.depth_scale) == f32(1.0 / CFG_T.depth_raw_scale)
    assert f32(s.half_band) == f32(0.5 * tB.surfel_band(CFG_T))
    assert s.gate and not tsp.i1_scalars(dataclasses.replace(CFG_T, mesh_dirty_eps=0.0)).gate


# The surfel overflow (16 slots: every band block of a surface sheds outer
# voxels), the dirty gate off (every fused block marked) and a coarse gate.
GATES = {
    "overflow": dict(surfel_slots=16),
    "dirty_eps_0": dict(mesh_dirty_eps=0.0),
    "dirty_eps_coarse": dict(mesh_dirty_eps=0.05),
}


@pytest.mark.parametrize("case", list(GATES))
def test_plain_surfels_and_dirty_gate_match_reference(case):
    """Two frames fused by the plain version against the reference under
    each setting: surfel counts, the overflow gauge, the dirty flags and the
    weights exact; the surfel words within the 14-bit tsdf quantum on at
    most 0.1% of slots, as ``test_integrate_sparse_matches_reference``."""
    cfg_t = dataclasses.replace(CFG_T, **GATES[case])
    cfg_j = dataclasses.replace(CFG_J, **GATES[case])
    jv, tv = jB.create_volume(cfg_j), tB.create_volume(cfg_t)
    for pose in orbit(3)[1:]:
        d, c = scene(pose)
        jframe = make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
        jv, band, n_band = jal.allocate_for_frame(jv, jframe.depth, CAM_J, pose, cfg_j)
        jv = dataclasses.replace(jv, mesh_dirty=jnp.zeros_like(jv.mesh_dirty))
        jv = jsp.integrate_sparse(jv, jframe, cfg_j, ids=band, count=n_band)
        tframe = Frame(t(d), t(c), CAM_T, se3_t(pose))
        tv, tband, tn = tal.allocate_for_frame(tv, tframe.depth, CAM_T, tframe.pose, cfg_t)
        tv.mesh_dirty.zero_()
        tv = tsp.integrate_sparse(tv, tframe, cfg_t, ids=tband, count=tn)
    ref = jflat(jv)
    for name in ("weight", "surf_count", "mesh_dirty", "surf_overflow"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(), ref[name], err_msg=name)
    diff = tv.surfpack.numpy().astype(np.int64) - ref["surfpack"]
    assert np.mean(diff != 0) <= 1e-3
    assert set(np.unique(np.abs(diff))) <= {0, 1 << 10}
    if case == "overflow":
        assert int(tv.surf_overflow) > 0
    if case == "dirty_eps_0":
        assert int(tv.mesh_dirty.sum()) == int((tband > 0).sum())
