"""The step's capture form on the CPU: the loops that run to a static bound
with every chunk an IF node (``utils.sync.run_if``), held against the JAX
package and against the port's eager form, the eager ``cond``, the host
reads a frame, and the state-buffer helpers of ``pipeline/graphs.py``.

A CUDA graph cannot be captured here.  ``sync.capturing`` is forced true
and the IF node replaced by a stand-in: ``skip`` runs a chunk where its
predicate holds (what a replay does), ``all`` runs every chunk up to the
bound (what the masks alone must make harmless: a chunk past the count
writes its rows' old values and scatters into the trash slot)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import sparse as jsp
from vulcan_tpu.ops import splat as jsplat
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.core.se3 import SE3
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import sparse as tsp
from vulcan_tpu_torch.ops import splat as tsplat
from vulcan_tpu_torch.pipeline import fusion, graphs
from vulcan_tpu_torch.utils import sync

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, fused_orbit_volumes, jflat, orbit, scene,
    se3_t, t,
)

STAND_INS = {
    "skip": lambda pred, fn: fn() if bool(pred) else None,
    "all": lambda pred, fn: fn(),
}


@pytest.fixture(params=sorted(STAND_INS))
def captured(request, monkeypatch):
    """``sync.capturing()`` true, IF nodes replaced by a stand-in."""
    monkeypatch.setattr(sync, "capturing", lambda: True)
    monkeypatch.setattr(sync, "_if_node", STAND_INS[request.param])
    return request.param


@pytest.fixture(scope="module")
def band_frame():
    """The reference's volume after allocation and visibility of orbit
    frame 1, with the frame and its band list (the integrate inputs)."""
    pose = orbit(2)[1]
    d, c = scene(pose)
    frame = make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
    jv = jB.create_volume(CFG_J)
    jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
    jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
    return jv, frame, np.asarray(band), int(n_band), d, c, pose


# Work counts: none, one partial chunk of 64, an exact multiple of 64 (two
# chunks), the frame's own count, and the list's whole capacity (entries
# past the band are block 0, masked by ``ids > 0``).
COUNTS = ("zero", "partial", "multiple", "band", "capacity")


def _count(name: str, n_band: int, capacity: int) -> int:
    return {"zero": 0, "partial": 37, "multiple": 128, "band": n_band,
            "capacity": capacity}[name]


@pytest.mark.parametrize("which", COUNTS)
def test_integrate_upper_bound_form_matches_reference(band_frame, captured, which):
    """The capture form of the integrate loop (alloc_capacity / 64 = 128
    chunks at ``integrate_chunk=64``, every one an IF node on
    ``start < count``) fuses what the reference's while_loop fuses, at the
    test_torch_volume tolerances, and is bit-equal to the port's eager
    form (the chunk count read on the host)."""
    jv, frame_j, band, n_band, d, c, pose_j = band_frame
    assert n_band > 128
    count = _count(which, n_band, band.shape[0])
    ref = jflat(jsp.integrate_sparse(jv, frame_j, CFG_J, ids=jnp.asarray(band),
                                     count=jnp.asarray(count, jnp.int32)))
    cfg = dataclasses.replace(CFG_T, integrate_chunk=64)
    frame = Frame(t(d), t(c), CAM_T, se3_t(pose_j))

    def fuse():
        tv = tB.VolumeState(**{k: t(v) for k, v in jflat(jv).items()})
        return tsp.integrate_sparse(tv, frame, cfg, ids=t(band),
                                    count=torch.tensor(count, dtype=torch.int32))

    got = fuse()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = fuse()
        assert sync.read_int.count - reads == 1
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(eager, f.name)), f.name
    np.testing.assert_allclose(got.tsdf.numpy(), ref["tsdf"], atol=2e-6)
    assert np.mean(got.surfpack.numpy() != ref["surfpack"]) <= 1e-3
    assert np.mean(got.colorpack.numpy() != ref["colorpack"]) <= 1e-3
    for name in ("weight", "surf_count", "mesh_dirty", "surf_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name], err_msg=name)
    fused = int((got.weight.numpy() > 0).any(axis=1).sum())
    assert (fused == 0) == (count == 0)


@pytest.fixture(scope="module")
def splat_inputs():
    """The fused orbit volume on both sides at two visible-list capacities:
    the default, and 512 blocks (the surfel list then fills its capacity,
    one chunk of each tier exactly)."""
    jv0, _, pose_j, pose_t = fused_orbit_volumes()
    out = {}
    for cap in (CFG_T.max_visible, 512):
        cfg_j = dataclasses.replace(CFG_J, max_visible=cap)
        cfg_t = dataclasses.replace(CFG_T, max_visible=cap)
        # The visible list at this capacity, from the carried arrays (the
        # list's length is the only field it changes).
        arrays = {k: v for k, v in jflat(jv0).items()
                  if k not in ("visible_ids", "num_visible")}
        jv = jal.update_visibility(
            dataclasses.replace(jv0, visible_ids=jnp.zeros((cap,), jnp.int32),
                                num_visible=jnp.asarray(0, jnp.int32)),
            CAM_J, pose_j, H, W, cfg_j)
        tv = tB.VolumeState(**{k: t(v) for k, v in arrays.items()},
                            visible_ids=torch.zeros(cap, dtype=torch.int32),
                            num_visible=torch.zeros((), dtype=torch.int32))
        tv = tal.update_visibility(tv, CAM_T, pose_t, H, W, cfg_t)
        out[cap] = (jv, tv, cfg_j, cfg_t)
    return out, pose_j, pose_t


@pytest.mark.parametrize("cap", [CFG_T.max_visible, 512])
def test_surfel_tiers_upper_bound_form_match_reference(splat_inputs, captured, cap):
    """Both surfel tiers in capture form (max_visible / 2048 and / 512
    chunks, each an IF node on ``start < length``) for the depth, packed
    luma and rgb z-buffers: bit-equal to the eager form (one counted read
    of the two tier lengths) and within test_torch_splat's tolerances of
    the reference."""
    by_cap, pose_j, pose_t = splat_inputs
    jv, tv, cfg_j, cfg_t = by_cap[cap]
    ids, n_surf = tsplat._surfel_block_list(tv, cfg_t)
    n_surf = int(n_surf)
    assert 0 < n_surf <= cap

    def zbufs():
        return (tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, cfg_t),
                tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, cfg_t, luma=True),
                *tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, cfg_t,
                                            with_color=True))

    got = zbufs()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = zbufs()
        assert sync.read_int.count - reads == 3
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    zj = np.asarray(jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, cfg_j))
    wj = np.asarray(jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, cfg_j, luma=True))
    zt, wt, _, ct = (x.numpy() for x in got)
    assert np.mean(np.isfinite(zt) != np.isfinite(zj)) < 1e-3
    both = np.isfinite(zt) & np.isfinite(zj)
    assert both.mean() > 0.05
    assert np.mean(np.abs(zt[both] - zj[both]) > 1e-5) < 1e-3
    assert np.mean(wt != wj) < 1e-3
    np.testing.assert_array_equal(ct >= 0, np.isfinite(zt))


def test_cond_picks_the_branch_eagerly():
    """Eager ``cond``: one counted read, the branch the predicate names;
    under ``warm_both`` both branches run and the chosen one's result is
    returned; a predicate the caller has read already (an int) costs no
    read, and under ``warm_both`` still runs both branches."""
    ran = []

    def branch(tag):
        def fn():
            ran.append(tag)
            return torch.full((2,), float(tag))
        return fn

    for value, want in ((3, 1), (0, 0)):
        pred = torch.tensor(value, dtype=torch.int32)
        reads = sync.read_int.count
        ran.clear()
        out = sync.cond(pred, branch(1), branch(0))
        assert sync.read_int.count - reads == 1 and ran == [want]
        assert torch.equal(out, torch.full((2,), float(want)))
        ran.clear()
        with sync.warm_both():
            out = sync.cond(pred, branch(1), branch(0))
        assert ran == [1, 0] and torch.equal(out, torch.full((2,), float(want)))
        count = torch.tensor(7, dtype=torch.int32)
        reads = sync.read_int.count
        n, on = sync.read_ints(count, pred)
        ran.clear()
        out = sync.cond(on, branch(1), branch(0))
        assert n == 7 and sync.read_int.count - reads == 1 and ran == [want]
        assert torch.equal(out, torch.full((2,), float(want)))
        ran.clear()
        with sync.warm_both():
            out = sync.cond(on, branch(1), branch(0))
        assert ran == [1, 0] and torch.equal(out, torch.full((2,), float(want)))
        assert sync.read_int.count - reads == 1
    assert not sync._warm_both


@pytest.mark.parametrize("mode,known,reads", [
    ("depth", False, 3), ("color", False, 2), ("combined", False, 2),
    ("light", False, 2), ("depth", True, 2),
])
def test_step_reads_per_frame_on_cpu(mode, known, reads):
    """The eager step reads as many values a frame on the CPU as it did
    before its loops and branches went through ``utils.sync``: the
    integrate count and the track/render branch in one transfer, the tier
    lengths in another, and in depth mode the auto-photo track's branch."""
    poses = orbit(3)
    pipe = P.Pipeline(CFG_T, CAM_T, H, W, init_pose=se3_t(poses[0]), mode=mode,
                      device="cpu")
    assert not pipe.captured and pipe.graph_stats == {}
    for pose in poses:
        d, c = scene(pose)
        before = sync.read_int.count
        pipe.process(d, c, pose=se3_t(pose) if known else None)
        assert sync.read_int.count - before == reads


def test_capturable_follows_the_renderer():
    for mode in ("depth", "color", "combined", "light"):
        assert fusion.capturable(P.Config(), mode)
    for override in (dict(render_mode="march"), dict(splat_source="direct"),
                     dict(splat_polish=2)):
        assert not fusion.capturable(P.Config(**override))
    with pytest.raises(ValueError):
        fusion.capturable(P.Config(), "stereo")


def test_state_buffers_copy_without_aliasing():
    """``distinct`` gives the fresh state's shared pose two buffers;
    ``copy_leaves`` copies a new state into the buffers even where a new
    field IS another field's buffer (the step's ``prev_pose`` is the old
    pose), skips what already is its buffer, and ``rebuild`` puts the
    tree back together over them."""
    state = fusion.init_state(CFG_T, CAM_T, H, W, device="cpu")
    leaves = sync.tensor_leaves(state)
    assert state.prev_pose.rotation is state.model.pose.rotation
    bufs = graphs.distinct(leaves)
    ptrs = [b.untyped_storage().data_ptr() for b in bufs]
    assert len(set(ptrs)) == len(ptrs)
    view = graphs.rebuild(state, iter(bufs))
    assert all(a is b for a, b in zip(sync.tensor_leaves(view), bufs))
    assert view.model.camera == state.model.camera

    moved = SE3(view.model.pose.rotation.flip(0), view.model.pose.translation + 1.0)
    old_r = view.model.pose.rotation.clone()
    new = dataclasses.replace(view, model=dataclasses.replace(view.model, pose=moved),
                              prev_pose=view.model.pose,
                              frame_idx=view.frame_idx + 1)
    assert graphs.copy_leaves(bufs, sync.tensor_leaves(new))
    assert torch.equal(view.prev_pose.rotation, old_r)
    assert torch.equal(view.model.pose.rotation, old_r.flip(0))
    assert int(view.frame_idx) == 1
    assert view.volume.tsdf is state.volume.tsdf
    assert not graphs.copy_leaves(bufs, sync.tensor_leaves(view))
