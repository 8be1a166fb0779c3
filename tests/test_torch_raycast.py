"""The hierarchical ray march (``ops/raycast.py``) held against the JAX
package: the range image, both branches of the survivor compaction, the
raycast with cross and gradient normals, the renderer dispatch, the
five-class ``Tracer`` and a short closed loop under ``render_mode="march"``."""
import dataclasses
import inspect
import types

import jax
import numpy as np
import pytest
import torch

import vulcan_tpu as J
import vulcan_tpu_torch as P
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import raycast as jray
from vulcan_tpu.utils.evaluate import ate_rmse as j_ate_rmse
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.ops import raycast as tray
from vulcan_tpu_torch.utils.evaluate import ate_rmse

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, _j_volume, fused_orbit_volumes, no_kernel, orbit,
    reference_five_class, scene, se3_t,
)

MAPS = ("depth", "vx", "vy", "vz", "nx", "ny", "nz")
# One jitted reference raycast for every test (static: sizes, config,
# normals, colour), so equal settings compile once.
_j_raycast = jax.jit(jray.raycast, static_argnums=(3, 4, 5, 6, 7))


def _march_cfgs(**kw):
    return (dataclasses.replace(CFG_J, render_mode="march", **kw),
            dataclasses.replace(CFG_T, render_mode="march", **kw))


def assert_render_close(rt, rj, normal_frac=2e-2):
    """A port render against the reference's.  The march's sample indices
    round floats that the reference's compiled step computes with fused
    multiply-adds: a ray may find its crossing one sample over, so masks
    and depths are held on 99.9% of pixels (depth and vertices within
    1e-5 m there); cross normals difference neighbouring vertices, which
    scales float32 noise by ~100, so they are held to 1e-3 on all but
    ``normal_frac`` of pixels.  Colour is a nearest-voxel read: exact on
    99.9% of pixels."""
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    assert vj.mean() > 0.3
    assert np.mean(vj != vt) <= 1e-3
    both = vj & vt
    for name in MAPS:
        a, b = getattr(rt, name).numpy()[both], np.asarray(getattr(rj, name))[both]
        if name.startswith("n"):
            assert np.mean(np.abs(a - b) > 1e-3) <= normal_frac, name
        else:
            assert np.mean(np.abs(a - b) > 1e-5) <= 1e-3, name
    cj, ct = np.asarray(rj.color), rt.color.numpy()
    assert np.mean(np.any(ct != cj, axis=-1)) <= 1e-3


@pytest.fixture(scope="module")
def volumes():
    """The fused volume on both sides, visibility re-run at its pose."""
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    jv = jal.update_visibility(jv, CAM_J, pose_j, H, W, CFG_J)
    tv = tal.update_visibility(tv, CAM_T, pose_t, H, W, CFG_T)
    return jv, tv, pose_j, pose_t


# How far ``test_range_image_matches_reference_exactly``'s "overflow" case
# moves the camera along its optical axis: 0.2 m in front of the big
# sphere, so that listed blocks lie behind it and others cover more than
# the stamp.
_OVERFLOW_STEP = 0.9


def _range_case(volumes, case):
    """(reference volume, port volume, reference pose, port pose) of a range
    image case: the fused orbit volume at its pose; the same list from a
    camera moved ``_OVERFLOW_STEP`` forward (overflow rows of both kinds);
    an empty visible list."""
    jv, tv, pose_j, pose_t = volumes
    if case == "overflow":
        axis = np.asarray(pose_j.rotation)[:, 2] * _OVERFLOW_STEP
        pose_j = dataclasses.replace(pose_j, translation=pose_j.translation + axis)
        pose_t = se3_t(pose_j)
    elif case == "empty":
        jv = dataclasses.replace(jv, num_visible=jv.num_visible * 0)
        tv = dataclasses.replace(tv, num_visible=tv.num_visible * 0)
    return jv, tv, pose_j, pose_t


@pytest.mark.parametrize("case", ["fused", "overflow", "empty"])
def test_range_image_matches_reference_exactly(volumes, case):
    """The plain stamps and upsample (the CPU's path, kernel R1's
    yardstick) against the reference's scatters, bit for bit: on the fused
    volume, with overflow rows (corners behind the camera, footprints wider
    than the stamp) beside stamped ones, and on an empty visible list."""
    jv, tv, pose_j, pose_t = _range_case(volumes, case)
    ref = jax.jit(jray.compute_range_image, static_argnums=(3, 4, 5))(
        jv, CAM_J, pose_j, H, W, CFG_J)
    got = tray.compute_range_image(tv, CAM_T, pose_t, H, W, CFG_T)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t_min, t_fmax, t_max = (a.numpy() for a in got)
    rows = tray._range_rows(tv, CAM_T, pose_t, CFG_T)
    listed = int(tv.num_visible)
    if case == "empty":
        assert listed == 0 and not rows.stampable.any() and not rows.any_overflow
        assert np.isposinf(t_min).all() and np.isposinf(t_fmax).all()
        assert np.isneginf(t_max).all()
        return
    assert listed > 0 and rows.stampable.any()
    if case == "overflow":
        behind, oversize = rows.behind[:listed], rows.oversize[:listed]
        assert behind.any() and (oversize & ~behind).any() and rows.any_overflow
        assert (t_min <= t_max).all() and np.isfinite(t_max).all()
    else:
        assert (t_min <= t_max).mean() > 0.5


def test_range_image_path_by_coarse_size():
    """Kernel R1 keeps its three coarse images in each CTA's shared memory
    while they fit, else in global memory: by their size alone."""
    assert cuda_kernels.range_image_path(40 * 30) == "smem"           # 640x480 / 16
    assert cuda_kernels.range_image_path(160 * 120) == "smem"         # 640x480 / 4
    assert cuda_kernels.range_image_path(320 * 240) == "global"       # 640x480 / 2
    most = cuda_kernels.RANGE_SMEM_BYTES // 12
    assert cuda_kernels.range_image_path(most) == "smem"
    assert cuda_kernels.range_image_path(most + 1) == "global"


@pytest.mark.parametrize("branch,divs", [("compact", (2, 2)), ("mixed", None),
                                         ("full", (10**6, 10**6))])
def test_march_branches_match_reference(volumes, monkeypatch, branch, divs):
    """Each level's march takes the compacted-survivor branch when round
    1 leaves at most M = max(n // div, 256) rays undone, else the
    full-width one: both levels compact at divisors (2, 2); the default
    (2 coarse, 4 fine) compacts the coarse level only on this scene; a
    huge divisor compacts neither.  Each gives the reference's maps.  The
    branch is read off ``sync.cond``'s predicate, and checked against
    round 1's survivors."""
    jv, tv, pose_j, pose_t = volumes
    cfg_j, cfg_t = CFG_J, CFG_T
    if divs:
        kw = dict(raycast_coarse_compact=divs[0], raycast_fine_compact=divs[1])
        cfg_j, cfg_t = (dataclasses.replace(c, **kw) for c in (CFG_J, CFG_T))
    survivors, taken = [], []
    sync = tray.sync

    def spy(pred, compact, full):
        # Round 1's carry, from the compaction branch's closure.
        carry = inspect.getclosurevars(compact).nonlocals["carry"]
        survivors.append(int(torch.sum(~carry[-1])))
        taken.append(bool(pred))
        return sync.cond(pred, compact, full)

    monkeypatch.setattr(tray, "sync", types.SimpleNamespace(cond=spy))
    rt = tray.raycast(tv, CAM_T, pose_t, H, W, cfg_t)
    rj = _j_raycast(jv, CAM_J, pose_j, H, W, cfg_j, "cross", True)
    k = CFG_T.raycast_coarse
    sizes = (-(-H // k) * -(-W // k), H * W)          # coarse, fine rays
    divs = (cfg_t.raycast_coarse_compact, cfg_t.raycast_fine_compact)
    assert len(survivors) == 2 and min(survivors) > 0
    compacted = [s <= max(n // div, 256) for n, div, s in zip(sizes, divs, survivors)]
    assert taken == compacted
    assert compacted == {"compact": [True, True], "mixed": [True, False],
                         "full": [False, False]}[branch]
    assert_render_close(rt, rj)


@pytest.mark.parametrize("normals,with_color", [("cross", False), ("gradient", True),
                                                ("gradient", False)])
def test_raycast_matches_reference(volumes, normals, with_color):
    """Cross normals with colour are held by the branch test above."""
    jv, tv, pose_j, pose_t = volumes
    rj = _j_raycast(jv, CAM_J, pose_j, H, W, CFG_J, normals, with_color)
    rt = tray.raycast(tv, CAM_T, pose_t, H, W, CFG_T, normals, with_color)
    assert_render_close(rt, rj)
    if not with_color:
        assert not rt.color.numpy().any()
    n = rt.normal_world.numpy()[rt.valid.numpy()]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-4)


def test_render_dispatches_to_the_march(volumes):
    """``render`` under ``render_mode="march"`` is the raycast, with the
    march's rgb colour whatever ``color_space`` says."""
    jv, tv, pose_j, pose_t = volumes
    _, cfg_t = _march_cfgs()
    got = tray.render(tv, CAM_T, pose_t, H, W, cfg_t, color_space="luma")
    want = tray.raycast(tv, CAM_T, pose_t, H, W, CFG_T)
    for name in MAPS + ("color", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), err_msg=name)


@pytest.fixture(scope="module")
def traced_volumes():
    """A five-class ``Volume`` built with ``render_mode="march"`` after
    integrating two orbit frames, and the reference's volume state after
    its ``Integrator`` took the same frames."""
    cfg_j, cfg_t = _march_cfgs()
    j_integrate, _, _ = reference_five_class(cfg_j)
    poses = orbit(3)[1:]
    state = J.Volume(cfg_j).state
    vol = P.Volume(cfg_t, device="cpu")
    integrator = P.Integrator(vol)
    for pose in poses:
        d, c = scene(pose)
        state = j_integrate(state, d, c, pose)
        integrator.integrate(P.make_frame(d, c, CAM_T, se3_t(pose), device="cpu"))
    return state, vol, poses[-1]


@pytest.mark.parametrize("normals", ["cross", "gradient"])
def test_tracer_under_march_matches_reference(traced_volumes, normals, no_kernel):
    """``Tracer.trace`` renders by the march (no splat, no K2 call) as the
    reference's ``Tracer`` does, with either normals."""
    state, vol, pose = traced_volumes
    cfg_j, _ = _march_cfgs()

    @jax.jit
    def j_trace(state, pose):
        v = _j_volume(state, cfg_j)
        return J.Tracer(v).trace(CAM_J, pose, H, W, normals=normals)

    rt = P.Tracer(vol).trace(CAM_T, se3_t(pose), H, W, normals=normals)
    assert_render_close(rt, j_trace(state, pose))


N_LOOP = 5


@pytest.fixture(scope="module")
def march_reference_run():
    cfg_j, _ = _march_cfgs()
    poses = orbit(N_LOOP)
    frames = [scene(p) for p in poses]
    pipe = J.Pipeline(cfg_j, CAM_J, H, W, init_pose=poses[0])
    est = []
    for d, c in frames:
        pipe.process(d, c)
        est.append(np.asarray(pipe.state.model.pose.translation))
    return poses, frames, np.stack(est), pipe


def test_march_closed_loop_matches_reference(march_reference_run, no_kernel):
    """``Pipeline.process`` under ``render_mode="march"`` tracks the orbit
    as the reference does: translations within 1e-3 m a frame, ATEs
    within 1e-3 m of each other and under 0.01 m, the last model maps
    within the raycast's tolerances."""
    poses, frames, ref, jpipe = march_reference_run
    _, cfg_t = _march_cfgs()
    pipe = P.Pipeline(cfg_t, CAM_T, H, W, init_pose=se3_t(poses[0]), device="cpu")
    est = []
    for d, c in frames:
        pipe.process(d, c)
        est.append(pipe.pose.translation.numpy())
    est = np.stack(est)
    gt = np.stack([np.asarray(p.translation) for p in poses])
    np.testing.assert_allclose(est, ref, rtol=0, atol=1e-3)
    assert abs(ate_rmse(est, gt) - j_ate_rmse(ref, gt)) < 1e-3
    assert ate_rmse(est, gt) < 0.01
    diag = pipe.diagnostics()
    assert diag["track_failures"] == 0 and diag["track_inliers"] > 1000
    assert diag["alloc_overflow"] == diag["visible_overflow"] == 0
    # Rendered at poses ~1e-4 m apart: hold the masks, not the floats.
    vj, vt = np.asarray(jpipe.state.model.valid), pipe.state.model.valid.numpy()
    assert vj.mean() > 0.3 and np.mean(vj != vt) < 5e-3
