"""The dense-grid backend (``ops/dense.py``, BASELINE.json configs 1-2) held
against the JAX package on tests/test_dense.py's four scenarios, and the
analytic sphere of ``io/synthetic.py`` that drives them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vulcan_tpu_torch as P
from vulcan_tpu.config import Config as JConfig
from vulcan_tpu.core.frame import make_frame as j_make_frame
from vulcan_tpu.io import synthetic as jsyn
from vulcan_tpu.ops import dense as jdense
from vulcan_tpu_torch.io import synthetic as tsyn
from vulcan_tpu_torch.ops import dense as tdense
from vulcan_tpu_torch.utils.convert import dense_volume_from_numpy, dense_volume_to_numpy

from ._torch_port import MC_CAM_J, MC_CAM_T, MC_H, MC_W, jflat, se3_t, t

CFG_J = JConfig(voxel_size=0.02, trunc_dist=0.08)
CFG_T = P.Config(voxel_size=0.02, trunc_dist=0.08)
CENTER, RADIUS = (0.0, 0.0, 0.0), 0.5
FIELDS = ("tsdf", "weight", "color", "color_weight", "origin")

_j_integrate = jax.jit(jdense.integrate_dense, static_argnums=2)
_j_raycast = jax.jit(jdense.raycast_dense, static_argnums=(3, 4, 5))


def _origin(n):
    return -np.array([n, n, n]) / 2 * CFG_T.voxel_size


def _volumes(n):
    return (jdense.create_dense_volume((n, n, n), _origin(n)),
            tdense.create_dense_volume((n, n, n), _origin(n), device="cpu"))


def _frames(pose_j):
    """The reference's analytic sphere frame, on both sides."""
    d, c = jsyn.render_sphere_depth(MC_CAM_J, pose_j, MC_H, MC_W, CENTER, RADIUS)
    return (j_make_frame(d, c, MC_CAM_J, pose_j),
            P.make_frame(np.asarray(d), np.asarray(c), MC_CAM_T, se3_t(pose_j),
                         device="cpu"))


def assert_volume_close(vt, vj):
    """Each voxel projects to a pixel by rounding a float projection; the
    reference's compiled transform fuses FMAs, so a voxel within an ulp
    of a pixel boundary samples the neighbouring pixel: every array is
    equal (tsdf and colour to 1e-5) on all but 0.1% of voxels."""
    assert vt.shape == tuple(vj.shape)
    for name in FIELDS[:4]:
        a, b = getattr(vt, name).numpy(), np.asarray(getattr(vj, name))
        bad = np.abs(a.astype(np.float64) - b) > 1e-5
        if bad.ndim == 4:
            bad = bad.any(-1)
        assert bad.mean() <= 1e-3, name
    np.testing.assert_array_equal(vt.origin.numpy(), np.asarray(vj.origin))


def test_render_sphere_depth_matches_reference():
    pose_j = jsyn.orbit_poses(3, CENTER, radius=1.6, height=0.3)[1]
    dj, cj = jsyn.render_sphere_depth(MC_CAM_J, pose_j, MC_H, MC_W, CENTER, RADIUS)
    dt, ct = tsyn.render_sphere_depth(MC_CAM_T, se3_t(pose_j), MC_H, MC_W, CENTER,
                                      RADIUS, device="cpu")
    np.testing.assert_array_equal(dt.numpy() > 0, np.asarray(dj) > 0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    assert (dt.numpy() > 0).mean() > 0.2
    pts = np.random.default_rng(3).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tsyn.sphere_sdf(t(pts), CENTER, RADIUS).numpy(),
                               np.asarray(jsyn.sphere_sdf(jnp.asarray(pts), CENTER,
                                                          RADIUS)), atol=1e-6)


def test_single_frame_integration_matches_reference():
    """Config 1: one frame into a 96^3 grid, against the reference's grid
    and the analytic SDF (tests/test_dense.py's bounds)."""
    vj, vt = _volumes(96)
    pose = jsyn.orbit_poses(1, CENTER, radius=1.6, height=0.0)[0]
    fj, ft = _frames(pose)
    vj, vt = _j_integrate(vj, fj, CFG_J), tdense.integrate_dense(vt, ft, CFG_T)
    assert_volume_close(vt, vj)
    w, f = vt.weight.numpy(), vt.tsdf.numpy()
    assert (w > 0).sum() > 1000
    n = vt.shape[0]
    idx = np.stack(np.meshgrid(*(np.arange(n),) * 3, indexing="ij"), axis=-1)
    world = (idx * CFG_T.voxel_size + vt.origin.numpy()).astype(np.float32)
    true_sdf = tsyn.sphere_sdf(t(world), CENTER, RADIUS).numpy()
    band = (w > 0) & (np.abs(true_sdf) < 0.5 * CFG_T.trunc_dist)
    assert band.sum() > 300
    err = np.abs(f[band] * CFG_T.trunc_dist - true_sdf[band])
    assert np.median(err) < CFG_T.voxel_size and np.mean(err) < 2 * CFG_T.voxel_size


def test_integration_is_idempotent_up_to_weight():
    """Fusing the same frame twice only doubles the weight, on both sides."""
    vj, vt = _volumes(64)
    fj, ft = _frames(jsyn.orbit_poses(1, CENTER, radius=1.6)[0])
    v1j = jdense.integrate_dense(vj, fj, CFG_J)
    v2j = jdense.integrate_dense(v1j, fj, CFG_J)
    v1 = tdense.integrate_dense(vt, ft, CFG_T)
    v2 = tdense.integrate_dense(v1, ft, CFG_T)
    assert_volume_close(v2, v2j)
    np.testing.assert_allclose(v2.tsdf.numpy(), v1.tsdf.numpy(), atol=1e-5)
    touched = v1.weight.numpy() > 0
    np.testing.assert_array_equal(v2.weight.numpy()[touched],
                                  2 * v1.weight.numpy()[touched])


@pytest.fixture(scope="module")
def fused_orbit():
    """Config 2: eight orbit frames fused into a 96^3 grid on both sides."""
    vj, vt = _volumes(96)
    for pose in jsyn.orbit_poses(8, CENTER, radius=1.6, height=0.3):
        fj, ft = _frames(pose)
        vj, vt = _j_integrate(vj, fj, CFG_J), tdense.integrate_dense(vt, ft, CFG_T)
    return vj, vt


def test_multiframe_fusion_and_raycast_match_reference(fused_orbit):
    """Config 2: the fused grids agree, and so do their raycasts from a
    held-out pose: the hit masks on 99.9% of pixels, depth and vertices
    within 1e-5 m and normals within 1e-4 on 99.9% of the common hits;
    against the analytic sphere the bounds of tests/test_dense.py."""
    vj, vt = fused_orbit
    assert_volume_close(vt, vj)
    pose = jsyn.orbit_poses(16, CENTER, radius=1.6, height=0.3)[1]
    oj = _j_raycast(vj, MC_CAM_J, pose, MC_H, MC_W, CFG_J)
    ot = tdense.raycast_dense(vt, MC_CAM_T, se3_t(pose), MC_H, MC_W, CFG_T)
    assert set(ot) == set(oj)
    valid_j, valid_t = np.asarray(oj["valid"]), ot["valid"].numpy()
    assert np.mean(valid_j != valid_t) <= 1e-3
    both = valid_j & valid_t
    for name, tol in (("t", 1e-5), ("depth", 1e-5), ("vertex_world", 1e-5),
                      ("normal_world", 1e-4), ("color", 1e-5)):
        bad = np.abs(ot[name].numpy()[both] - np.asarray(oj[name])[both]) > tol
        assert (bad.any(-1) if bad.ndim == 2 else bad).mean() <= 1e-3, name

    true_depth, _ = tsyn.render_sphere_depth(MC_CAM_T, se3_t(pose), MC_H, MC_W, CENTER,
                                             RADIUS, device="cpu")
    true_depth = true_depth.numpy()
    valid = valid_t & (true_depth > 0)
    assert valid.mean() > 0.1
    err = np.abs(ot["depth"].numpy()[valid] - true_depth[valid])
    assert np.median(err) < 0.5 * CFG_T.voxel_size and np.mean(err) < CFG_T.trunc_dist
    p = ot["vertex_world"].numpy()[valid]
    n_true = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    assert np.mean(np.sum(ot["normal_world"].numpy()[valid] * n_true, axis=-1)) > 0.95
    c_true = tsyn.procedural_color(t(p)).numpy()
    assert np.mean(np.abs(ot["color"].numpy()[valid] - c_true)) < 0.1


def test_dense_volume_roundtrips_through_numpy(fused_orbit):
    vj, vt = fused_orbit
    back = dense_volume_from_numpy(jflat(vj))
    assert back.shape == vt.shape == (96, 96, 96)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(vj, name)), err_msg=name)
    assert set(dense_volume_to_numpy(vt)) == set(("shape",) + FIELDS)


def test_raycast_misses_empty_volume():
    vj, vt = _volumes(32)
    pose = jsyn.orbit_poses(1)[0]
    ot = tdense.raycast_dense(vt, MC_CAM_T, se3_t(pose), 24, 32, CFG_T)
    oj = jdense.raycast_dense(vj, MC_CAM_J, pose, 24, 32, CFG_J)
    assert not ot["valid"].numpy().any() and not np.asarray(oj["valid"]).any()
    for name in ("depth", "vertex_world", "normal_world", "color"):
        assert not ot[name].numpy().any(), name


def test_create_dense_volume_needs_a_card_without_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdense.create_dense_volume((8, 8, 8), (0.0, 0.0, 0.0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsyn.render_sphere_depth(MC_CAM_T, se3_t(jsyn.orbit_poses(1)[0]), 8, 8)
