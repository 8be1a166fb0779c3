"""Depth-mode ICP held against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import icp as jicp
from vulcan_tpu.ops import sparse as jsp
from vulcan_tpu.ops import splat as jsplat
from vulcan_tpu.ops.preprocess import build_pyramid as j_build_pyramid
from vulcan_tpu_torch.core.frame import FrameMaps
from vulcan_tpu_torch.ops import icp as ticp
from vulcan_tpu_torch.ops.raycast import Render

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, orbit, scene, se3_t, t,
)


def test_vertex_and_normal_packing_exact_with_negative_coords():
    rng = np.random.default_rng(0)
    v = rng.uniform(-12.0, 12.0, (3, 64, 80)).astype(np.float32)
    v[:, :4] = -(2.0 ** -16) * np.arange(1, 81)[None, None, :]   # tiny negatives
    origin = np.array([-3.25, 1.5, -0.0078125], np.float32)
    for o in (None, origin):
        pj = jicp._pack_vertices(*map(jnp.asarray, v), None if o is None else jnp.asarray(o))
        pt = ticp._pack_vertices(*map(t, v), None if o is None else t(o))
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        uj = jicp._unpack_vertices(*pj, None if o is None else jnp.asarray(o))
        ut = ticp._unpack_vertices(*pt, None if o is None else t(o))
        for a, b, orig in zip(ut, uj, v):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_allclose(a.numpy(), orig, atol=2.0 ** -16)
    n = rng.normal(size=(3, 64, 80)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    valid = rng.random((64, 80)) < 0.7
    pj = jicp._pack_normals(*map(jnp.asarray, n), jnp.asarray(valid))
    pt = ticp._pack_normals(*map(t, n), t(valid))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for a, b in zip(ticp._unpack_normals(pt), jicp._unpack_normals(pj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    snap = np.array([1.234567, -7.654321, 0.5], np.float32)
    np.testing.assert_array_equal(
        ticp._snap_origin(t(snap)).numpy(), np.asarray(jicp._snap_origin(jnp.asarray(snap)))
    )


@pytest.fixture(scope="module")
def tracking_inputs():
    """A reference model render at orbit pose 2 (two fused frames) and the
    live pyramid of the frame at pose 3, in both packages."""
    poses = orbit(4)
    jv = jB.create_volume(CFG_J)
    for pose in poses[1:3]:
        d, c = scene(pose)
        frame = make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
        jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
        jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
        jv = jsp.integrate_sparse(jv, frame, CFG_J, ids=band, count=n_band)
    rj = jsplat.render_splat(jv, CAM_J, poses[2], H, W, CFG_J, with_color=False)
    rt = Render(
        **{k: t(getattr(rj, k)) for k in
           ("depth", "vx", "vy", "vz", "nx", "ny", "nz", "color", "valid")},
        camera=CAM_T, pose=se3_t(rj.pose),
    )
    d, c = scene(poses[3])
    live_j = j_build_pyramid(
        make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, poses[3]), CFG_J,
        with_intensity=False,
    )
    # The live side is carried across too, so association sees equal input.
    cams_t = [CAM_T, CAM_T.scaled(0.5), CAM_T.scaled(0.5).scaled(0.5)]
    live_t = tuple(
        FrameMaps(t(m.depth), t(m.vertices), t(m.normals), None, cam)
        for m, cam in zip(live_j, cams_t)
    )
    return dict(rj=rj, rt=rt, live_j=live_j, live_t=live_t, poses=poses)


def test_model_pyramid_exact(tracking_inputs):
    mj = jicp.model_pyramid(tracking_inputs["rj"], 3, with_intensity=False)
    mt = ticp.model_pyramid(tracking_inputs["rt"], 3)
    for a, b in zip(mt, mj):
        for name in ("vpack1", "vpack2", "npack"):
            np.testing.assert_array_equal(
                getattr(a, name).numpy(), np.asarray(getattr(b, name)), err_msg=name
            )
        np.testing.assert_array_equal(a.origin.numpy(), np.asarray(b.origin))
        assert (a.camera.fx, a.camera.cy) == (float(b.camera.fx), float(b.camera.cy))


def test_associate_depth_exact(tracking_inputs):
    mj = jicp.model_pyramid(tracking_inputs["rj"], 3, with_intensity=False)
    mt = ticp.model_pyramid(tracking_inputs["rt"], 3)
    pose_j = tracking_inputs["poses"][2]
    pose_t = se3_t(pose_j)
    for level in range(3):
        vj, nj, okj = jicp.associate_depth(
            tracking_inputs["live_j"][level], mj[level], pose_j, CFG_J
        )
        vt, nt, okt = ticp.associate_depth(
            tracking_inputs["live_t"][level], mt[level], pose_t, CFG_T
        )
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        assert okt.sum() > 100
        m = okt.numpy()
        np.testing.assert_array_equal(vt.numpy()[m], np.asarray(vj)[m])
        np.testing.assert_array_equal(nt.numpy()[m], np.asarray(nj)[m])


def test_normal_equations_and_solvers_match_reference(tracking_inputs):
    mj = jicp.model_pyramid(tracking_inputs["rj"], 3, with_intensity=False)
    mt = ticp.model_pyramid(tracking_inputs["rt"], 3)
    pose_j = tracking_inputs["poses"][2]
    pose_t = se3_t(pose_j)
    live_j, live_t = tracking_inputs["live_j"][1], tracking_inputs["live_t"][1]
    vj, nj, okj = jicp.associate_depth(live_j, mj[1], pose_j, CFG_J)
    vt, nt, okt = ticp.associate_depth(live_t, mt[1], pose_t, CFG_T)
    for live_normals in (False, True):
        Hj, bj, ej, cj = jicp._pp_normal_eqs(
            live_j, vj, nj, okj, pose_j, CFG_J, live_normals=live_normals
        )
        Ht, bt, et, ct = ticp._pp_normal_eqs(
            live_t, vt, nt, okt, pose_t, CFG_T, live_normals=live_normals
        )
        # ~3k float32 terms summed in a different order: relative 1e-5.
        scale = np.abs(np.asarray(Hj)).max()
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-5 * scale)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj),
                                   atol=1e-5 * np.abs(np.asarray(bj)).max())
        np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)
        assert float(ct) == float(cj) > 100
        # The solvers on the SAME matrix.
        H = np.asarray(Hj)
        np.testing.assert_allclose(
            float(ticp._min_eig_normalized(t(H))),
            float(jicp._min_eig_normalized(jnp.asarray(H))), rtol=1e-4,
        )
        np.testing.assert_allclose(
            ticp.solve_gn(t(H), t(bj), CFG_T.icp_damping).numpy(),
            np.asarray(jicp.solve_gn(jnp.asarray(H), bj, CFG_J.icp_damping)),
            rtol=1e-4, atol=1e-8,
        )
    # A singular (no inliers) system: both score 0 and step 0, no raise.
    z = np.zeros((6, 6), np.float32)
    assert float(ticp._min_eig_normalized(t(z))) == 0.0
    assert float(jicp._min_eig_normalized(jnp.asarray(z))) == 0.0
    np.testing.assert_array_equal(
        ticp.solve_gn(t(-np.eye(6, dtype=np.float32)), t(np.ones(6, np.float32)), 1e-4).numpy(),
        np.zeros(6, np.float32),
    )


def test_track_matches_reference(tracking_inputs):
    mj = jicp.model_pyramid(tracking_inputs["rj"], 3, with_intensity=False)
    mt = ticp.model_pyramid(tracking_inputs["rt"], 3)
    init_j = tracking_inputs["poses"][2]
    rj = jax.jit(jicp.track, static_argnums=(3, 4))(
        tracking_inputs["live_j"], mj, init_j, CFG_J, "depth"
    )
    rt = ticp.track(tracking_inputs["live_t"], mt, se3_t(init_j), CFG_T)
    truth = np.asarray(tracking_inputs["poses"][3].translation)
    # The track moved ~18 cm from its init onto the truth ...
    assert np.abs(rt.pose.translation.numpy() - truth).max() < 5e-3
    # ... and matches the reference to float32 noise through ~25 GN steps.
    np.testing.assert_allclose(
        rt.pose.translation.numpy(), np.asarray(rj.pose.translation), atol=1e-5
    )
    np.testing.assert_allclose(
        rt.pose.rotation.numpy(), np.asarray(rj.pose.rotation), atol=1e-5
    )
    assert bool(rt.valid) == bool(rj.valid)
    np.testing.assert_allclose(rt.level_error.numpy(), np.asarray(rj.level_error), rtol=1e-3)
    np.testing.assert_allclose(
        rt.level_inliers.numpy(), np.asarray(rj.level_inliers), rtol=2e-3
    )
    np.testing.assert_allclose(rt.level_degen.numpy(), np.asarray(rj.level_degen), rtol=1e-3)
    np.testing.assert_allclose(float(rt.geo_degen), float(rj.geo_degen), rtol=1e-3)
