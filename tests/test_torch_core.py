"""The port's config, SE3 and camera held against the JAX package."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.config import Config as JConfig
from vulcan_tpu.core.camera import PinholeCamera as JCam
from vulcan_tpu.core.se3 import SE3 as JSE3
from vulcan_tpu.io import synthetic as jsyn
from vulcan_tpu.utils import evaluate as jev
from vulcan_tpu_torch.core.se3 import SE3 as TSE3
from vulcan_tpu_torch.io import synthetic as tsyn
from vulcan_tpu_torch.utils import evaluate as tev

from ._torch_port import se3_t, t

# SE3 math is a few float32 ops deep; 2e-6 covers the ulp differences of
# sin/cos/arccos between XLA and PyTorch's CPU kernels.
SE3_TOL = 2e-6


def test_config_fields_and_defaults_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(P.Config)]
    assert tf == jf
    assert dataclasses.asdict(P.TINY) == dataclasses.asdict(J_TINY)
    assert P.Config().block_extent == JConfig().block_extent


def test_config_post_init_checks_match_reference():
    for bad in (dict(hash_size=1000), dict(max_visible=1000), dict(ray_far=13.0)):
        with pytest.raises(AssertionError):
            JConfig(**bad)
        with pytest.raises(AssertionError):
            P.Config(**bad)


def _twists():
    rng = np.random.default_rng(11)
    xi = rng.normal(0.0, 0.4, (64, 6)).astype(np.float32)
    # Rows 0-15 sit inside the small-angle series branch (theta^2 < 1e-4),
    # rows 16-23 right above it.
    xi[:16, :3] *= 1e-4 / np.linalg.norm(xi[:16, :3], axis=1, keepdims=True)
    xi[16:24, :3] *= 1.2e-2 / np.linalg.norm(xi[16:24, :3], axis=1, keepdims=True)
    return xi


def test_se3_exp_matches_reference_including_series_branch():
    xi = _twists()
    j = JSE3.exp(jnp.asarray(xi))
    p = TSE3.exp(t(xi))
    np.testing.assert_allclose(p.rotation.numpy(), np.asarray(j.rotation), atol=SE3_TOL)
    np.testing.assert_allclose(
        p.translation.numpy(), np.asarray(j.translation), atol=SE3_TOL
    )


def test_se3_log_matches_reference_and_roundtrips():
    xi = _twists()
    j = JSE3.exp(jnp.asarray(xi))
    p = se3_t(j)
    lp = p.log().numpy()
    lj = np.asarray(j.log())
    assert np.all(np.isfinite(lp))
    # log is ill-conditioned near theta=0 in float32 (arccos of ~1):
    # compare in the twist space with a tolerance of a few 1e-4 rad there.
    np.testing.assert_allclose(lp, lj, atol=5e-4)
    np.testing.assert_allclose(lp[24:], xi[24:], atol=1e-4)


def test_se3_near_identity_log_is_finite():
    """The NaN the series branch fixes: log() of a near-identity delta."""
    xi = np.zeros((1, 6), np.float32)
    xi[0, 0] = 1e-5
    d = TSE3.exp(t(xi))
    delta = d @ TSE3.identity().inverse()
    assert np.all(np.isfinite(delta.log().numpy()))


def test_se3_compose_inverse_apply_match_reference():
    xi = _twists()[24:26]
    a_j, b_j = JSE3.exp(jnp.asarray(xi[0])), JSE3.exp(jnp.asarray(xi[1]))
    a_t, b_t = se3_t(a_j), se3_t(b_j)
    rng = np.random.default_rng(2)
    pts = rng.normal(0.0, 2.0, (100, 3)).astype(np.float32)
    for pj, pt in ((a_j @ b_j, a_t @ b_t), (a_j.inverse(), a_t.inverse())):
        np.testing.assert_allclose(pt.rotation.numpy(), np.asarray(pj.rotation), atol=SE3_TOL)
        np.testing.assert_allclose(
            pt.translation.numpy(), np.asarray(pj.translation), atol=SE3_TOL
        )
        np.testing.assert_allclose(
            pt.apply(t(pts)).numpy(), np.asarray(pj.apply(jnp.asarray(pts))),
            atol=1e-5,
        )


def test_camera_matches_reference():
    cj = JCam.create(517.3, 516.5, 318.6, 255.3)
    ct = P.PinholeCamera.tum_default()
    for sj, st in (
        (cj, ct),
        (cj.scaled(0.5), ct.scaled(0.5)),
        (cj.scaled(0.5).scaled(0.5), ct.scaled(0.5).scaled(0.5)),
        (cj.subsampled(2), ct.subsampled(2)),
    ):
        # Intrinsics are bit-identical float32 values.
        assert [float(getattr(sj, k)) for k in ("fx", "fy", "cx", "cy")] == [
            getattr(st, k) for k in ("fx", "fy", "cx", "cy")
        ]
    rng = np.random.default_rng(4)
    pts = rng.normal(0.0, 1.0, (500, 3)).astype(np.float32)
    pts[:10, 2] = -1.0   # behind the camera: -1e9 sentinel
    np.testing.assert_allclose(
        ct.project(t(pts)).numpy(), np.asarray(cj.project(jnp.asarray(pts))),
        rtol=1e-6,
    )
    uv = rng.uniform(0, 600, (500, 2)).astype(np.float32)
    d = rng.uniform(0.5, 4.0, 500).astype(np.float32)
    np.testing.assert_allclose(
        ct.unproject(t(uv), t(d)).numpy(),
        np.asarray(cj.unproject(jnp.asarray(uv), jnp.asarray(d))),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_array_equal(
        ct.pixel_grid(6, 8).numpy(), np.asarray(cj.pixel_grid(6, 8))
    )
    np.testing.assert_allclose(
        ct.rays(48, 64).numpy(), np.asarray(cj.rays(48, 64)), rtol=1e-6
    )


def test_synthetic_scene_and_ate_match_reference():
    jp = jsyn.orbit_poses(5, (0.1, 0.0, 0.0), radius=1.6, height=0.35, span=1.0)
    tp = tsyn.orbit_poses(5, (0.1, 0.0, 0.0), radius=1.6, height=0.35, span=1.0)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.rotation.numpy(), np.asarray(b.rotation))
        np.testing.assert_array_equal(a.translation.numpy(), np.asarray(b.translation))
    cj = JCam.create(160.0, 160.0, 99.5, 74.5)
    ct = P.PinholeCamera.create(160.0, 160.0, 99.5, 74.5)
    spheres = (((0.0, 0.0, 0.0), 0.5), ((0.6, 0.3, 0.2), 0.25))
    dj, colj = jsyn.render_scene_depth(cj, jp[2], 150, 200, spheres, -0.6)
    dt, colt = tsyn.render_scene_depth(ct, tp[2], 150, 200, spheres, -0.6,
                                       device="cpu")
    np.testing.assert_array_equal(dt.numpy() > 0, np.asarray(dj) > 0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(colt.numpy(), np.asarray(colj), atol=1e-5)
    noisy_j = jsyn.add_depth_noise(np.asarray(dj), np.random.default_rng(9))
    noisy_t = tsyn.add_depth_noise(dt.numpy(), np.random.default_rng(9))
    assert np.mean(np.abs(noisy_t - noisy_j) > 1e-3) < 1e-3
    rng = np.random.default_rng(10)
    gt = rng.normal(size=(40, 3))
    est = gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + 0.3
    est += rng.normal(scale=1e-3, size=est.shape)
    assert tev.ate_rmse(est, gt) == pytest.approx(jev.ate_rmse(est, gt), rel=1e-12)
    for a, b in zip(tev.horn_align(est, gt), jev.horn_align(est, gt)):
        np.testing.assert_allclose(a, b, atol=1e-12)
