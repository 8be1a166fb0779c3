"""The illumination model (``ops/light.py``) and light-mode tracking held
against the JAX package: the unit tests of tests/test_light.py run on the
port, the estimate against the reference's, and the light-mode pipeline
step against ``fusion.step``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu import Pipeline as JPipeline
from vulcan_tpu.ops import light as jlight
from vulcan_tpu_torch.ops import light
from vulcan_tpu_torch.pipeline import fusion as tfusion
from vulcan_tpu_torch.utils.convert import (
    pipeline_state_from_numpy,
    pipeline_state_to_numpy,
)

from ._torch_port import (
    CAM_J, CFG_J, CFG_T, H, W, jflat, orbit, rot_angle, scene, t,
)

E0 = np.eye(9, dtype=np.float32)[0]
TRUE = np.array([1.1, 0.3, -0.2, 0.15, 0.05, -0.04, 0.08, 0.02, -0.06], np.float32)


def _random_normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _relit(rng, side=64):
    """Random normals and albedo, and the live image under TRUE's gain."""
    n = _random_normals(rng, side * side).reshape(side, side, 3)
    albedo = rng.uniform(0.2, 0.9, size=(side, side)).astype(np.float32)
    b = light.sh_basis(*(t(n[..., i]) for i in range(3)))
    live = t(albedo) * sum(float(c) * bk for c, bk in zip(TRUE, b))
    return n, albedo, live.numpy()


def test_sh_estimation_recovers_coeffs():
    """Noise-free linear model: estimation is exact (up to the ridge), and
    the Light API reproduces the live image from the model."""
    n, albedo, live = _relit(np.random.default_rng(3))
    ones = torch.ones((64, 64), dtype=torch.bool)
    est = light.estimate_gain(t(n), t(albedo), t(live), ones, ridge=1e-6)
    np.testing.assert_allclose(est.numpy(), TRUE, atol=1e-3)
    L = P.Light.estimate(t(n), t(albedo), t(live), ones, ridge=1e-6)
    np.testing.assert_allclose(L.shade(t(n), t(albedo)).numpy(), live, atol=1e-3)


def test_identity_gain_under_constant_lighting():
    """live == model collapses to (almost exactly) unit gain."""
    rng = np.random.default_rng(5)
    n = t(_random_normals(rng, 1024).reshape(32, 32, 3))
    albedo = t(rng.uniform(0.1, 1.0, size=(32, 32)).astype(np.float32))
    est = light.estimate_gain(n, albedo, albedo, torch.ones((32, 32), dtype=torch.bool))
    np.testing.assert_allclose(est.numpy(), E0, atol=1e-4)
    np.testing.assert_allclose(light.gain(n, est).numpy(), 1.0, atol=1e-4)


def test_degenerate_normals_ridge_fallback():
    """One normal direction constrains one gain value; the ridge pins the
    other 8 DoF to the unit-gain prior and the constrained gain matches."""
    n = torch.tensor([0.0, 0.0, 1.0]).expand(32, 32, 3)
    albedo = torch.full((32, 32), 0.5)
    est = light.estimate_gain(n, albedo, 0.8 * albedo,
                              torch.ones((32, 32), dtype=torch.bool))
    assert bool(torch.isfinite(est).all())
    g = float(light.gain(n, est)[0, 0])
    assert abs(g - 0.8) < 0.05, g


def test_no_samples_returns_unit_gain():
    z = torch.zeros((16, 16))
    est = light.estimate_gain(torch.zeros((16, 16, 3)), z, z,
                              torch.zeros((16, 16), dtype=torch.bool))
    np.testing.assert_array_equal(est.numpy(), E0)


def test_unit_coeffs_scale_is_identity():
    rng = np.random.default_rng(9)
    n = t(_random_normals(rng, 256).reshape(16, 16, 3))
    s = tuple(t(rng.normal(size=(16, 16)).astype(np.float32)) for _ in range(5))
    s += (torch.ones((16, 16), dtype=torch.bool),)
    out = light.scale_photo_samples(s, n, light.unit_coeffs())
    for a, b in zip(out[:3], s[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert out[3] is s[3] and out[4] is s[4] and out[5] is s[5]


@pytest.mark.parametrize("case", ["relit", "constant", "masked", "ridge", "empty"])
def test_estimate_gain_matches_reference(case):
    """The 54 stacked sums and the ridge-regularized 9x9 Cholesky solve
    against the reference's on the same inputs: within 1e-5."""
    rng = np.random.default_rng(21)
    n, albedo, live = _relit(rng)
    weight = np.ones((64, 64), bool)
    ridge = 3e-2
    if case == "constant":
        live = albedo.copy()
    elif case == "masked":
        weight = rng.random((64, 64)) < 0.3
        live = live + rng.normal(0.0, 0.01, live.shape).astype(np.float32)
    elif case == "ridge":
        ridge = 1e-6
    elif case == "empty":
        weight = rng.random((64, 64)) < 0.01          # under 64 samples
    ref = np.asarray(jlight.estimate_gain(
        jnp.asarray(n), jnp.asarray(albedo), jnp.asarray(live), jnp.asarray(weight),
        ridge))
    got = light.estimate_gain(t(n), t(albedo), t(live), t(weight), ridge).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if case == "empty":
        np.testing.assert_array_equal(got, E0)


def test_gain_and_scaled_samples_match_reference():
    rng = np.random.default_rng(2)
    n = _random_normals(rng, 1024).reshape(32, 32, 3)
    # ny = -1 gives -3.4, ny = 1 gives 4.6: the gain clips at both ends.
    coeffs = np.array([1.0, 4.0, 0.5, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0], np.float32)
    ref = np.asarray(jlight.gain(jnp.asarray(n), jnp.asarray(coeffs)))
    got = light.gain(t(n), t(coeffs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.min() == 0.0 and got.max() == 4.0
    s = tuple(rng.normal(size=(32, 32)).astype(np.float32) for _ in range(5))
    s += (np.ones((32, 32), bool),)
    sj = jlight.scale_photo_samples(tuple(map(jnp.asarray, s)), jnp.asarray(n),
                                    jnp.asarray(coeffs))
    st = light.scale_photo_samples(tuple(map(t, s)), t(n), t(coeffs))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    ident = P.Light.identity()
    np.testing.assert_array_equal(ident.coeffs.numpy(), E0)
    np.testing.assert_array_equal(ident.shade(t(n), t(s[0])).numpy(), s[0])


@pytest.fixture(scope="module")
def light_run():
    """The reference pipeline in light mode over 4 orbit frames."""
    poses = orbit(4)
    frames = [scene(p) for p in poses]
    pipe = JPipeline(CFG_J, CAM_J, H, W, init_pose=poses[0], mode="light")
    states = [jflat(pipe.state)]
    for d, c in frames:
        pipe.process(d, c)
        states.append(jflat(pipe.state))
    return frames, states


def test_light_step_matches_reference(light_run):
    """One port step in light mode from each of the reference's states:
    the pose within 1e-4 m and 1e-4 rad of the reference's next state."""
    frames, states = light_run
    for i, (d, c) in enumerate(frames):
        ts = tfusion.step(pipeline_state_from_numpy(states[i], CFG_T), t(d), t(c),
                          CFG_T, "light")
        got, ref = pipeline_state_to_numpy(ts), states[i + 1]
        np.testing.assert_allclose(
            got["model.pose.translation"], ref["model.pose.translation"], atol=1e-4
        )
        assert rot_angle(got["model.pose.rotation"], ref["model.pose.rotation"]) < 1e-4
        for name in ("frame_idx", "track_failures", "track_degen_frames"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(got["track_level_inliers"] > 0,
                                      ref["track_level_inliers"] > 0)
        assert np.mean(got["model.valid"] != ref["model.valid"]) < 2e-3
    assert int(states[-1]["track_failures"]) == 0
