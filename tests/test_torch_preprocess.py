"""Preprocessing (kernel K1's module) held against the JAX package."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import preprocess as jpp
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.core.se3 import SE3 as TSE3
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.ops import preprocess as tpp

from ._torch_port import CAM_J, CAM_T, H, W, no_kernel, orbit, scene, t

# exp() of XLA and of PyTorch's CPU kernel differ in the last ulp for
# ~10% of inputs; through the 25-tap weighted mean that stays below
# 1e-6 relative on 0.5-3 m depths.
BILATERAL_RTOL = 1e-6


@pytest.fixture(scope="module")
def holed_depth():
    """tests/test_preprocess.py's kernel input: 10% zero holes."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 3.0, (64, 128)).astype(np.float32)
    depth[rng.random((64, 128)) < 0.1] = 0.0
    return depth


def test_bilateral_matches_reference_math(holed_depth):
    ref = np.asarray(jpp._bilateral_math(jnp.asarray(holed_depth), J_TINY))
    out = tpp.bilateral_filter(t(holed_depth), P.TINY).numpy()
    np.testing.assert_allclose(out, ref, rtol=BILATERAL_RTOL, atol=1e-6)
    # Invalid centres stay exactly 0, valid ones stay valid.
    np.testing.assert_array_equal(out == 0.0, holed_depth == 0.0)


def test_bilateral_matches_reference_pallas_interpret(holed_depth):
    ref = np.asarray(
        jpp._bilateral_pallas(jnp.asarray(holed_depth), J_TINY, interpret=True)
    )
    out = tpp.bilateral_filter(t(holed_depth), P.TINY).numpy()
    np.testing.assert_allclose(out, ref, rtol=BILATERAL_RTOL, atol=1e-6)


def test_cpu_tensor_takes_plain_bilateral_and_counts_no_launch(holed_depth, no_kernel):
    out = tpp.bilateral_filter(t(holed_depth), P.TINY)
    np.testing.assert_array_equal(
        out.numpy(), tpp._bilateral_math(t(holed_depth), P.TINY).numpy()
    )


# The kernel's folded weight, exp2(diff^2 * neg_a + neg_s), against the
# reference's two exponentials: the folded argument rounds to 2^-24 of
# itself (|arg| < 30 for a tap that still carries weight), so a weight is
# off by about 3e-6 of itself and the weighted mean of depths that lie
# within a few sigma_depth of each other by well under 2e-6 m.
FOLDED_ATOL = 2e-6


def stepped_slope():
    """A sloped surface with a 0.5 m step down the middle, mm noise and 5%
    zero holes: taps across the step carry (almost) no weight."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:128].astype(np.float32)
    d = 1.2 + 0.004 * xx + 0.002 * yy + 0.5 * (xx > 64)
    d = (d + rng.normal(0.0, 0.002, d.shape)).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    return d


@pytest.mark.parametrize("surface", ["holed", "step"])
def test_folded_bilateral_within_error_budget(holed_depth, surface):
    depth = holed_depth if surface == "holed" else stepped_slope()
    got = tpp._bilateral_math_folded(t(depth), P.TINY).numpy()
    plain = tpp._bilateral_math(t(depth), P.TINY).numpy()
    ref = np.asarray(jpp._bilateral_math(jnp.asarray(depth), J_TINY))
    assert np.abs(got - plain).max() <= FOLDED_ATOL
    assert np.abs(got - ref).max() <= FOLDED_ATOL
    np.testing.assert_array_equal(got == 0.0, depth == 0.0)
    # the filter did something: valid pixels moved, by less than the noise band
    moved = np.abs(got - depth)[depth > 0]
    assert 0 < moved.max() < 1.0


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_folded_bilateral_at_other_radii(holed_depth, radius):
    cfg = dataclasses.replace(P.TINY, bilateral_radius=radius)
    got = tpp._bilateral_math_folded(t(holed_depth), cfg).numpy()
    plain = tpp._bilateral_math(t(holed_depth), cfg).numpy()
    assert np.abs(got - plain).max() <= FOLDED_ATOL


def test_bilateral_constants_are_built_once_per_setting():
    k = tpp._bilateral_constants(P.TINY)
    assert tpp._bilateral_constants(dataclasses.replace(P.TINY, icp_iters=(1, 1, 1))) is k
    hits = cuda_kernels.bilateral_constants.cache_info().hits
    again = tpp._bilateral_constants(P.TINY)
    assert again is k and again.array is k.array
    assert cuda_kernels.bilateral_constants.cache_info().hits == hits + 1
    assert len(k.neg_s) == len(k.array) == (2 * k.radius + 1) ** 2
    assert list(k.array) == list(k.neg_s)
    assert k.pointer.value == cuda_kernels.ctypes.addressof(k.array)


@pytest.mark.parametrize("field,value", [
    ("bilateral_radius", 3), ("bilateral_sigma_space", 1.5), ("bilateral_sigma_depth", 0.1)])
def test_bilateral_constants_follow_the_setting(field, value):
    base = tpp._bilateral_constants(P.TINY)
    k = tpp._bilateral_constants(dataclasses.replace(P.TINY, **{field: value}))
    assert k is not base
    assert (k.radius, k.neg_a, k.neg_s) != (base.radius, base.neg_a, base.neg_s)
    cfg = dataclasses.replace(P.TINY, **{field: value})
    # the spatial part is the reference's exp(-(dy^2+dx^2) / (2 sigma_s^2)) to 1 ulp
    r = cfg.bilateral_radius
    offsets = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    assert len(k.neg_s) == len(offsets)
    for neg_s, (dy, dx) in zip(k.neg_s, offsets):
        want = math.exp(-(dy * dy + dx * dx) / (2.0 * cfg.bilateral_sigma_space**2))
        assert abs(2.0**neg_s - want) <= 2.0**-23 * want
    assert k.neg_a == np.float32(-math.log2(math.e) / (2.0 * cfg.bilateral_sigma_depth**2))


def test_bilateral_constants_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="radius"):
        cuda_kernels.bilateral_constants(5, 2.0, 0.05)
    with pytest.raises(ValueError, match="sigma_depth"):
        cuda_kernels.bilateral_constants(2, 2.0, 1e18)


def test_build_pyramid_levels_match_reference():
    pose = orbit(2)[1]
    d, c = scene(pose)
    jpyr = jpp.build_pyramid(
        make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose), J_TINY,
        with_intensity=False,
    )
    tpyr = tpp.build_pyramid(
        Frame(t(d), t(c), CAM_T, TSE3.identity()), P.TINY
    )
    assert len(tpyr) == len(jpyr) == P.TINY.pyramid_levels
    for lj, lt in zip(jpyr, tpyr):
        assert lt.depth.shape == lj.depth.shape
        assert (lt.camera.fx, lt.camera.cx) == (float(lj.camera.fx), float(lj.camera.cx))
        np.testing.assert_allclose(
            lt.depth.numpy(), np.asarray(lj.depth), rtol=BILATERAL_RTOL, atol=1e-6
        )
        np.testing.assert_allclose(
            lt.vertices.numpy(), np.asarray(lj.vertices), rtol=1e-5, atol=1e-6
        )
        # Normals are forward-difference cross products of ~mm vertex
        # steps: a 1-ulp depth difference moves them by up to ~1e-3 on
        # steep silhouettes.  Hold the bulk tight and the tail loose.
        nj, nt = np.asarray(lj.normals), lt.normals.numpy()
        np.testing.assert_array_equal(
            np.any(nt != 0, axis=-1), np.any(nj != 0, axis=-1)
        )
        err = np.abs(nt - nj).max(axis=-1)
        assert np.mean(err > 1e-4) < 0.01
        assert err.max() < 5e-2


def test_downsample_and_normals_match_reference():
    rng = np.random.default_rng(8)
    depth = rng.uniform(1.0, 1.2, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    np.testing.assert_array_equal(
        tpp.downsample_depth(t(depth), P.TINY).numpy(),
        np.asarray(jpp.downsample_depth(jnp.asarray(depth), J_TINY)),
    )
    jv = jpp.compute_vertex_map(jnp.asarray(depth), CAM_J)
    tv = tpp.compute_vertex_map(t(depth), CAM_T)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tpp.compute_normal_map(tv).numpy(),
        np.asarray(jpp.compute_normal_map(jnp.asarray(tv.numpy()))),
        atol=1e-4,
    )
