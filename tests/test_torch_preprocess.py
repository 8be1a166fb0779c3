"""Preprocessing (kernel K1's module) held against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import preprocess as jpp
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.core.se3 import SE3 as TSE3
from vulcan_tpu_torch.ops import preprocess as tpp

from ._torch_port import CAM_J, CAM_T, H, W, orbit, scene, t

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


def test_cpu_tensor_takes_plain_bilateral_and_counts_no_launch(holed_depth):
    before = tpp.bilateral_filter.launches
    out = tpp.bilateral_filter(t(holed_depth), P.TINY)
    assert tpp.bilateral_filter.launches == before == 0
    np.testing.assert_array_equal(
        out.numpy(), tpp._bilateral_math(t(holed_depth), P.TINY).numpy()
    )


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
