"""The render cache (``ops/render_cache.py``) held against the JAX package:
every array of ``build`` and each sampler, on a fused orbit volume."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulcan_tpu.ops import render_cache as jrc
from vulcan_tpu_torch.ops import render_cache as trc
from vulcan_tpu_torch.utils.convert import render_cache_from_numpy, render_cache_to_numpy

from ._torch_port import CAM_T, CFG_J, CFG_T, H, W, fused_orbit_volumes, jflat, scene, t

FIELDS = ("grid", "grid_min", "tsdf", "march", "row_block", "overflow")


@pytest.fixture(scope="module")
def caches():
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    cj = jax.jit(jrc.build, static_argnums=1)(jv, CFG_J)
    return jv, tv, cj, trc.build(tv, CFG_T), pose_j, pose_t


def test_build_matches_reference_exactly(caches):
    """Every array of the cache, bit for bit: the halos are copies of the
    volume's voxels and the march texture rounds them half to even."""
    _, tv, cj, ct, _, _ = caches
    for name in FIELDS:
        a, b = getattr(ct, name).numpy(), np.asarray(getattr(cj, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    n = int(tv.num_visible)
    assert n > 100 and int(ct.overflow) == 0
    assert (ct.grid.numpy() > 0).sum() == n
    # Every visible block's halo row holds observed voxels.
    assert (ct.march.numpy()[729:(n + 1) * 729] != trc.MARCH_UNSEEN).mean() > 0.1


def test_build_counts_blocks_outside_the_grid(caches):
    """A grid too small for the visible set drops rows into ``overflow``
    (never silently), as the reference counts them."""
    jv, tv, _, _, _, _ = caches
    cfg_j = dataclasses.replace(CFG_J, render_grid_size=4)
    cfg_t = dataclasses.replace(CFG_T, render_grid_size=4)
    cj = jax.jit(jrc.build, static_argnums=1)(jv, cfg_j)
    ct = trc.build(tv, cfg_t)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)), err_msg=name)
    assert int(ct.overflow) > 0


def test_cache_roundtrips_through_numpy(caches):
    _, _, cj, ct, _, _ = caches
    back = render_cache_from_numpy(jflat(cj))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      getattr(ct, name).numpy(), err_msg=name)
    assert set(render_cache_to_numpy(ct)) == set(FIELDS)


@pytest.fixture(scope="module")
def surface_points(caches):
    """World points within two voxels of the scene's surface as seen from
    the render pose, per axis (float32), plus far-off and unseen ones."""
    _, _, _, _, pose_j, pose_t = caches
    d, _ = scene(pose_j)
    rng = np.random.default_rng(11)
    rays = CAM_T.rays(H, W).numpy() * d[..., None]
    pts = rays @ pose_t.rotation.numpy().T + pose_t.translation.numpy()
    pts = pts + rng.uniform(-2, 2, pts.shape) * CFG_T.voxel_size
    pts[::7] = rng.uniform(-4, 4, pts[::7].shape)   # outside the band/grid
    pts = pts.astype(np.float32)
    return pts[..., 0], pts[..., 1], pts[..., 2]


@jax.jit
def _reference_samples(cj, vol, px, py, pz):
    inv = 1.0 / CFG_J.voxel_size
    gx, gy, gz = (jnp.round(a * inv).astype(jnp.int32) for a in (px, py, pz))
    return dict(
        march=jrc.sample_march_texture(cj, gx, gy, gz, CFG_J),
        tri=jrc.sample_trilinear_axes(cj, px, py, pz, CFG_J),
        mtri=jrc.sample_march_trilinear_axes(cj, px, py, pz, CFG_J),
        color=jrc.sample_color_nearest_axes(cj, vol, px, py, pz, CFG_J),
        grad=jrc.sample_gradient_axes(cj, px, py, pz, CFG_J),
    )


@pytest.fixture(scope="module")
def samples(caches, surface_points):
    jv, tv, cj, ct, _, _ = caches
    ref = _reference_samples(cj, jv, *(jnp.asarray(a) for a in surface_points))
    px, py, pz = (t(a) for a in surface_points)
    inv = 1.0 / CFG_T.voxel_size
    g = [trc.round_to_int(a * inv) for a in (px, py, pz)]
    got = dict(
        march=trc.sample_march_texture(ct, *g, CFG_T),
        tri=trc.sample_trilinear_axes(ct, px, py, pz, CFG_T),
        mtri=trc.sample_march_trilinear_axes(ct, px, py, pz, CFG_T),
        color=trc.sample_color_nearest_axes(ct, tv, px, py, pz, CFG_T),
        grad=trc.sample_gradient_axes(ct, px, py, pz, CFG_T),
    )
    return ref, got


def test_sample_march_texture_exact(samples):
    ref, got = samples
    np.testing.assert_array_equal(got["march"].numpy(), np.asarray(ref["march"]))
    assert (got["march"].numpy() != trc.MARCH_UNSEEN).mean() > 0.3


@pytest.mark.parametrize("name", ["tri", "mtri"])
def test_trilinear_samplers_match_reference(samples, name):
    """The observed mask is exact (the corners are the same integer
    reads); the value is an 8-term sum the reference's compiled loop may
    fuse into FMAs: within 1e-6 (mu units)."""
    ref, got = samples
    (vj, okj), (vt, okt) = ref[name], got[name]
    okj, okt = np.asarray(okj), okt.numpy()
    np.testing.assert_array_equal(okt, okj)
    assert okj.mean() > 0.3
    np.testing.assert_allclose(vt.numpy()[okj], np.asarray(vj)[okj], rtol=0, atol=1e-6)


def test_sample_color_nearest_exact(samples):
    ref, got = samples
    (cj, okj), (ct, okt) = ref["color"], got["color"]
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert np.asarray(okj).mean() > 0.2


def test_sample_gradient_matches_reference(samples):
    """Gradient normals: the mask exact, unit normals within 1e-4 (a
    difference of trilinear sums over a voxel, normalized)."""
    ref, got = samples
    okj, okt = np.asarray(ref["grad"][3]), got["grad"][3].numpy()
    np.testing.assert_array_equal(okt, okj)
    assert okj.mean() > 0.3
    for a, b in zip(got["grad"][:3], ref["grad"][:3]):
        np.testing.assert_allclose(a.numpy()[okj], np.asarray(b)[okj], rtol=0, atol=1e-4)
    n = np.stack([a.numpy()[okt] for a in got["grad"][:3]])
    np.testing.assert_allclose(np.linalg.norm(n, axis=0), 1.0, atol=1e-5)


def test_cpu_build_reads_the_count_once(caches):
    from vulcan_tpu_torch.utils.sync import read_int

    _, tv, _, _, _, _ = caches
    before = read_int.count
    trc.build(tv, CFG_T)
    assert read_int.count - before == 1
