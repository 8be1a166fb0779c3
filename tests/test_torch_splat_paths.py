"""The splat renderer's paths off the surfel default, held against the JAX
package: the surface block list, the direct and the render-cache
z-buffers, and ``render_splat`` with the direct source, cache colour,
the trilinear polish and gradient normals."""
import dataclasses

import jax
import numpy as np
import pytest

from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import render_cache as jrc
from vulcan_tpu.ops import splat as jsplat
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import render_cache as trc
from vulcan_tpu_torch.ops import splat as tsplat

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, fused_orbit_volumes, no_kernel,
)

MAPS = ("depth", "vx", "vy", "vz", "nx", "ny", "nz")


@pytest.fixture(scope="module")
def volumes():
    """The fused volume on both sides, visibility re-run at its pose."""
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    jv = jal.update_visibility(jv, CAM_J, pose_j, H, W, CFG_J)
    tv = tal.update_visibility(tv, CAM_T, pose_t, H, W, CFG_T)
    return jv, tv, pose_j, pose_t


def assert_zbuf_close(zt, zj):
    """Scatter-min z-buffers: a projection within an ulp of a pixel
    boundary (the reference's compiled loop fuses the rotation's a*b+c
    into FMAs) lands one pixel over.  The hit masks and the depths (to
    1e-5 m) agree on 99.9% of pixels, the rest within 2 voxels."""
    zt, zj = np.asarray(zt), np.asarray(zj)
    assert np.isfinite(zj).mean() > 0.3
    assert np.mean(np.isfinite(zt) != np.isfinite(zj)) <= 1e-3
    both = np.isfinite(zt) & np.isfinite(zj)
    assert np.mean(np.abs(zt[both] - zj[both]) > 1e-5) <= 1e-3
    assert np.abs(zt[both] - zj[both]).max() < 2 * CFG_T.voxel_size


def test_surface_block_list_exact(volumes):
    jv, tv, _, _ = volumes
    ids_j, n_j = jsplat._surface_block_list(jv, CFG_J)
    ids_t, n_t = tsplat._surface_block_list(tv, CFG_T)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert int(n_t) == int(n_j) > 0


def test_direct_zbuffer_matches_reference(volumes):
    jv, tv, pose_j, pose_t = volumes
    zj = jax.jit(jsplat._splat_zbuf_direct, static_argnums=(3, 4, 5))(
        jv, CAM_J, pose_j, H, W, CFG_J)
    assert_zbuf_close(tsplat._splat_zbuf_direct(tv, CAM_T, pose_t, H, W, CFG_T).numpy(),
                      zj)


def test_direct_zbuffer_matches_surfels(volumes):
    """With no surfel overflow, the direct source and the persistent
    surfels scatter the same voxel set under the same back-face cull: the
    hit masks are equal everywhere, and the depths differ only by the
    surfels' 14-bit tsdf quantization (mu / 16383 a step), as in the
    reference
    (tests/test_sparse.py ``test_splat_surfels_matches_direct``)."""
    jv, tv, pose_j, pose_t = volumes
    assert int(tv.surf_overflow) == 0
    za = tsplat._splat_zbuf_direct(tv, CAM_T, pose_t, H, W, CFG_T).numpy()
    zb = tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T).numpy()
    hit = np.isfinite(za)
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(hit, np.isfinite(zb))
    assert np.abs(za[hit] - zb[hit]).max() < 1e-5


def test_cached_zbuffer_matches_reference(volumes):
    jv, tv, pose_j, pose_t = volumes
    cj = jrc.build(jv, CFG_J)
    zj = jax.jit(jsplat._splat_zbuf_cached, static_argnums=(4, 5, 6))(
        jv, cj, CAM_J, pose_j, H, W, CFG_J)
    ct = trc.build(tv, CFG_T)
    assert_zbuf_close(
        tsplat._splat_zbuf_cached(tv, ct, CAM_T, pose_t, H, W, CFG_T).numpy(), zj)


# (name, Config overrides, render_splat keywords): each a different branch
# of the dispatch; "surfels+cache" passes a cache in, which the reference
# takes as a request for the cached z-buffer and nearest colour.
PATHS = {
    "direct": (dict(splat_source="direct"), dict(with_color=False)),
    "direct-rgb": (dict(splat_source="direct"), dict(with_color=True)),
    "polish": (dict(splat_polish=2), dict(with_color=False)),
    "polish-rgb": (dict(splat_polish=2), dict(with_color=True)),
    "gradient": ({}, dict(with_color=False, normals="gradient")),
    "surfels+cache": ({}, dict(with_color=True, cache=True)),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_render_splat_path_matches_reference(volumes, path, no_kernel):
    """Masks on 99.9% of pixels; depth and vertices within 1e-5 m on all
    but 0.2% (a hole-fill or smoothing choice flips where a neighbour
    sits within an ulp of 2 mu or mu/2); normals within 1e-3 on all but
    0.5% (their 3x3 footprint); colour exact on 99.9%."""
    jv, tv, pose_j, pose_t = volumes
    over, kw = PATHS[path]
    cfg_j = dataclasses.replace(CFG_J, **over)
    cfg_t = dataclasses.replace(CFG_T, **over)
    kw_j, kw_t = dict(kw), dict(kw)
    if kw.get("cache"):
        kw_j["cache"] = jrc.build(jv, cfg_j)
        kw_t["cache"] = trc.build(tv, cfg_t)
    rj = jax.jit(lambda v, p, c: jsplat.render_splat(
        v, CAM_J, p, H, W, cfg_j, **dict(kw_j, cache=c)))(jv, pose_j, kw_j.get("cache"))
    rt = tsplat.render_splat(tv, CAM_T, pose_t, H, W, cfg_t, **kw_t)
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    assert vj.mean() > 0.3
    assert np.mean(vj != vt) <= 1e-3
    both = vj & vt
    for name in MAPS:
        a, b = getattr(rt, name).numpy()[both], np.asarray(getattr(rj, name))[both]
        tol, frac = (1e-3, 5e-3) if name.startswith("n") else (1e-5, 2e-3)
        assert np.mean(np.abs(a - b) > tol) <= frac, name
    cj, ct = np.asarray(rj.color), rt.color.numpy()
    assert np.mean(np.any(ct != cj, axis=-1)) <= 1e-3
    if kw["with_color"]:
        assert (ct.sum(-1) > 0).mean() > 0.3
    else:
        assert not ct.any()


def test_polish_moves_depth_within_its_bracket(volumes):
    """The polish re-solves the cached z-buffer's depth from trilinear
    samples inside a +-2 voxel bracket along the ray: it moves most
    pixels, none by more than the bracket."""
    _, tv, _, pose_t = volumes
    ct = trc.build(tv, CFG_T)
    base = tsplat.render_splat(tv, CAM_T, pose_t, H, W, CFG_T, cache=ct)
    pol = tsplat.render_splat(tv, CAM_T, pose_t, H, W,
                              dataclasses.replace(CFG_T, splat_polish=2), cache=ct)
    both = base.valid.numpy() & pol.valid.numpy()
    dz = np.abs(pol.depth.numpy()[both] - base.depth.numpy()[both])
    assert (dz > 0).mean() > 0.5 and dz.max() <= 2 * CFG_T.voxel_size + 1e-6
