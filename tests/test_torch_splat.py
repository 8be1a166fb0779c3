"""The splat renderer (kernel K2's module) held against the JAX package."""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import splat as jsplat
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.ops import splat as tsplat

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, fused_orbit_volumes, jflat, no_kernel, se3_t, t,
)


@pytest.fixture(scope="module")
def holed_zbuf():
    """tests/test_sparse.py's kernel input: 25% +inf holes."""
    rng = np.random.default_rng(5)
    d = rng.uniform(0.5, 3.0, (48, 128)).astype(np.float32)
    d[rng.random((48, 128)) < 0.25] = np.inf
    return d


def test_fill_smooth_matches_reference_math(holed_zbuf):
    ref = np.asarray(jsplat._fill_smooth_math(jnp.asarray(holed_zbuf), J_TINY))
    out = tsplat._fill_and_smooth(t(holed_zbuf), P.TINY).numpy()
    # Min/max are exact and the smoothing sum runs in the reference's
    # order: filled pixels are identical, smoothed ones within an ulp.
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_fill_smooth_matches_reference_pallas_interpret(holed_zbuf):
    ref = np.asarray(
        jsplat._fill_smooth_pallas(jnp.asarray(holed_zbuf), J_TINY, interpret=True)
    )
    out = tsplat._fill_and_smooth(t(holed_zbuf), P.TINY).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_cpu_tensor_takes_plain_fill_smooth_and_counts_no_launch(holed_zbuf, no_kernel):
    out = tsplat._fill_and_smooth(t(holed_zbuf), P.TINY)
    np.testing.assert_array_equal(
        out.numpy(), tsplat._fill_smooth_math(t(holed_zbuf), P.TINY).numpy()
    )


@pytest.mark.parametrize("rounds", range(10))
def test_fill_smooth_plan_covers_every_round_once(rounds):
    """K2's launch plan: the launches' rounds add up to ``rounds``, only the
    last launch smooths, every fill-only launch takes the kernel's largest
    round count, and up to that count it is one launch."""
    top = cuda_kernels.FILL_SMOOTH_MAX_ROUNDS
    plan = cuda_kernels.fill_smooth_plan(rounds)
    assert sum(r for r, _ in plan) == rounds
    assert [smooth for _, smooth in plan] == [False] * (len(plan) - 1) + [True]
    assert all(r == top for r, _ in plan[:-1])
    assert 0 <= plan[-1][0] <= top
    assert len(plan) == (1 if rounds <= top else -(-rounds // top))


def test_fill_smooth_plan_matches_the_kernel_and_refuses_negative_rounds():
    src = (Path(tsplat.__file__).parents[1] / "csrc" / "fill_smooth.cu").read_text()
    assert int(re.search(r"kMaxRounds = (\d+);", src).group(1)) == (
        cuda_kernels.FILL_SMOOTH_MAX_ROUNDS)
    with pytest.raises(ValueError, match="rounds"):
        cuda_kernels.fill_smooth_plan(-1)


@pytest.mark.parametrize("rounds", [0, 1, 2, 5])
def test_fill_smooth_launch_by_launch_matches_reference(holed_zbuf, rounds):
    """The plain version of one K2 launch, applied launch by launch as the
    plan splits ``rounds``, equals the port's and the JAX package's whole
    ``_fill_smooth_math``."""
    cfg_t = dataclasses.replace(P.TINY, splat_fill_rounds=rounds)
    cfg_j = dataclasses.replace(J_TINY, splat_fill_rounds=rounds)
    d = t(holed_zbuf)
    for r, smooth in cuda_kernels.fill_smooth_plan(rounds):
        d = tsplat._fill_smooth_steps(d, cfg_t.trunc_dist, r, smooth)
    got = d.numpy()
    np.testing.assert_array_equal(got, tsplat._fill_smooth_math(t(holed_zbuf), cfg_t).numpy())
    ref = np.asarray(jsplat._fill_smooth_math(jnp.asarray(holed_zbuf), cfg_j))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def fused_volume():
    """The reference's volume after fusing two orbit frames at their true
    poses, with the visible list of the second."""
    jv, _, pose_j, _ = fused_orbit_volumes()
    return jv, pose_j


def test_surfel_block_list_exact(fused_volume):
    jv, _ = fused_volume
    tv = tB.VolumeState(**{k: t(v) for k, v in jflat(jv).items()})
    ids_j, n_j = jsplat._surfel_block_list(jv, CFG_J)
    ids_t, n_t = tsplat._surfel_block_list(tv, CFG_T)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert int(n_t) == int(n_j) > 0


def test_render_splat_matches_reference(fused_volume):
    """Depth-mode render (``with_color=False``) of one volume state at a
    novel pose, slightly off the fused trajectory."""
    jv, pose_j = fused_volume
    tv = tB.VolumeState(**{k: t(v) for k, v in jflat(jv).items()})
    pose_t = se3_t(pose_j)
    # Re-run visibility on both sides from the carried state (exact).
    jv = jal.update_visibility(jv, CAM_J, pose_j, H, W, CFG_J)
    tv = tal.update_visibility(tv, CAM_T, pose_t, H, W, CFG_T)
    rj = jsplat.render_splat(jv, CAM_J, pose_j, H, W, CFG_J, with_color=False)
    rt = tsplat.render_splat(tv, CAM_T, pose_t, H, W, CFG_T, with_color=False)

    zj = np.asarray(jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, CFG_J))
    zt = tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T).numpy()
    # The z-buffer is a scatter-min of rounded surfel projections: a
    # projection within an ulp of a pixel boundary (the reference fuses
    # the rotation's a*b+c into FMAs, PyTorch's CPU ops do not) lands one
    # pixel over.  At most 0.1% of pixels may differ, by < 2 voxels.
    assert np.mean(np.isfinite(zt) != np.isfinite(zj)) < 1e-3
    both = np.isfinite(zt) & np.isfinite(zj)
    assert np.mean(np.abs(zt[both] - zj[both]) > 1e-5) < 1e-3
    assert np.abs(zt[both] - zj[both]).max() < 2 * CFG_T.voxel_size

    valid_j, valid_t = np.asarray(rj.valid), rt.valid.numpy()
    assert valid_j.sum() > 0.3 * H * W
    assert np.mean(valid_j != valid_t) < 1e-3
    both = valid_j & valid_t
    for name, tol, frac in (("depth", 1e-5, 2e-3), ("vx", 1e-5, 2e-3),
                            ("vy", 1e-5, 2e-3), ("vz", 1e-5, 2e-3),
                            ("nx", 1e-3, 5e-3), ("ny", 1e-3, 5e-3),
                            ("nz", 1e-3, 5e-3)):
        a = getattr(rt, name).numpy()[both]
        b = np.asarray(getattr(rj, name))[both]
        # The hole fill and smoothing compare depths against 2 mu and
        # mu/2: an ulp on either side flips a pixel's choice (a filled or
        # averaged depth up to ~1 cm away; normals follow through the 3x3
        # windows).  Hold the bulk to float32 rounding, the rest to 0.2%
        # of pixels (0.5% for the normals' wider footprint).
        assert np.mean(np.abs(a - b) > tol) < frac, name
    np.testing.assert_array_equal(rt.color.numpy(), np.zeros((H, W, 3), np.float32))


def _carried(fused_volume):
    """The fused volume on both sides, visibility re-run at its pose."""
    jv, pose_j = fused_volume
    tv = tB.VolumeState(**{k: t(v) for k, v in jflat(jv).items()})
    pose_t = se3_t(pose_j)
    jv = jal.update_visibility(jv, CAM_J, pose_j, H, W, CFG_J)
    tv = tal.update_visibility(tv, CAM_T, pose_t, H, W, CFG_T)
    return jv, tv, pose_j, pose_t


def test_luma_zbuffer_words_match_reference(fused_volume):
    """The packed ``zq19 << 12 | luma12`` scatter-min: the words are equal
    but where a surfel's projection or its depth/luma rounding sits within
    an ulp of a boundary (the reference's compiled loop fuses FMAs): at
    most 0.1% of pixels.  Decoding is exact."""
    jv, tv, pose_j, pose_t = _carried(fused_volume)
    wj = np.asarray(jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, CFG_J,
                                               luma=True))
    wt = tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T, luma=True)
    assert wt.dtype == torch.int32
    hit = wj != tsplat._LUMA_EMPTY
    assert hit.mean() > 0.3
    assert np.mean(wt.numpy() != wj) < 1e-3
    for a, b in zip(tsplat._decode_luma_zbuf(wt, CFG_T),
                    jsplat._decode_luma_zbuf(jnp.asarray(wj), CFG_J)):
        np.testing.assert_array_equal(a.numpy()[wt.numpy() == wj],
                                      np.asarray(b)[wt.numpy() == wj])
    # Within one 9.5 um bin of the float32 z-buffer's depth.
    z = tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T).numpy()
    d, _ = tsplat._decode_luma_zbuf(wt, CFG_T)
    same = np.isfinite(z) & np.isfinite(d.numpy())
    assert np.abs(d.numpy()[same] - z[same]).max() <= 2 * CFG_T.ray_far / tsplat._ZQ_MAX


def test_rgb_zbuffer_matches_reference(fused_volume):
    """The two-pass rgb888 form: the z-buffer as the depth-only one, the
    colour words equal but at the boundary fraction."""
    jv, tv, pose_j, pose_t = _carried(fused_volume)
    zj, cj = jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, CFG_J,
                                        with_color=True)
    zt, ct = tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T,
                                        with_color=True)
    np.testing.assert_array_equal(
        zt.numpy(), tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T).numpy())
    cj = np.asarray(cj)
    assert (cj >= 0).mean() > 0.3
    assert np.mean(ct.numpy() != cj) < 1e-3
    np.testing.assert_array_equal(ct.numpy() >= 0, np.isfinite(zt.numpy()))


@pytest.mark.parametrize("space", ["luma", "rgb"])
def test_render_splat_color_matches_reference(fused_volume, space):
    """The model colour after diffusion into hole-filled pixels: equal to
    1e-6 but for the boundary pixels and their 3x3 diffusion footprint
    (0.5%); the luma render is grey."""
    jv, tv, pose_j, pose_t = _carried(fused_volume)
    rj = jsplat.render_splat(jv, CAM_J, pose_j, H, W, CFG_J, with_color=True,
                             color_space=space)
    rt = tsplat.render_splat(tv, CAM_T, pose_t, H, W, CFG_T, with_color=True,
                             color_space=space)
    cj, ct = np.asarray(rj.color), rt.color.numpy()
    assert np.mean(np.asarray(rj.valid) != rt.valid.numpy()) < 1e-3
    assert (cj.sum(-1) > 0).mean() > 0.3
    assert np.mean(np.any(np.abs(ct - cj) > 1e-6, axis=-1)) < 5e-3
    np.testing.assert_array_equal(ct[~rt.valid.numpy()], 0.0)
    if space == "luma":
        np.testing.assert_array_equal(ct[..., 0], ct[..., 2])
