"""The track's Gauss-Newton loop held against the JAX package: the plain
versions of its entry points, H1a ``icp_associate`` (``associate_depth``
and the flat ``color_assoc``), H1b ``icp_rows`` (the 29 stacked sums of
``_pp_normal_eqs`` and ``color_rows_fixed``), H1c ``icp_solve``
(``solve_gn``, ``SE3.exp`` and ``_min_eig_normalized``) and the fused step
``icp_rows_solve`` (H1b then H1c), then ``track`` through them in every
mode and with either kind of reducer.  The CUDA kernels behind the entry
points run on the card only (``chip_smoke.py`` phase 2 holds them against
these plain versions); here the C signatures are held against their
ctypes bindings, and the kernels' grids against the wrapper's
constants."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulcan_tpu.core.frame import FrameMaps as JFrameMaps
from vulcan_tpu.core.se3 import SE3 as JSE3
from vulcan_tpu.ops import icp as jicp
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.ops import icp as ticp

from ._torch_port import CFG_J, CFG_T, photo_track_inputs, rot_angle, se3_t, t

STRIDES = ticp._level_strides(CFG_T)
AT = {"init": 2, "truth": 3}     # orbit poses: the render's, the live frame's


def _level(level):
    """(reference live maps at the level's stride, reference model maps,
    the port's LevelInputs with the photometric term)."""
    inp = photo_track_inputs()
    m, st = inp["live_j"][level], STRIDES[level]
    live_j = JFrameMaps(m.depth[::st, ::st], m.vertices[::st, ::st],
                        m.normals[::st, ::st], m.intensity[::st, ::st], m.camera)
    lv = ticp.level_inputs(inp["live_t"][level], inp["mt"][level], st, ticp.LOCAL,
                           photo=True)
    return live_j, inp["mj"][level], lv


def _vec(H, b, e, c):
    """The 29 stacked sums of a reference (H, b, err, cnt)."""
    v = np.zeros(29, np.float64)
    H = np.asarray(H, np.float64).reshape(-1)
    for k, pos in enumerate(ticp._HMAP):
        v[pos] = H[k]
    v[ticp._BMAP] = np.asarray(b)
    v[27], v[28] = float(e), float(c)
    return v


def _assert_sums(got, want):
    """A 29-vector within 1e-5 of its largest entry (the count aside,
    which is exact): thousands of float32 rows summed in another order.
    The rhs entries sum signed residuals and cancel, so their own scale is
    not the scale of their rounding error; measured here: <= 4e-7 of the
    largest entry."""
    got = got.numpy().astype(np.float64)
    np.testing.assert_allclose(got[:28], want[:28], rtol=0,
                               atol=1e-5 * np.abs(want[:28]).max())
    assert got[28] == want[28] > 50


@pytest.mark.parametrize("at", list(AT))
def test_associate_plain_matches_reference(at):
    """H1a's plain version against ``associate_depth`` and the flat
    ``color_assoc`` at every level: both validity masks exact, the decoded
    model vertex and normal bit-equal where both associate, the photometric
    samples within 1e-5, the warp points u0/v0 within 1e-4 pixel.  The
    port sums each transform row left to right, one rounding an operation,
    where the reference's dot rounds otherwise: the points part by ulps
    (~1e-7 m at 2 m), the pixel coordinates by up to 4 ulps (3e-5 pixel
    measured).  On this scene no mask entry flips (a flip needs a
    coordinate within ulps of .5 or of an integer): the share is 0.  Every
    output is contiguous, as H1b's checks require."""
    pose_j = photo_track_inputs()["poses"][AT[at]]
    pose_v = ticp._pose_vector(se3_t(pose_j))
    for level in range(3):
        live_j, mj, lv = _level(level)
        (v_m, n_m, ok), samples = ticp._associate_plain(lv, pose_v, CFG_T, True, True)
        vj, nj, okj = jicp.associate_depth(live_j, mj, pose_j, CFG_J)
        sj = jicp.color_assoc(live_j, mj, jicp.intensity_grads(mj.intensity), pose_j,
                              CFG_J)
        # Contiguous, as H1b takes them (the card feeds it either's output).
        assert all(x.is_contiguous() for x in (v_m, n_m, ok, *samples))
        ok, okc = ok.numpy(), samples[5].numpy()
        np.testing.assert_array_equal(ok, np.asarray(okj))
        np.testing.assert_array_equal(okc, np.asarray(sj[5]))
        assert ok.sum() > 50 and okc.sum() > 50
        np.testing.assert_array_equal(v_m.numpy()[ok], np.asarray(vj)[ok])
        np.testing.assert_array_equal(n_m.numpy()[ok], np.asarray(nj)[ok])
        for a, b in zip(samples[:3], sj[:3]):
            np.testing.assert_allclose(a.numpy()[okc], np.asarray(b)[okc], rtol=0, atol=1e-5)
        for a, b in zip(samples[3:5], sj[3:5]):
            np.testing.assert_allclose(a.numpy()[okc], np.asarray(b)[okc], rtol=0, atol=1e-4)


@pytest.mark.parametrize("live_normals", [False, True], ids=["step", "detector"])
def test_rows_plain_matches_reference(live_normals):
    """H1b's plain version, from the reference's own correspondences and
    samples at the render's pose, against the reference's
    ``_fused_normal_eqs`` of ``_pp_normal_eqs`` (with ``live_normals`` the
    detector's rows) and of ``color_rows_fixed``: both 29-vectors at every
    level (``_assert_sums``)."""
    pose_j = photo_track_inputs()["poses"][AT["init"]]
    pose_v = ticp._pose_vector(se3_t(pose_j))
    for level in range(3):
        live_j, mj, lv = _level(level)
        vj, nj, okj = jicp.associate_depth(live_j, mj, pose_j, CFG_J)
        sj = jicp.color_assoc(live_j, mj, jicp.intensity_grads(mj.intensity), pose_j,
                              CFG_J)
        got = ticp._rows_plain(lv, pose_v, (t(vj), t(nj), t(okj)),
                               tuple(t(x) for x in sj), CFG_T, True, True, live_normals)
        geo = jicp._pp_normal_eqs(live_j, vj, nj, okj, pose_j, CFG_J,
                                  live_normals=live_normals)
        pho = jicp._fused_normal_eqs(*jicp.color_rows_fixed(live_j, sj, mj, pose_j, CFG_J))
        assert got.shape == (2, 29)
        _assert_sums(got[0], _vec(*geo))
        _assert_sums(got[1], _vec(*pho))
        # One term alone leaves the other's row zero and its own unchanged.
        alone = ticp._rows_plain(lv, pose_v, (t(vj), t(nj), t(okj)), None, CFG_T, True,
                                 False, live_normals)
        assert np.array_equal(alone[0].numpy(), got[0].numpy()) and not alone[1].any()
        # The sums of the products' magnitudes (chip_smoke's error scale
        # for H1b) bound every sum, and equal it bit for bit where no
        # product is negative: H's diagonal, the error, the count.
        mag = ticp._rows_plain(lv, pose_v, (t(vj), t(nj), t(okj)),
                               tuple(t(x) for x in sj), CFG_T, True, True, live_normals,
                               magnitudes=True).numpy()
        g = got.numpy()
        assert (mag >= np.abs(g) * (1.0 - 1e-6)).all()
        same_sign = [ticp._HMAP[7 * a] for a in range(6)] + [27, 28]
        np.testing.assert_array_equal(mag[:, same_sign], g[:, same_sign])


def _real_sums():
    """The (2, 29) sums of the middle level at the render's pose."""
    pose_j = photo_track_inputs()["poses"][AT["init"]]
    live_j, mj, lv = _level(1)
    pose_v = ticp._pose_vector(se3_t(pose_j))
    corr, samples = ticp._associate_plain(lv, pose_v, CFG_T, True, True)
    return ticp._rows_plain(lv, pose_v, corr, samples, CFG_T, True, True).numpy()


@pytest.mark.parametrize("case", ["combined", "color", "zero", "indefinite", "few"])
def test_solve_plain_matches_reference(case):
    """H1c's plain version against the reference's ``solve_gn``, the
    ``c >= 6`` gate, ``SE3.exp(delta) @ pose`` and ``_min_eig_normalized``
    of the summed and of the geometric matrix, within 1e-4 relative.  A
    zero H, an indefinite H and fewer than 6 inliers each give a zero step
    (the pose bit-equal to the input); the first two score 0."""
    geometric = case != "color"
    sums = _real_sums()
    if case == "color":
        sums[0] = 0.0
    elif case == "zero":
        sums[:] = 0.0
    elif case == "indefinite":
        sums[:] = 0.0
        sums[0] = _vec(-np.eye(6), np.ones(6), 1.0, 100.0)
    elif case == "few":
        sums[0, 28] = 5.0
    pose_j = photo_track_inputs()["poses"][AT["init"]]
    pose_v = ticp._pose_vector(se3_t(pose_j))
    step = ticp._solve_plain(t(sums), pose_v, CFG_T.icp_damping, geometric, True).numpy()
    det = ticp._solve_plain(t(sums), pose_v, CFG_T.icp_damping, geometric, True,
                            detect=True).numpy()

    def unpack(v):
        H = np.asarray([v[i] for i in ticp._HMAP], np.float32).reshape(6, 6)
        return H, np.asarray([v[i] for i in ticp._BMAP], np.float32)

    (Hg, bg), (Hc, bc) = unpack(sums[0]), unpack(sums[1])
    e, c = sums[0 if geometric else 1, 27:29]
    delta = jicp.solve_gn(jnp.asarray(Hg + Hc), jnp.asarray(bg + bc), CFG_J.icp_damping)
    delta = jnp.where(c >= 6.0, delta, 0.0)
    want = JSE3.exp(delta) @ pose_j
    np.testing.assert_allclose(step[:9], np.asarray(want.rotation).ravel(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(step[9:12], np.asarray(want.translation), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(step[12], e / max(c, 1.0), rtol=1e-6)
    assert step[13] == c
    deg = float(jicp._min_eig_normalized(jnp.asarray(Hg + Hc)))
    deg_geo = float(jicp._min_eig_normalized(jnp.asarray(Hg))) if geometric else 1.0
    np.testing.assert_allclose(det[14:], [deg, deg_geo], rtol=1e-4)
    np.testing.assert_array_equal(det[:14], pose_v.numpy()[:14])
    if case in ("zero", "indefinite", "few"):
        np.testing.assert_array_equal(step[:12], pose_v.numpy()[:12])
    else:
        assert np.abs(step[9:12] - pose_v.numpy()[9:12]).max() > 1e-4
    if case in ("zero", "indefinite"):
        assert det[14] == 0.0 and det[15] == 0.0


def _reference_step(geo, pho, pose_j, geometric, detect):
    """The reference's GN step (or level scores) on its own stacked sums:
    ``solve_gn`` of Hg + Hc, the ``c >= 6`` gate and ``SE3.exp(delta) @
    pose``, or ``_min_eig_normalized`` of the summed and geometric H."""
    (Hg, bg, eg, cg), (Hc, bc, ec, cc) = geo, pho
    H = jnp.asarray(Hg) + jnp.asarray(Hc)
    if detect:
        deg = float(jicp._min_eig_normalized(H))
        return deg, float(jicp._min_eig_normalized(jnp.asarray(Hg))) if geometric else 1.0
    e, c = (eg, cg) if geometric else (ec, cc)
    delta = jicp.solve_gn(H, jnp.asarray(bg) + jnp.asarray(bc), CFG_J.icp_damping)
    return JSE3.exp(jnp.where(c >= 6.0, delta, 0.0)) @ pose_j, float(e), float(c)


@pytest.mark.parametrize("detect", [False, True], ids=["step", "scores"])
@pytest.mark.parametrize("mode", ["combined", "color"])
def test_rows_solve_plain_matches_reference(mode, detect):
    """The fused step's plain path (``icp_rows_solve`` on CPU tensors) at
    every level, from the reference's own correspondences and samples,
    against the reference's ``_fused_normal_eqs`` of ``_pp_normal_eqs``
    (the detector's rows for the scores) and of ``color_rows_fixed``, then
    ``solve_gn``, the ``c >= 6`` gate and ``SE3.exp`` (a step) or
    ``_min_eig_normalized`` of the summed and the geometric matrix (the
    scores): its sums as ``_assert_sums``, its pose and scores within 1e-4
    relative, as test_solve_plain_matches_reference; and equal to
    ``_solve_plain(_rows_plain(...))`` bit for bit."""
    geometric = mode != "color"
    pose_j = photo_track_inputs()["poses"][AT["init"]]
    pose_v = ticp._pose_vector(se3_t(pose_j))
    for level in range(3):
        live_j, mj, lv = _level(level)
        vj, nj, okj = jicp.associate_depth(live_j, mj, pose_j, CFG_J)
        sj = jicp.color_assoc(live_j, mj, jicp.intensity_grads(mj.intensity), pose_j,
                              CFG_J)
        corr = (t(vj), t(nj), t(okj)) if geometric else None
        samples = tuple(t(x) for x in sj)
        sums, got = ticp.icp_rows_solve(lv, pose_v, corr, samples, CFG_T, geometric, True,
                                        detect)
        plain = ticp._rows_plain(lv, pose_v, corr, samples, CFG_T, geometric, True, detect)
        assert torch.equal(sums, plain)
        assert torch.equal(got, ticp._solve_plain(plain, pose_v, CFG_T.icp_damping,
                                                  geometric, True, detect))
        zero = (np.zeros((6, 6)), np.zeros(6), 0.0, 0.0)
        geo = (jicp._pp_normal_eqs(live_j, vj, nj, okj, pose_j, CFG_J,
                                   live_normals=detect) if geometric else zero)
        pho = jicp._fused_normal_eqs(*jicp.color_rows_fixed(live_j, sj, mj, pose_j, CFG_J))
        if geometric:
            _assert_sums(sums[0], _vec(*geo))
        else:
            assert not sums[0].any()
        _assert_sums(sums[1], _vec(*pho))
        got = got.numpy()
        want = _reference_step(geo, pho, pose_j, geometric, detect)
        if detect:
            np.testing.assert_allclose(got[14:], want, rtol=1e-4)
            np.testing.assert_array_equal(got[:14], pose_v.numpy()[:14])
            continue
        new, e, c = want
        np.testing.assert_allclose(got[:9], np.asarray(new.rotation).ravel(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got[9:12], np.asarray(new.translation), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got[12], e / max(c, 1.0), rtol=1e-4)
        np.testing.assert_allclose(got[13], c, rtol=1e-4)


class _PassThrough(ticp.Reducer):
    """A reducer with nothing to add, counting its calls: ``track`` must
    then take the rows, the reducer and the solve, not the fused step."""

    def __init__(self):
        self.calls = 0

    def __call__(self, sums):
        self.calls += 1
        return sums


@pytest.mark.parametrize("mode", ["depth", "combined"])
def test_track_local_and_other_reducer_agree(mode, monkeypatch):
    """``track`` with ``LOCAL`` runs every GN step and level score through
    the fused ``icp_rows_solve`` and never through ``icp_rows`` /
    ``icp_solve``; with another reducer (one that adds nothing) it runs
    each through ``icp_rows``, the reducer, then ``icp_solve``, calling the
    reducer once a GN step and once a level score; the two give the same
    track bit for bit."""
    calls = dict.fromkeys(("icp_rows", "icp_solve", "icp_rows_solve"), 0)
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(ticp, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ticp, name, counted)
    inp = photo_track_inputs()
    init = se3_t(inp["poses"][2])
    rounds = [max(1, min(a, i)) for a, i in zip(CFG_T.icp_assoc, CFG_T.icp_iters)]
    steps = sum(r * -(-i // r) for r, i in zip(rounds, CFG_T.icp_iters))
    steps += CFG_T.pyramid_levels

    local = ticp.track(inp["live_t"], inp["mt"], init, CFG_T, mode)
    assert calls == {"icp_rows": 0, "icp_solve": 0, "icp_rows_solve": steps}
    calls.update(dict.fromkeys(calls, 0))
    other = _PassThrough()
    got = ticp.track(inp["live_t"], inp["mt"], init, CFG_T, mode, reduce=other)
    assert calls == {"icp_rows": steps, "icp_solve": steps, "icp_rows_solve": 0}
    assert other.calls == steps
    for name in ("error", "inliers", "valid", "level_error", "level_inliers",
                 "level_degen", "min_degen", "geo_degen"):
        assert torch.equal(getattr(got, name), getattr(local, name)), name
    assert torch.equal(got.pose.rotation, local.pose.rotation)
    assert torch.equal(got.pose.translation, local.pose.translation)


@pytest.mark.parametrize("mode", ["depth", "color", "combined", "light"])
def test_track_through_entry_points_matches_reference(mode, monkeypatch):
    """``track`` in each mode runs every association round, GN step and
    level score through the three entry points (counted) and matches the
    reference's ``track`` at the tolerances of tests/test_torch_icp.py
    (depth) and tests/test_torch_photo.py (the photometric modes)."""
    calls = dict.fromkeys(("_associate_plain", "_rows_plain", "_solve_plain"), 0)
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(ticp, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ticp, name, counted)
    inp = photo_track_inputs()
    init_j = inp["poses"][2]
    rj = jax.jit(jicp.track, static_argnums=(3, 4))(inp["live_j"], inp["mj"], init_j,
                                                    CFG_J, mode)
    rt = ticp.track(inp["live_t"], inp["mt"], se3_t(init_j), CFG_T, mode)

    rounds = [max(1, min(a, i)) for a, i in zip(CFG_T.icp_assoc, CFG_T.icp_iters)]
    steps = sum(r * -(-i // r) for r, i in zip(rounds, CFG_T.icp_iters))
    levels = CFG_T.pyramid_levels
    assert calls == {"_associate_plain": sum(rounds), "_rows_plain": steps + levels,
                     "_solve_plain": steps + levels}
    if mode == "depth":
        tol, inl_rtol = 1e-5, 2e-3
        np.testing.assert_allclose(rt.pose.rotation.numpy(), np.asarray(rj.pose.rotation),
                                   atol=1e-5)
        np.testing.assert_allclose(rt.level_error.numpy(), np.asarray(rj.level_error),
                                   rtol=1e-3)
    else:
        tol, inl_rtol = 1e-4, 5e-3
        assert rot_angle(rt.pose.rotation.numpy(), rj.pose.rotation) < 1e-4
    np.testing.assert_allclose(rt.pose.translation.numpy(), np.asarray(rj.pose.translation),
                               atol=tol)
    assert bool(rt.valid) == bool(rj.valid)
    np.testing.assert_allclose(rt.level_inliers.numpy(), np.asarray(rj.level_inliers),
                               rtol=inl_rtol)
    np.testing.assert_allclose(rt.level_degen.numpy(), np.asarray(rj.level_degen), rtol=1e-3)
    for name in ("min_degen", "geo_degen"):
        np.testing.assert_allclose(float(getattr(rt, name)), float(getattr(rj, name)),
                                   rtol=1e-3, err_msg=name)
    if mode != "color":
        truth = np.asarray(inp["poses"][3].translation)
        assert np.abs(rt.pose.translation.numpy() - truth).max() < 5e-3


def test_rows_grid_is_a_function_of_the_pixel_count():
    """H1b's grid, and so the order its CTAs' sums meet in, is one cluster
    of 16 CTAs of 512 threads whatever the pixel count: the constants the
    wrapper states are the source's."""
    text = (cuda_kernels.CSRC / "icp.cu").read_text()
    for name, value in (("kRowsThreads", cuda_kernels.ICP_ROWS_THREADS),
                        ("kRowsCluster", cuda_kernels.ICP_ROWS_CLUSTER)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert "cfg.gridDim = dim3(kRowsCluster);" in text
    assert "clusterDim.x = kRowsCluster;" in text


def test_associate_grid_fills_the_card_at_the_finest_level():
    """H1a takes ICP_ASSOC_PIXELS pixels a thread in blocks of
    ICP_ASSOC_THREADS (the source's constants, and its launch's grid), so
    the finest level of a 480x640 frame (240x320 at stride 2) makes more
    blocks than the H100's 132 SMs, and every pixel has one thread."""
    text = (cuda_kernels.CSRC / "icp.cu").read_text()
    for name, value in (("kAssocThreads", cuda_kernels.ICP_ASSOC_THREADS),
                        ("kAssocPixels", cuda_kernels.ICP_ASSOC_PIXELS),
                        ("kSolveThreads", cuda_kernels.ICP_SOLVE_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert "constexpr int kAssocBlockPixels = kAssocThreads * kAssocPixels;" in text
    assert "cfg.gridDim = dim3((a.n + kAssocBlockPixels - 1) / kAssocBlockPixels);" in text
    per_block = cuda_kernels.ICP_ASSOC_THREADS * cuda_kernels.ICP_ASSOC_PIXELS
    assert -(-240 * 320 // per_block) == 150 >= 132
    # Thread t of block b takes pixels b * per_block + t + p * threads: every
    # pixel of a block once.
    threads = cuda_kernels.ICP_ASSOC_THREADS
    taken = sorted(t + p * threads for t in range(threads)
                   for p in range(cuda_kernels.ICP_ASSOC_PIXELS))
    assert taken == list(range(per_block))
    assert "const int base = blockIdx.x * kAssocBlockPixels + threadIdx.x;" in text
    assert "base + p * kAssocThreads" in text
    # Two warps for H1c: a level's two scores at once.
    assert cuda_kernels.ICP_SOLVE_THREADS == 64


def test_kernel_signatures_match_the_c_entry_points():
    """Every ctypes binding has the C entry point's parameters, in order
    (a pointer as c_void_p, int, float, a WHILE node's handle as unsigned
    long long): a wrong count or kind would pass garbage to the card, and
    nothing here compiles the sources."""
    text = "".join(p.read_text() for p in sorted(cuda_kernels.CSRC.glob("*.cu")))
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
             "unsigned long long": ctypes.c_ulonglong}
    assert {"vulcan_icp_associate", "vulcan_icp_rows", "vulcan_icp_solve",
            "vulcan_icp_rows_solve", "vulcan_graph_while", "vulcan_graph_while_next",
            "vulcan_graph_cond", "vulcan_range_stamp",
            "vulcan_range_expand", "vulcan_integrate",
            "vulcan_splat_zbuf"} <= set(cuda_kernels._SIGNATURES)
    for name, argtypes in cuda_kernels._SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', text, re.S)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        got = [kinds["ptr" if "*" in p else " ".join(p.split()[:-1])] for p in params]
        assert got == list(argtypes), name
