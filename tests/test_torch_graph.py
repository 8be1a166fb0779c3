"""The step's capture form on the CPU: the loops whose bodies take their
chunk's start as a device offset (``utils.sync.chunk_loop``, one WHILE
node each when captured: the integrate loop, the surfel tiers, the render
cache's halo loop, the direct and cached z-buffers) and the ``cond`` that
is one IF/ELSE node (the march's compaction), held against the JAX
package and against the port's eager form, the eager ``cond``, the host
reads a frame, ``Pipeline``'s choice of the graph on the card, and the
state-buffer helpers of ``pipeline/graphs.py``.

A CUDA graph cannot be captured here.  ``sync.capturing`` is forced true
and the conditional nodes replaced by stand-ins.  ``skip`` is the WHILE
node's rule (``csrc/graph.cu``): the body runs while its offset, set to 0
and moved on by a chunk after each body, is below min(count, capacity), so
the chunks past the count are skipped.  ``all`` runs every chunk up to the
capacity (what the masks alone must make harmless: a chunk past the count
writes its rows' old values and scatters into the trash slot).  The
IF/ELSE stand-in runs the true body, as its capture allocates the cond's
outputs, and the false body after it where the predicate is false: for
branches that write only their outputs, as ``cond`` requires, that leaves
what a replay leaves."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import raycast as jray
from vulcan_tpu.ops import render_cache as jrc
from vulcan_tpu.ops import sparse as jsp
from vulcan_tpu.ops import splat as jsplat
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.core.se3 import SE3
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import raycast as tray
from vulcan_tpu_torch.ops import render_cache as trc
from vulcan_tpu_torch.ops import sparse as tsp
from vulcan_tpu_torch.ops import splat as tsplat
from vulcan_tpu_torch.pipeline import api, fusion, graphs
from vulcan_tpu_torch.utils import sync

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, fused_orbit_volumes, jflat, orbit, scene,
    se3_t, t,
)


def while_node(count, bound, chunk, body):
    """The WHILE node's rule: offset 0, then ``chunk`` more after each body,
    while below min(count, bound)."""
    offset = torch.zeros((), dtype=torch.int64)
    while offset < torch.clamp(count, max=bound):
        body(offset)
        offset += chunk


def while_all(count, bound, chunk, body):
    """Every chunk up to the capacity."""
    for offset in torch.arange(0, bound, chunk):
        body(offset)


def cond_node(pred, *branches):
    """One IF/ELSE node: the true body, then the false one where ``pred``
    is false (see the module's docstring)."""
    assert pred.dtype == torch.bool and pred.ndim == 0 and len(branches) == 2
    branches[0]()
    if not bool(pred):
        branches[1]()


STAND_INS = {"skip": while_node, "all": while_all}


@pytest.fixture(params=sorted(STAND_INS))
def captured(request, monkeypatch):
    """``sync.capturing()`` true, the conditional nodes replaced by
    stand-ins."""
    monkeypatch.setattr(sync, "capturing", lambda: True)
    monkeypatch.setattr(sync, "_while_node", STAND_INS[request.param])
    monkeypatch.setattr(sync, "_cond_node", cond_node)
    return request.param


@functools.lru_cache(maxsize=None)
def _band_frame():
    """The reference's volume after allocation and visibility of orbit
    frame 1, with the frame and its band list (the integrate inputs)."""
    pose = orbit(2)[1]
    d, c = scene(pose)
    frame = make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
    jv = jB.create_volume(CFG_J)
    jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
    jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
    return jv, frame, np.asarray(band), int(n_band), d, c, pose


@pytest.fixture
def band_frame():
    return _band_frame()


# Work counts at ``integrate_chunk=64``: none, one row, one partial chunk,
# a chunk less one row, one chunk, one row into the second chunk, an exact
# multiple (two chunks), the frame's own count, the list's whole capacity
# (entries past the band are block 0, masked by ``ids > 0``), and a count
# past the capacity.
CHUNK = 64
COUNTS = ("zero", "one", "partial", "chunk-1", "chunk", "chunk+1", "multiple", "band",
          "capacity", "overflow")


def _count(name: str, n_band: int, capacity: int) -> int:
    return {"zero": 0, "one": 1, "partial": 37, "chunk-1": CHUNK - 1, "chunk": CHUNK,
            "chunk+1": CHUNK + 1, "multiple": 2 * CHUNK, "band": n_band,
            "capacity": capacity, "overflow": capacity + CHUNK + 1}[name]


@functools.lru_cache(maxsize=None)
def _reference_integrate(count: int):
    """The reference's integrate of ``band_frame`` at ``count`` (capped at
    the list's capacity: past it the reference's clamped slice would fuse
    its last chunk again, where the port's loop stops at the list's end)."""
    jv, frame_j, band, *_ = _band_frame()
    count = min(count, band.shape[0])
    return jflat(jsp.integrate_sparse(jv, frame_j, CFG_J, ids=jnp.asarray(band),
                                      count=jnp.asarray(count, jnp.int32)))


@pytest.mark.parametrize("which", COUNTS)
def test_integrate_upper_bound_form_matches_reference(band_frame, captured, which):
    """The capture form of the integrate loop (at most alloc_capacity / 64 =
    128 chunks at ``integrate_chunk=64``, one WHILE node whose body reads
    its rows at a device offset) fuses what the reference's while_loop
    fuses at every boundary count, at the test_torch_volume tolerances, and
    is bit-equal to the port's eager form (the chunk count read on the
    host)."""
    jv, frame_j, band, n_band, d, c, pose_j = band_frame
    assert n_band > 2 * CHUNK
    count = _count(which, n_band, band.shape[0])
    ref = _reference_integrate(count)
    cfg = dataclasses.replace(CFG_T, integrate_chunk=CHUNK)
    frame = Frame(t(d), t(c), CAM_T, se3_t(pose_j))

    def fuse():
        tv = tB.VolumeState(**{k: t(v) for k, v in jflat(jv).items()})
        return tsp.integrate_sparse(tv, frame, cfg, ids=t(band),
                                    count=torch.tensor(count, dtype=torch.int32))

    got = fuse()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = fuse()
        assert sync.read_int.count - reads == 1
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(eager, f.name)), f.name
    np.testing.assert_allclose(got.tsdf.numpy(), ref["tsdf"], atol=2e-6)
    assert np.mean(got.surfpack.numpy() != ref["surfpack"]) <= 1e-3
    assert np.mean(got.colorpack.numpy() != ref["colorpack"]) <= 1e-3
    for name in ("weight", "surf_count", "mesh_dirty", "surf_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name], err_msg=name)
    fused = int((got.weight.numpy() > 0).any(axis=1).sum())
    assert (fused == 0) == (count == 0)


@pytest.fixture(scope="module")
def splat_inputs():
    """The fused orbit volume on both sides at two visible-list capacities:
    the default, and 512 blocks (the surfel list then fills its capacity,
    one chunk of each tier exactly)."""
    jv0, _, pose_j, pose_t = fused_orbit_volumes()
    out = {}
    for cap in (CFG_T.max_visible, 512):
        cfg_j = dataclasses.replace(CFG_J, max_visible=cap)
        cfg_t = dataclasses.replace(CFG_T, max_visible=cap)
        # The visible list at this capacity, from the carried arrays (the
        # list's length is the only field it changes).
        arrays = {k: v for k, v in jflat(jv0).items()
                  if k not in ("visible_ids", "num_visible")}
        jv = jal.update_visibility(
            dataclasses.replace(jv0, visible_ids=jnp.zeros((cap,), jnp.int32),
                                num_visible=jnp.asarray(0, jnp.int32)),
            CAM_J, pose_j, H, W, cfg_j)
        tv = tB.VolumeState(**{k: t(v) for k, v in arrays.items()},
                            visible_ids=torch.zeros(cap, dtype=torch.int32),
                            num_visible=torch.zeros((), dtype=torch.int32))
        tv = tal.update_visibility(tv, CAM_T, pose_t, H, W, cfg_t)
        out[cap] = (jv, tv, cfg_j, cfg_t)
    return out, pose_j, pose_t


@pytest.mark.parametrize("cap", [CFG_T.max_visible, 512])
def test_surfel_tiers_upper_bound_form_match_reference(splat_inputs, captured, cap):
    """Both surfel tiers in capture form (at most max_visible / 2048 and /
    512 chunks, one WHILE node each) for the depth, packed luma and rgb
    z-buffers: bit-equal to the eager form (one counted read of the two
    tier lengths) and within test_torch_splat's tolerances of the
    reference."""
    by_cap, pose_j, pose_t = splat_inputs
    jv, tv, cfg_j, cfg_t = by_cap[cap]
    ids, n_surf = tsplat._surfel_block_list(tv, cfg_t)
    n_surf = int(n_surf)
    assert 0 < n_surf <= cap

    def zbufs():
        return (tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, cfg_t),
                tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, cfg_t, luma=True),
                *tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, cfg_t,
                                            with_color=True))

    got = zbufs()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = zbufs()
        assert sync.read_int.count - reads == 3
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    zj = np.asarray(jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, cfg_j))
    wj = np.asarray(jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, cfg_j, luma=True))
    zt, wt, _, ct = (x.numpy() for x in got)
    assert np.mean(np.isfinite(zt) != np.isfinite(zj)) < 1e-3
    both = np.isfinite(zt) & np.isfinite(zj)
    assert both.mean() > 0.05
    assert np.mean(np.abs(zt[both] - zj[both]) > 1e-5) < 1e-3
    assert np.mean(wt != wj) < 1e-3
    np.testing.assert_array_equal(ct >= 0, np.isfinite(zt))


# Tier list lengths: the boundaries of tier 1's chunks of 2048 and tier 2's
# of 512, the list's capacity and a length past it.
TIER_COUNTS = (0, 1, 511, 512, 513, 2047, 2048, 2049, CFG_T.max_visible,
               CFG_T.max_visible + 1)


@functools.lru_cache(maxsize=None)
def _tier_list():
    """A surfel block list of the whole capacity holding only blocks that
    use tier 2's slots (each of the fused orbit's such blocks, again and
    again): at every length both tiers then scatter that many blocks.  A
    block scattered twice writes the same minimum."""
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    ids, n = tsplat._surfel_block_list(tv, CFG_T)
    full = ids[:int(n)][tv.surf_count[ids[:int(n)].long()] > CFG_T.surfel_slots // 2]
    assert 0 < full.numel() < 512
    cap = ids.shape[0]
    return full.repeat(-(-cap // full.numel()))[:cap].clone(), jv, tv, pose_j, pose_t


@functools.lru_cache(maxsize=None)
def _reference_tiers():
    """The reference's depth z-buffer of ``_tier_list`` at a given length,
    one compile for every length."""
    @jax.jit
    def zbuf(jv, pose_j, ids, n):
        saved = jsplat._surfel_block_list
        jsplat._surfel_block_list = lambda volume, config: (ids, n)
        try:
            return jsplat._splat_zbuf_surfels(jv, CAM_J, pose_j, H, W, CFG_J)
        finally:
            jsplat._surfel_block_list = saved

    return zbuf


@pytest.mark.parametrize("count", TIER_COUNTS)
def test_surfel_tier_bodies_match_reference_at_boundary_counts(count, monkeypatch):
    """Both tiers' device-offset bodies at every boundary length of their
    lists, a length past the capacity among them: the depth z-buffer of
    each form (the WHILE stand-in, every chunk, eager) within
    test_torch_splat's tolerances of the reference's at that length (at
    most the capacity), and the three forms' depth, luma and rgb z-buffers
    bit-equal."""
    ids, jv, tv, pose_j, pose_t = _tier_list()
    n = torch.tensor(count, dtype=torch.int32)
    monkeypatch.setattr(tsplat, "_surfel_block_list", lambda volume, config: (ids, n))

    def zbufs():
        return (tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T),
                tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T, luma=True),
                *tsplat._splat_zbuf_surfels(tv, CAM_T, pose_t, H, W, CFG_T,
                                            with_color=True))

    eager = zbufs()
    monkeypatch.setattr(sync, "capturing", lambda: True)
    for stand_in in STAND_INS.values():
        monkeypatch.setattr(sync, "_while_node", stand_in)
        for a, b in zip(zbufs(), eager):
            assert torch.equal(a, b)
    zj = np.asarray(_reference_tiers()(jv, pose_j, jnp.asarray(ids.numpy()),
                                       jnp.asarray(min(count, ids.shape[0]), jnp.int32)))
    zt = eager[0].numpy()
    assert np.mean(np.isfinite(zt) != np.isfinite(zj)) < 1e-3
    assert np.isfinite(zt).any() == (count > 0)
    both = np.isfinite(zt) & np.isfinite(zj)
    assert np.sum(np.abs(zt[both] - zj[both]) > 1e-5) <= 1e-3 * both.sum()


# --- the render paths' loops and the march's compaction branch -----------

V = CFG_T.max_visible
CACHE_C, ZBUF_C = min(2048, V), min(1024, V)   # the loops' chunks
CACHE_FIELDS = ("grid", "grid_min", "tsdf", "march", "row_block", "overflow")


def _boundaries(chunk: int) -> tuple:
    """A loop's boundary counts: none, one row, a chunk less one, one
    chunk, one row into the second chunk, the list's capacity."""
    return 0, 1, chunk - 1, chunk, chunk + 1, V


def _at_count(count: int):
    """The fused orbit volume on both sides, its visible list's length set
    to ``count``: the rows past the real list hold block 0, which
    ``visible_rows`` leaves out (their halos are the null block's)."""
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    return (dataclasses.replace(jv, num_visible=jnp.asarray(count, jnp.int32)),
            dataclasses.replace(tv, num_visible=torch.tensor(count, dtype=torch.int32)),
            pose_j, pose_t)


@jax.jit
def _j_cache_and_zbuf(jv, pose_j):
    cache = jrc.build(jv, CFG_J)
    return cache, jsplat._splat_zbuf_cached(jv, cache, CAM_J, pose_j, H, W, CFG_J)


@functools.lru_cache(maxsize=None)
def _reference_cache_and_zbuf(count: int):
    """The reference's render cache and cached z-buffer at a visible count,
    one compile for every count."""
    jv, _, pose_j, _ = _at_count(count)
    cache, zbuf = _j_cache_and_zbuf(jv, pose_j)
    return jflat(cache), np.asarray(zbuf)


def _assert_zbuf_close(zt, zj, count):
    """test_torch_splat_paths' z-buffer tolerances (hit masks and depths to
    1e-5 m on 99.9% of pixels, the rest within 2 voxels), at any count of
    blocks: none scatters nothing, more than one something (a single
    block may face away)."""
    hit = np.isfinite(zt)
    assert hit.any() == (count > 0) or count == 1
    assert np.mean(hit != np.isfinite(zj)) <= 1e-3
    both = hit & np.isfinite(zj)
    dz = np.abs(zt[both] - zj[both])
    assert np.sum(dz > 1e-5) <= 1e-3 * both.sum()
    assert not both.any() or dz.max() < 2 * CFG_T.voxel_size


@pytest.mark.parametrize("count", _boundaries(CACHE_C))
def test_render_cache_loop_forms_match_reference(captured, count):
    """``render_cache.build``'s halo loop in capture form (chunks of 2048
    visible rows at ``offset + arange(C)``, one WHILE node), at every
    boundary count of the visible list: every array of the cache bit-equal
    to the eager form's (one counted read) and to the reference's, the
    halos of the listed blocks observed and none past them."""
    _, tv, _, _ = _at_count(count)
    got = trc.build(tv, CFG_T)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = trc.build(tv, CFG_T)
        assert sync.read_int.count - reads == 1
    ref, _ = _reference_cache_and_zbuf(count)
    for name in CACHE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(eager, name)), name
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name], err_msg=name)
    n = int(tB.visible_rows(tv).sum())
    seen = (got.march.numpy()[729:] != trc.MARCH_UNSEEN).reshape(V, 729).any(axis=1)
    assert seen[:n].sum() >= 0.5 * n and not seen[n:].any()


@pytest.mark.parametrize("count", _boundaries(ZBUF_C))
def test_cached_zbuffer_loop_forms_match_reference(captured, count):
    """``_splat_zbuf_cached``'s loop in capture form (chunks of 1024 halo
    rows, one past ``offset + arange(C)``, one WHILE node) on the cache of
    the same form, at every boundary count of the visible list: bit-equal
    to the eager form (one counted read each for the cache and the
    z-buffer) and within test_torch_splat_paths' tolerances of the
    reference."""
    _, tv, _, pose_t = _at_count(count)

    def zbuf():
        return tsplat._splat_zbuf_cached(tv, trc.build(tv, CFG_T), CAM_T, pose_t, H, W,
                                         CFG_T)

    got = zbuf()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = zbuf()
        assert sync.read_int.count - reads == 2
    assert torch.equal(got, eager)
    _, zj = _reference_cache_and_zbuf(count)
    _assert_zbuf_close(got.numpy(), zj, min(count, int(tB.visible_rows(tv).sum())))


@functools.lru_cache(maxsize=None)
def _surface_list():
    """A surface block list of the whole capacity: the fused orbit's surface
    blocks again and again (a block scattered twice writes the same
    minimum), so that every count up to the capacity scatters real
    blocks."""
    _, tv, _, _ = fused_orbit_volumes()
    ids, n = tsplat._surface_block_list(tv, CFG_T)
    real = ids[:int(n)]
    assert 0 < real.numel() < ZBUF_C
    return real.repeat(-(-V // real.numel()))[:V].clone()


@functools.lru_cache(maxsize=None)
def _reference_direct():
    """The reference's direct z-buffer of ``_surface_list`` at a given
    length, one compile for every length."""
    @jax.jit
    def zbuf(jv, pose_j, ids, n):
        saved = jsplat._surface_block_list
        jsplat._surface_block_list = lambda volume, config: (ids, n)
        try:
            return jsplat._splat_zbuf_direct(jv, CAM_J, pose_j, H, W, CFG_J)
        finally:
            jsplat._surface_block_list = saved

    return zbuf


@pytest.mark.parametrize("count", _boundaries(ZBUF_C))
def test_direct_zbuffer_loop_forms_match_reference(captured, monkeypatch, count):
    """``_splat_zbuf_direct``'s loop in capture form (chunks of 1024 listed
    blocks at ``offset + arange(C)``, masked at the list's length, one
    WHILE node), at every boundary length of the surface list: bit-equal
    to the eager form (one counted read) and within test_torch_splat_paths'
    tolerances of the reference's at that length."""
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    ids = _surface_list()
    n = torch.tensor(count, dtype=torch.int32)
    monkeypatch.setattr(tsplat, "_surface_block_list", lambda volume, config: (ids, n))
    got = tsplat._splat_zbuf_direct(tv, CAM_T, pose_t, H, W, CFG_T)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = tsplat._splat_zbuf_direct(tv, CAM_T, pose_t, H, W, CFG_T)
        assert sync.read_int.count - reads == 1
    assert torch.equal(got, eager)
    zj = np.asarray(_reference_direct()(jv, pose_j, jnp.asarray(ids.numpy()),
                                        jnp.asarray(count, jnp.int32)))
    _assert_zbuf_close(got.numpy(), zj, count)


MARCH_DIV = 4     # M = max(H * W // 4, 256) = 7500 rays


@functools.lru_cache(maxsize=None)
def _march_inputs():
    """The fused orbit's render caches on both sides and the rays of its
    pose (numpy): every ray starts at ray_near with a half-voxel spacing,
    so round 1 (64 samples) ends 0.58 m out, short of every surface, and
    every active ray survives it; the later rounds reach the spheres."""
    jv, tv, pose_j, pose_t = fused_orbit_volumes()
    cj = jax.jit(jrc.build, static_argnums=1)(jv, CFG_J)
    ct = trc.build(tv, CFG_T)
    dirs = CAM_T.rays(H, W).numpy() @ pose_t.rotation.numpy().T
    origin = pose_t.translation.numpy()
    t0 = np.full((H, W), CFG_T.ray_near, np.float32)
    spacing = np.full((H, W), 0.5 * CFG_T.voxel_size, np.float32)
    t_limit = np.full((H, W), CFG_T.ray_far, np.float32)
    order = np.random.default_rng(7).permutation(H * W).reshape(H, W)
    return cj, ct, origin, dirs.astype(np.float32), t0, spacing, t_limit, order


_j_march = jax.jit(jray._march, static_argnums=(1, 12, 13, 14))


@pytest.mark.parametrize("side", ["compact", "full"])
def test_march_compaction_cond_matches_reference(captured, monkeypatch, side):
    """The march's compaction branch as one IF/ELSE node (``sync.cond`` on
    ``n_undone <= M``): M active rays survive round 1 (compacted: the
    remaining rounds over those M rays alone) or M + 1 (full width).  The
    capture form (the IF/ELSE stand-in: the compaction branch, then the
    full one where the predicate is false) is bit-equal to the eager form
    (one counted read) and gives the reference's ``_march`` on the same
    rays: hit masks, depths (1e-5 m) and bracket values on 99.9% of
    rays."""
    cj, ct, origin, dirs, t0, spacing, t_limit, order = _march_inputs()
    S, n_rounds = CFG_T.raycast_chunk, 3
    M = max(H * W // MARCH_DIV, 256)
    active = order < (M if side == "compact" else M + 1)
    preds = []
    cond_node = sync._cond_node
    monkeypatch.setattr(sync, "_cond_node",
                        lambda p, *bodies: (preds.append(bool(p)), cond_node(p, *bodies)))
    args = (*t(origin), *(t(dirs[..., i]) for i in range(3)), t(t0), t(spacing), t(t_limit),
            t(active), S, n_rounds, MARCH_DIV)
    got = tray._march(ct, CFG_T, *args)
    assert preds == [side == "compact"]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sync, "capturing", lambda: False)
        reads = sync.read_int.count
        eager = tray._march(ct, CFG_T, *args)
        assert sync.read_int.count - reads == 1
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    ref = _j_march(cj, CFG_J, *(jnp.asarray(x) for x in origin),
                   *(jnp.asarray(dirs[..., i]) for i in range(3)), jnp.asarray(t0),
                   jnp.asarray(spacing), jnp.asarray(t_limit), jnp.asarray(active),
                   S, n_rounds, MARCH_DIV)
    t_hit, t_before, m_b, m_h, hit = (x.numpy() for x in got)
    hj = np.asarray(ref[4])
    assert hit.sum() > 1000 and not hit[~active].any()
    assert np.mean(hit != hj) <= 1e-3
    both = hit & hj
    for a, b in ((t_hit, ref[0]), (t_before, ref[1])):
        assert np.mean(np.abs(a[both] - np.asarray(b)[both]) > 1e-5) <= 1e-3
    for a, b in ((m_b, ref[2]), (m_h, ref[3])):
        assert np.mean(a[both] != np.asarray(b)[both]) <= 1e-3


LOOP_CAP, LOOP_CHUNK = 16, 4


@pytest.mark.parametrize("form", ["eager", "skip", "all"])
@pytest.mark.parametrize("count", [0, 1, LOOP_CHUNK - 1, LOOP_CHUNK, LOOP_CHUNK + 1,
                                   LOOP_CAP, LOOP_CAP + 1, 10 * LOOP_CAP])
def test_chunk_loop_runs_a_body_a_chunk_below_the_capped_count(monkeypatch, form, count):
    """``sync.chunk_loop`` eager (the count read once on the host) and the
    WHILE node's rule run ceil(min(count, capacity) / chunk) bodies, at
    offsets 0, chunk, ... as 0-d int64 tensors, a count past the capacity
    included; every chunk to the capacity runs capacity / chunk."""
    if form != "eager":
        monkeypatch.setattr(sync, "capturing", lambda: True)
        monkeypatch.setattr(sync, "_while_node", STAND_INS[form])
    seen = []

    def body(offset):
        assert offset.dtype == torch.int64 and offset.ndim == 0
        seen.append(int(offset))

    reads, bodies = sync.read_int.count, sync.chunk_loop.count
    sync.chunk_loop(torch.tensor(count, dtype=torch.int32), LOOP_CAP, LOOP_CHUNK, body)
    trips = (LOOP_CAP if form == "all" else min(count, LOOP_CAP)) + LOOP_CHUNK - 1
    assert seen == list(range(0, trips // LOOP_CHUNK * LOOP_CHUNK, LOOP_CHUNK))
    if form == "eager":
        assert sync.read_int.count - reads == 1
        assert sync.chunk_loop.count - bodies == len(seen)
        want, bodies = list(seen), sync.chunk_loop.count
        seen.clear()
        sync.chunk_loop(torch.tensor(count, dtype=torch.int32), LOOP_CAP, LOOP_CHUNK,
                        body, host_count=count)
        assert seen == want and sync.chunk_loop.count - bodies == len(want)
        assert sync.read_int.count - reads == 1
    with pytest.raises(ValueError):
        sync.chunk_loop(torch.tensor(count, dtype=torch.int32), LOOP_CAP, 3, body)


@dataclasses.dataclass
class _Tree:
    a: torch.Tensor
    b: tuple


@pytest.mark.parametrize("value", [0, 1, 5])
def test_cond_through_ifelse_node_matches_eager(monkeypatch, value):
    """``cond`` captured as one IF/ELSE node (on ``pred != 0``, a 0-d bool)
    returns the tree the eager ``cond`` returns: fresh tensors from either
    branch, and an input tensor that both return at the same place, in the
    true branch's buffers."""
    x = torch.arange(6, dtype=torch.float32)
    shared = torch.full((2,), 7.0)

    def branch(scale):
        return lambda: _Tree(x * scale, (shared, (x + scale).to(torch.int32)))

    pred = torch.tensor(value, dtype=torch.int32)
    want = sync.cond(pred, branch(2.0), branch(-3.0))
    nodes = []
    monkeypatch.setattr(sync, "capturing", lambda: True)
    monkeypatch.setattr(sync, "_cond_node",
                        lambda p, *bodies: (nodes.append(p), cond_node(p, *bodies)))
    got = sync.cond(pred, branch(2.0), branch(-3.0))
    assert len(nodes) == 1 and bool(nodes[0]) == bool(value)
    assert got.b[0] is shared
    for g, w in zip(sync.tensor_leaves(got), sync.tensor_leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_cond_picks_the_branch_eagerly():
    """Eager ``cond``: one counted read, the branch the predicate names;
    under ``warm_both`` both branches run and the chosen one's result is
    returned; a predicate the caller has read already (an int) costs no
    read, and under ``warm_both`` still runs both branches."""
    ran = []

    def branch(tag):
        def fn():
            ran.append(tag)
            return torch.full((2,), float(tag))
        return fn

    for value, want in ((3, 1), (0, 0)):
        pred = torch.tensor(value, dtype=torch.int32)
        reads = sync.read_int.count
        ran.clear()
        out = sync.cond(pred, branch(1), branch(0))
        assert sync.read_int.count - reads == 1 and ran == [want]
        assert torch.equal(out, torch.full((2,), float(want)))
        ran.clear()
        with sync.warm_both():
            out = sync.cond(pred, branch(1), branch(0))
        assert ran == [1, 0] and torch.equal(out, torch.full((2,), float(want)))
        count = torch.tensor(7, dtype=torch.int32)
        reads = sync.read_int.count
        n, on = sync.read_ints(count, pred)
        ran.clear()
        out = sync.cond(on, branch(1), branch(0))
        assert n == 7 and sync.read_int.count - reads == 1 and ran == [want]
        assert torch.equal(out, torch.full((2,), float(want)))
        ran.clear()
        with sync.warm_both():
            out = sync.cond(on, branch(1), branch(0))
        assert ran == [1, 0] and torch.equal(out, torch.full((2,), float(want)))
        assert sync.read_int.count - reads == 1
    assert not sync._warm_both


# Each renderer's settings off the default (the march, the direct and the
# polished splat) and their eager reads a frame: the track's branch (depth
# mode), the integrate count with the colour branch, and the render's loop
# counts and branches (the render cache's chunks and the march's two
# compaction branches; the direct or cached z-buffer's chunks).
RENDERERS = {"march": dict(render_mode="march"), "direct": dict(splat_source="direct"),
             "polish": dict(splat_polish=2)}


READS = [("default", "depth", False, 3), ("default", "color", False, 2),
         ("default", "combined", False, 2), ("default", "light", False, 2),
         ("default", "depth", True, 2),
         ("march", "depth", False, 5), ("march", "combined", False, 4),
         ("march", "depth", True, 4),
         ("direct", "depth", False, 3), ("direct", "combined", False, 3),
         ("direct", "depth", True, 3),
         ("polish", "depth", False, 4), ("polish", "combined", False, 3),
         ("polish", "depth", True, 3)]


# (the default renderer's rows keep their ids from before the other rows)
@pytest.mark.parametrize("renderer,mode,known,reads", READS, ids=[
    "-".join(map(str, row if row[0] != "default" else row[1:])) for row in READS])
def test_step_reads_per_frame_on_cpu(renderer, mode, known, reads):
    """The eager step reads as many values a frame on the CPU as it did
    before its loops and branches went through ``utils.sync``: the
    integrate count and the track/render branch in one transfer, the tier
    lengths in another, and in depth mode the auto-photo track's branch;
    off the default renderer, the render's loop counts and branches
    instead of the tier lengths."""
    poses = orbit(3)
    cfg = dataclasses.replace(CFG_T, **RENDERERS.get(renderer, {}))
    pipe = P.Pipeline(cfg, CAM_T, H, W, init_pose=se3_t(poses[0]), mode=mode,
                      device="cpu")
    assert not pipe.captured and pipe.graph_stats == {}
    for pose in poses:
        d, c = scene(pose)
        before = sync.read_int.count
        pipe.process(d, c, pose=se3_t(pose) if known else None)
        assert sync.read_int.count - before == reads


@pytest.mark.parametrize("renderer", ["default", *RENDERERS])
@pytest.mark.parametrize("mode", ["depth", "color", "combined", "light"])
def test_pipeline_captures_every_supported_setting_on_the_card(monkeypatch, renderer,
                                                               mode):
    """``Pipeline`` on the card takes the captured graph at every setting
    ``check_supported`` accepts, every renderer in every mode: no setting
    runs the eager step there.  (The state is made on the CPU here: the
    choice is the pipeline's.)"""
    made = []
    monkeypatch.setattr(fusion, "init_state", lambda *a, **k: None)
    monkeypatch.setattr(api, "StepGraphs", lambda device: made.append(device) or "graphs")
    cfg = P.Config(**RENDERERS.get(renderer, {}))
    pipe = P.Pipeline(cfg, CAM_T, H, W, mode=mode, device="cuda:0")
    assert pipe.captured and pipe._graphs == "graphs"
    assert made == [torch.device("cuda:0")]
    cpu = P.Pipeline(cfg, CAM_T, H, W, mode=mode, device="cpu")
    assert not cpu.captured and cpu._graphs is None and len(made) == 1


@pytest.mark.parametrize("override,mode,error", [
    ({}, "stereo", ValueError),
    (dict(integrate_gather="onehot"), "depth", NotImplementedError),
    (dict(assoc_patch="on"), "depth", NotImplementedError),
])
def test_pipeline_refuses_unsupported_settings(override, mode, error):
    """What ``check_supported`` refuses, ``Pipeline`` refuses on any device:
    a loud stop, never an eager or partial run."""
    for device in ("cuda:0", "cpu"):
        with pytest.raises(error):
            P.Pipeline(P.Config(**override), CAM_T, H, W, mode=mode, device=device)


def test_state_buffers_copy_without_aliasing():
    """``distinct`` gives the fresh state's shared pose two buffers;
    ``copy_leaves`` copies a new state into the buffers even where a new
    field IS another field's buffer (the step's ``prev_pose`` is the old
    pose), skips what already is its buffer, and ``rebuild`` puts the
    tree back together over them."""
    state = fusion.init_state(CFG_T, CAM_T, H, W, device="cpu")
    leaves = sync.tensor_leaves(state)
    assert state.prev_pose.rotation is state.model.pose.rotation
    bufs = graphs.distinct(leaves)
    ptrs = [b.untyped_storage().data_ptr() for b in bufs]
    assert len(set(ptrs)) == len(ptrs)
    view = graphs.rebuild(state, iter(bufs))
    assert all(a is b for a, b in zip(sync.tensor_leaves(view), bufs))
    assert view.model.camera == state.model.camera

    moved = SE3(view.model.pose.rotation.flip(0), view.model.pose.translation + 1.0)
    old_r = view.model.pose.rotation.clone()
    new = dataclasses.replace(view, model=dataclasses.replace(view.model, pose=moved),
                              prev_pose=view.model.pose,
                              frame_idx=view.frame_idx + 1)
    assert graphs.copy_leaves(bufs, sync.tensor_leaves(new))
    assert torch.equal(view.prev_pose.rotation, old_r)
    assert torch.equal(view.model.pose.rotation, old_r.flip(0))
    assert int(view.frame_idx) == 1
    assert view.volume.tsdf is state.volume.tsdf
    assert not graphs.copy_leaves(bufs, sync.tensor_leaves(view))
