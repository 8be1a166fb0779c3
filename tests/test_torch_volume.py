"""Hashing, allocation, visibility, surfel packing and sparse integration
held against the JAX package.  Integer and bit-packed outputs are exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import allocate as jal
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import hashing as jh
from vulcan_tpu.ops import sparse as jsp
from vulcan_tpu_torch.core.frame import Frame
from vulcan_tpu_torch.ops import allocate as tal
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import hashing as th
from vulcan_tpu_torch.ops import sparse as tsp

from ._torch_port import (
    CAM_J, CAM_T, CFG_J, CFG_T, H, W, fused_orbit_volumes, jflat, orbit, scene, se3_t, t,
)

INT_FIELDS = (
    "hash_codes", "hash_values", "free_count", "block_coords", "visible_ids",
    "num_visible", "alloc_overflow", "visible_overflow",
)


def test_hash_coords_exact_with_negative_coords():
    rng = np.random.default_rng(0)
    c = rng.integers(-512, 512, (4096, 3)).astype(np.int32)
    for hs in (256, 8192, 262144):
        np.testing.assert_array_equal(
            th.hash_coords(t(c), hs).numpy(),
            np.asarray(jh.hash_coords(jnp.asarray(c), hs)),
        )


def test_insert_unique_exact_under_collisions_and_capacity():
    """A tiny table (256 slots, 4 probes, 64 blocks) forces probe
    contention, probe-bound failures and the capacity gate."""
    cj = dataclasses.replace(CFG_J, hash_size=256, num_blocks=64, max_probes=4)
    ct = dataclasses.replace(CFG_T, hash_size=256, num_blocks=64, max_probes=4)
    rng = np.random.default_rng(1)
    pool = np.unique(rng.integers(-40, 40, (400, 3)).astype(np.int32), axis=0)
    rng.shuffle(pool)
    first, second = pool[:50], np.concatenate([pool[20:40], pool[60:120]])
    want2 = rng.random(len(second)) < 0.9

    jv = jB.create_volume(cj)
    tv = tB.create_volume(ct)
    jstate = (jv.hash_codes, jv.hash_values, jv.free_count)
    tstate = (tv.hash_codes, tv.hash_values, tv.free_count)
    for coords, want in ((first, np.ones(len(first), bool)), (second, want2)):
        jout = jh.insert_unique(*jstate, jnp.asarray(coords), jnp.asarray(want), cj)
        tout = th.insert_unique(*tstate, t(coords), t(want), ct)
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jstate, tstate = jout[:3], tout[:3]
    # The second batch overran the 63 free blocks: some rows failed.
    assert int(tstate[2]) == ct.num_blocks
    assert not tout[4].all()

    probe = np.concatenate([pool[:130], np.array([[500, -500, 3]], np.int32)])
    slot0 = jh.hash_coords(jnp.asarray(probe), cj.hash_size)
    qj = jB.pack_block_coords(jnp.asarray(probe))
    jl = jh.lookup_codes(jstate[0], jstate[1], qj, slot0, cj)
    tl = th.lookup_codes(
        tstate[0], tstate[1], tB.pack_block_coords(t(probe)),
        th.hash_coords(t(probe), ct.hash_size), ct,
    )
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_block_code_packing_exact():
    rng = np.random.default_rng(2)
    c = rng.integers(-512, 512, (2000, 3)).astype(np.int32)
    codes = tB.pack_block_coords(t(c))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jB.pack_block_coords(jnp.asarray(c))))
    np.testing.assert_array_equal(tB.unpack_block_coords(codes).numpy(), c)
    bad = np.array([[512, 0, 0], [-513, 0, 0], [0, 0, 511]], np.int32)
    np.testing.assert_array_equal(
        tB.coords_in_bounds(t(bad)).numpy(), np.asarray(jB.coords_in_bounds(jnp.asarray(bad)))
    )


def test_pack_surfels_exact_including_overflow():
    rng = np.random.default_rng(3)
    C = 96
    tsdf = rng.uniform(-1.0, 1.0, (C, 512)).astype(np.float32)
    tsdf[::3] *= 0.2          # dense shells: these rows overflow 40 slots
    weight = (rng.random((C, 512)) < 0.8).astype(np.float32) * 3.0
    band, slots = 0.3, 40
    js = jB.pack_surfels(jnp.asarray(tsdf), jnp.asarray(weight), band, slots)
    ts = tB.pack_surfels(t(tsdf), t(weight), band, slots)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(js[2]).max() > 0      # overflow was exercised
    lj = jB.unpack_surfels(js[0])
    lt = tB.unpack_surfels(ts[0])
    for a, b in zip(lt[:3], lj[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(lt[3], lj[3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_voxel_color_packing_exact():
    rng = np.random.default_rng(4)
    rgb = rng.random((1000, 3)).astype(np.float32)
    cw = rng.uniform(0, 300, 1000).astype(np.float32)
    pj = jB.pack_voxel_color(jnp.asarray(rgb), jnp.asarray(cw))
    pt = tB.pack_voxel_color(t(rgb), t(cw))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for a, b in zip(tB.unpack_voxel_color(pt), jB.unpack_voxel_color(pj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def two_frames():
    """The reference's volume after allocate + visibility + integrate of
    frame 1, then allocate + visibility of frame 2 (plus each input)."""
    poses = orbit(3)
    jv = jB.create_volume(CFG_J)
    snaps = []
    for pose in poses[1:]:
        d, c = scene(pose)
        frame = make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
        before = jflat(jv)
        jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
        jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
        allocated = jflat(jv)
        jv = jsp.integrate_sparse(jv, frame, CFG_J, ids=band, count=n_band)
        snaps.append(dict(before=before, allocated=allocated, integrated=jflat(jv),
                          band=np.asarray(band), n_band=int(n_band),
                          d=d, c=c, pose=pose))
    return snaps


def test_allocate_and_visibility_exact(two_frames):
    for s in two_frames:
        tv = tB.VolumeState(**{k: t(v) for k, v in s["before"].items()})
        pose = se3_t(s["pose"])
        tv, band, n_band = tal.allocate_for_frame(tv, t(s["d"]), CAM_T, pose, CFG_T)
        tv = tal.update_visibility(tv, CAM_T, pose, H, W, CFG_T)
        np.testing.assert_array_equal(band.numpy(), s["band"])
        assert int(n_band) == s["n_band"] > 0
        for name in INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(tv, name).numpy(), s["allocated"][name], err_msg=name
            )


def test_integrate_sparse_matches_reference(two_frames):
    for s in two_frames:
        tv = tB.VolumeState(**{k: t(v) for k, v in s["allocated"].items()})
        pose = se3_t(s["pose"])
        frame = Frame(t(s["d"]), t(s["c"]), CAM_T, pose)
        tv = tsp.integrate_sparse(
            tv, frame, CFG_T, ids=t(s["band"]), count=torch.tensor(s["n_band"])
        )
        ref = s["integrated"]
        # The reference's compiled integrate loop fuses a*b+c into FMAs;
        # PyTorch's CPU ops round each product: tsdf moves by ulps.
        np.testing.assert_allclose(tv.tsdf.numpy(), ref["tsdf"], atol=2e-6)
        # surfpack quantizes |tsdf| to 14 bits: a tsdf that differs by an
        # ulp right at a rounding boundary lands one quantum (1 << 10 in
        # the packed word) away.  Allow that for at most 0.1% of slots;
        # every other bit is exact.
        sp, sp_ref = tv.surfpack.numpy(), ref["surfpack"]
        diff = sp.astype(np.int64) - sp_ref
        assert np.mean(diff != 0) <= 1e-3
        assert set(np.unique(np.abs(diff))) <= {0, 1 << 10}
        # colorpack rounds the running colour average to 8 bits per
        # channel: the same ulp effect at a rounding boundary moves a
        # channel byte by a count or two.  The weight byte stays exact.
        cp, cp_ref = tv.colorpack.numpy(), ref["colorpack"]
        assert np.mean(cp != cp_ref) <= 1e-3
        np.testing.assert_array_equal(cp >> 24, cp_ref >> 24)
        for shift in (0, 8, 16):
            chan = ((cp >> shift) & 0xFF).astype(np.int64)
            chan_ref = ((cp_ref >> shift) & 0xFF).astype(np.int64)
            assert np.abs(chan - chan_ref).max() <= 2
        for name in ("weight", "surf_count",
                     "mesh_dirty", "surf_overflow", *INT_FIELDS):
            np.testing.assert_array_equal(
                getattr(tv, name).numpy(), ref[name], err_msg=name
            )
        assert ref["mesh_dirty"].sum() > 0 and ref["surf_count"].sum() > 0


@pytest.fixture(scope="module")
def query_points():
    """World points (N, 3) on the fused orbit volume, from a seed: inside
    its allocated blocks, in the last voxel row of a block along one to
    three axes (the trilinear corners then lie in the next blocks), on
    voxel centres (the nearest sample's rounding), and in a far box with
    no block allocated."""
    jv, tv, _, _ = fused_orbit_volumes()
    rng = np.random.default_rng(13)
    coords = np.asarray(jv.block_coords)[1:int(jv.free_count)]
    bs, vs = CFG_T.block_size, CFG_T.voxel_size
    n = 512
    blocks = coords[rng.integers(0, len(coords), n)]
    local = rng.integers(0, bs, (n, 3)).astype(np.float64)
    across = local.copy()
    across[rng.random((n, 3)) < 0.5] = bs - 1
    across[np.arange(n), rng.integers(0, 3, n)] = bs - 1
    frac = rng.random((n, 3))
    inside = (blocks * bs + local + frac) * vs
    faces = (blocks * bs + across + frac) * vs
    centres = (blocks * bs + local) * vs
    far = rng.uniform(-20.0, 20.0, (n, 3)) + np.where(rng.random((n, 1)) < 0.5, 40.0, -40.0)
    pts = np.concatenate([inside, faces, centres, far]).astype(np.float32)
    return jv, tv, pts


def test_point_queries_match_reference(query_points):
    """The seven point queries of ``ops/blocks.py`` against the reference's:
    voxel coordinates, block and local indices, flat offsets, the voxels
    read and the nearest sample exact; the trilinear tsdf and rgb within
    2e-6 (f32 rounding of eight weighted terms of magnitude <= 1) with
    their ``ok`` flags exact, on points inside the volume, across block
    faces and far outside it (the null block: tsdf 1, weight 0)."""
    jv, tv, pts = query_points
    p_j, p_t = jnp.asarray(pts), t(pts)
    q_j, q_t = jB.world_to_voxel(p_j, CFG_J), tB.world_to_voxel(p_t, CFG_T)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    g = np.floor(np.asarray(q_j)).astype(np.int32)
    (jblock, jlocal), (tblock, tlocal) = (jB.voxel_block_local(jnp.asarray(g), CFG_J),
                                          tB.voxel_block_local(t(g), CFG_T))
    np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
    np.testing.assert_array_equal(tlocal.numpy(), np.asarray(jlocal))
    assert (np.asarray(jblock) < 0).any() and (np.asarray(jlocal) == 7).any()
    np.testing.assert_array_equal(tB.local_flat(tlocal, CFG_T).numpy(),
                                  np.asarray(jB.local_flat(jlocal, CFG_J)))
    for name, jf, tf, arg in (("read_voxels", jB.read_voxels, tB.read_voxels, g),
                              ("nearest", jB.sample_tsdf_nearest,
                               tB.sample_tsdf_nearest, pts)):
        (jt, jw), (tt, tw) = jf(jv, jnp.asarray(arg), CFG_J), tf(tv, t(arg), CFG_T)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=name)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw), err_msg=name)
        observed = np.asarray(jw) > 0
        assert 0 < observed.sum() < len(pts), name
        np.testing.assert_array_equal(np.asarray(jt)[-512:], 1.0)
    jval, jok = jB.sample_tsdf_trilinear(jv, p_j, CFG_J)
    tval, tok = tB.sample_tsdf_trilinear(tv, p_t, CFG_T)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0, atol=2e-6)
    assert 0 < np.asarray(jok).sum() < len(pts)
    jrgb, jcok = jB.sample_color_trilinear(jv, p_j, CFG_J)
    trgb, tcok = tB.sample_color_trilinear(tv, p_t, CFG_T)
    np.testing.assert_array_equal(tcok.numpy(), np.asarray(jcok))
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=0, atol=2e-6)
    assert 0 < np.asarray(jcok).sum() < len(pts)
