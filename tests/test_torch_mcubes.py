"""Marching cubes of the port (``ops/mcubes.py``), its tables, PLY files and
the hash lookups it uses, held against the JAX package on
tests/test_mcubes.py's fused sphere (TINY, 2 cm voxels), and the
reference's own mesh tests mirrored on the port."""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.ops import blocks as jB
from vulcan_tpu.ops import hashing as jh
from vulcan_tpu.ops import mc_tables as jT
from vulcan_tpu.ops import mcubes as jm
from vulcan_tpu_torch.io.ply import read_ply, weld_vertices, write_ply
from vulcan_tpu_torch.ops import blocks as tB
from vulcan_tpu_torch.ops import hashing as th
from vulcan_tpu_torch.ops import mc_tables as tT
from vulcan_tpu_torch.ops import mcubes as tm
from vulcan_tpu_torch.utils.convert import (
    mesh_cache_from_numpy,
    mesh_cache_to_numpy,
    mesh_to_numpy,
    volume_from_numpy,
    volume_to_numpy,
)
from vulcan_tpu_torch.utils.sync import read_int

from ._torch_port import (
    MC_CFG_J, MC_CFG_T, SPHERE_CENTER, SPHERE_RADIUS, full_coverage_poses,
    port_sphere_volume, reference_sphere_volume, sphere_frames, sphere_views, t,
)

POS_TOL = 1e-5    # m: edge interpolation, one division a vertex
COLOR_TOL = 1e-5  # colour interpolation: the reference may fuse an FMA


@pytest.fixture(scope="module")
def coverage():
    poses = full_coverage_poses(8)
    return poses, sphere_frames(poses)


@pytest.fixture(scope="module")
def reference_volume(coverage):
    """The reference's sphere volume (26 views), with its integration's
    dirty flags, as numpy arrays."""
    return volume_to_numpy(reference_sphere_volume(*coverage))


def _j_volume(arrays):
    return jB.VolumeState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def reference_mesh(reference_volume):
    return mesh_to_numpy(jax.jit(jm.extract_mesh, static_argnums=1)(
        _j_volume(reference_volume), MC_CFG_J))


@pytest.fixture(scope="module")
def reference_cache(reference_volume):
    """The reference's ``update_mesh_cache`` from an empty cache: its
    volume (flags cleared) and cache, as numpy arrays."""
    vol, cache = jax.jit(jm.update_mesh_cache, static_argnums=2)(
        _j_volume(reference_volume), jm.create_mesh_cache(MC_CFG_J), MC_CFG_J)
    return volume_to_numpy(vol), mesh_cache_to_numpy(cache)


@pytest.mark.parametrize("name", ["MAX_TRIS", "CORNER_OFFSETS", "EDGE_ENDPOINTS",
                                  "NUM_TRIS", "TRI_TABLE"])
def test_tables_copy_equals_reference(name):
    a, b = getattr(tT, name), getattr(jT, name)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


def test_lookup_blocks_exact(reference_volume):
    """``hashing.lookup`` / ``blocks.lookup_blocks`` on allocated, absent
    and out-of-bounds coords: 0 (or -1) where missing, exactly as the
    reference."""
    tv = volume_from_numpy(reference_volume)
    jv = _j_volume(reference_volume)
    n = int(reference_volume["free_count"])
    rng = np.random.default_rng(3)
    coords = np.concatenate([
        reference_volume["block_coords"][1:n],
        rng.integers(-20, 20, (500, 3)),
        [[512, 0, 0], [0, -513, 0], [-512, 511, 0]],
    ]).astype(np.int32)
    idx_t, found_t = th.lookup(tv.hash_codes, tv.hash_values, t(coords), MC_CFG_T)
    idx_j, found_j = jh.lookup(jv.hash_codes, jv.hash_values, jnp.asarray(coords),
                               MC_CFG_J)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    assert found_t[: n - 1].all() and not found_t[-3:].any()
    np.testing.assert_array_equal(
        tB.lookup_blocks(tv, t(coords), MC_CFG_T).numpy(),
        np.asarray(jB.lookup_blocks(jv, jnp.asarray(coords), MC_CFG_J)),
    )


def test_extract_mesh_matches_reference(reference_volume, reference_mesh):
    """Same volume, same triangles in the same order: counts exact,
    positions and colours within float32 rounding."""
    read_int.count = 0
    got = mesh_to_numpy(tm.extract_mesh(volume_from_numpy(reference_volume), MC_CFG_T))
    assert read_int.count == 1           # the chunk count
    ref = reference_mesh
    for name in ("count", "overflow", "compact_dropped"):
        assert int(got[name]) == int(ref[name]), name
    n = int(ref["count"])
    assert n > 500 and int(ref["overflow"]) == 0
    dp = np.abs(got["positions"] - ref["positions"]).max()
    dc = np.abs(got["colors"] - ref["colors"]).max()
    print(f"max |position diff| {dp:.3e} m, max |colour diff| {dc:.3e}")
    assert dp <= POS_TOL and dc <= COLOR_TOL
    # Lanes past the count hold zeros, as the reference's.
    assert not got["positions"][n:].any() and not got["colors"][n:].any()


def test_update_mesh_cache_matches_reference(reference_volume, reference_cache):
    """Same volume and flags: per-block counts exact; the lidx and edge
    bits of every vertex word exact; the quantized t16 and rgb888 bytes
    within one step on at most 0.1% of entries (where the reference's
    compiled interpolation fused an FMA at a rounding boundary)."""
    tv = volume_from_numpy(reference_volume)
    empty = tm.create_mesh_cache(MC_CFG_T)
    read_int.count = 0
    vol, cache = tm.update_mesh_cache(tv, empty, MC_CFG_T)
    assert read_int.count == 2           # flagged blocks, work blocks
    assert not vol.mesh_dirty.any() and tv.mesh_dirty.any()
    assert not empty.counts.any()        # the given cache is not modified
    ref_vol, ref = reference_cache
    np.testing.assert_array_equal(vol.mesh_dirty.numpy(), ref_vol["mesh_dirty"])
    got = mesh_cache_to_numpy(cache)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_array_equal(got["dropped"], ref["dropped"])
    assert ref["counts"].sum() > 500
    for name in ("va", "vb", "vc"):
        a, b = got[name], ref[name]
        np.testing.assert_array_equal(a >> 16, b >> 16, err_msg=name)
        dt = np.abs((a & 0xFFFF) - (b & 0xFFFF))
        assert dt.max() <= 1 and (dt > 0).mean() <= 1e-3, name
    for name in ("ca", "cb", "cc"):
        a, b = got[name], ref[name]
        assert not ((a | b) >> 24).any(), name
        db = np.stack([np.abs(((a >> s) & 0xFF) - ((b >> s) & 0xFF)) for s in (16, 8, 0)])
        assert db.max() <= 1 and (db.max(0) > 0).mean() <= 1e-3, name


def test_cache_to_mesh_matches_reference(reference_cache):
    """The reference's cache decoded by both packages."""
    ref_vol, ref_cache = reference_cache
    want = mesh_to_numpy(jax.jit(jm.cache_to_mesh, static_argnums=2)(
        _j_volume(ref_vol), jm.MeshCache(**{k: jnp.asarray(v) for k, v in ref_cache.items()}),
        MC_CFG_J))
    read_int.count = 0
    got = mesh_to_numpy(tm.cache_to_mesh(
        volume_from_numpy(ref_vol), mesh_cache_from_numpy(ref_cache), MC_CFG_T))
    assert read_int.count == 1           # the row-chunk count
    for name in ("count", "overflow", "compact_dropped"):
        assert int(got[name]) == int(want[name]), name
    np.testing.assert_allclose(got["positions"], want["positions"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["colors"], want["colors"])


def test_overflow_is_reported(reference_volume, reference_cache):
    """A 100-triangle buffer: the count stops at 100 and the rest is
    reported as overflow, equal to the reference's, in the full
    extraction and in the cache decode."""
    cfg_j = dataclasses.replace(MC_CFG_J, max_mesh_triangles=100)
    cfg_t = dataclasses.replace(MC_CFG_T, max_mesh_triangles=100)
    ref = jm.extract_mesh(_j_volume(reference_volume), cfg_j)
    got = tm.extract_mesh(volume_from_numpy(reference_volume), cfg_t)
    assert int(got.count) == int(ref.count) == 100
    assert int(got.overflow) == int(ref.overflow) > 0
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(ref.positions),
                               rtol=0, atol=POS_TOL)
    ref_vol, ref_cache = reference_cache
    dec = tm.cache_to_mesh(volume_from_numpy(ref_vol), mesh_cache_from_numpy(ref_cache),
                           cfg_t)
    assert int(dec.count) == 100
    assert int(dec.overflow) == int(ref_cache["counts"].sum()) - 100
    np.testing.assert_allclose(dec.positions.numpy(), got.positions.numpy(),
                               rtol=0, atol=2e-4)


def test_sphere_mesh_geometry_and_color(reference_volume):
    """The port's mesh of the whole sphere lies on it, encloses its volume
    and carries its procedural colour (tests/test_mcubes.py's bounds)."""
    from vulcan_tpu_torch.io.synthetic import procedural_color

    mesh = tm.extract_mesh(volume_from_numpy(reference_volume), MC_CFG_T)
    n = int(mesh.count)
    tris = mesh.positions[:n].numpy()
    verts = tris.reshape(-1, 3)
    err = np.abs(np.linalg.norm(verts - np.asarray(SPHERE_CENTER), axis=-1) - SPHERE_RADIUS)
    assert np.median(err) < 0.5 * MC_CFG_T.voxel_size
    assert np.mean(err) < MC_CFG_T.voxel_size
    signed = np.einsum("ij,ij->i", tris[:, 0], np.cross(tris[:, 1], tris[:, 2])).sum() / 6
    true = 4 / 3 * np.pi * SPHERE_RADIUS ** 3
    assert abs(signed - true) / true < 0.05, (signed, true)
    c_true = procedural_color(torch.from_numpy(verts)).numpy()
    assert np.mean(np.abs(mesh.colors[:n].numpy().reshape(-1, 3) - c_true)) < 0.15


def test_mesh_watertight_on_closed_surface(reference_volume):
    mesh = tm.extract_mesh(volume_from_numpy(reference_volume), MC_CFG_T)
    n = int(mesh.count)
    _, _, faces = weld_vertices(mesh.positions[:n].numpy(), mesh.colors[:n].numpy())
    cnt = Counter()
    for f in faces:
        for i in range(3):
            a, b = f[i], f[(i + 1) % 3]
            cnt[(min(a, b), max(a, b))] += 1
    # Full coverage -> closed surface: every edge shared by exactly 2 tris.
    assert (np.asarray(list(cnt.values())) == 2).mean() > 0.995


@pytest.mark.parametrize("weld", [True, False])
def test_ply_roundtrip(reference_mesh, tmp_path, weld):
    """The port's writer (the native welder) and reader on the reference's
    mesh: every face comes back, welded as the native writer welds it (one
    vertex per distinct position on its 1e-5 grid, first seen first: the
    plain version below), colours as uchar; the file is the reference's
    writer's, byte for byte."""
    from vulcan_tpu.io.ply import write_ply as j_write_ply

    n = int(reference_mesh["count"])
    pos, col = reference_mesh["positions"][:n], reference_mesh["colors"][:n]
    path = str(tmp_path / "mesh.ply")
    write_ply(path, pos, col, weld=weld)
    verts, cols, faces = read_ply(path)
    assert len(faces) == n
    flat, flat_c = pos.reshape(-1, 3), col.reshape(-1, 3)
    if weld:
        keys = np.rint(flat * (np.float32(1) / np.float32(1e-5)))
        _, first, inv = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
        order = np.argsort(first)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        want_v, want_c = flat[first[order]], flat_c[first[order]]
        want_f = rank[inv.reshape(-1)].reshape(-1, 3)
        assert len(want_v) < 3 * n
    else:
        want_v, want_c = flat, flat_c
        want_f = np.arange(3 * n).reshape(-1, 3)
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)
    np.testing.assert_array_equal(
        cols, np.clip(want_c * 255.0, 0, 255).astype(np.uint8).astype(np.float32) / 255.0)
    np.testing.assert_allclose(verts[faces], pos, rtol=0, atol=1e-5)
    j_write_ply(str(tmp_path / "ref.ply"), pos, col, weld=weld)
    assert (tmp_path / "ref.ply").read_bytes() == (tmp_path / "mesh.ply").read_bytes()


def _assert_mesh_equal(inc, full):
    """Incremental (quantized t16 / rgb888 cache) vs direct extraction:
    the same triangles in the same order, positions within quantization
    (tests/test_mcubes.py's bounds)."""
    n = int(full.count)
    assert int(inc.count) == n
    assert n > 100
    assert int(inc.overflow) == int(full.overflow) == 0
    np.testing.assert_allclose(inc.positions[:n].numpy(), full.positions[:n].numpy(),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(inc.colors[:n].numpy(), full.colors[:n].numpy(),
                               rtol=0, atol=1 / 128)


def test_incremental_matches_full_extraction(coverage):
    """Per-block caches updated only for re-integrated blocks reproduce a
    full re-extraction mid-sequence, after more fusion, and after a no-op
    update (``mesh_dirty_eps=0``: every integrated block is flagged)."""
    cfg = dataclasses.replace(MC_CFG_T, mesh_dirty_eps=0.0)
    state = {"cache": tm.create_mesh_cache(cfg)}

    def mid(k, volume):
        if k == 3:
            volume.state, state["cache"] = tm.update_mesh_cache(
                volume.state, state["cache"], cfg)
            assert not volume.state.mesh_dirty.any()
            _assert_mesh_equal(tm.cache_to_mesh(volume.state, state["cache"], cfg),
                               tm.extract_mesh(volume.state, cfg))

    volume = port_sphere_volume(*coverage, cfg_t=cfg, each=mid)
    vol, cache = tm.update_mesh_cache(volume.state, state["cache"], cfg)
    _assert_mesh_equal(tm.cache_to_mesh(vol, cache, cfg), tm.extract_mesh(vol, cfg))

    # No-op update: nothing dirty, the cache unchanged.
    vol2, cache2 = tm.update_mesh_cache(vol, cache, cfg)
    assert int(cache2.counts.sum()) == int(cache.counts.sum())
    assert torch.equal(cache2.va, cache.va) and torch.equal(cache2.ca, cache.ca)


def test_incremental_clears_vanished_surface():
    """A block whose surface disappears re-meshes to fewer triangles and
    the decode agrees with a full re-extraction."""
    poses = sphere_views(6)
    vol = port_sphere_volume(poses, sphere_frames(poses)).state
    vol, cache = tm.update_mesh_cache(vol, tm.create_mesh_cache(MC_CFG_T), MC_CFG_T)
    n0 = int(tm.cache_to_mesh(vol, cache, MC_CFG_T).count)
    assert n0 > 100
    bid = int(torch.argmax(cache.counts))
    before = int(cache.counts[bid])
    assert before > 0
    vol.tsdf[bid] = 1.0
    vol.mesh_dirty[bid] = True
    vol, cache = tm.update_mesh_cache(vol, cache, MC_CFG_T)
    assert int(cache.counts[bid]) < before
    mesh = tm.cache_to_mesh(vol, cache, MC_CFG_T)
    full = tm.extract_mesh(vol, MC_CFG_T)
    assert int(mesh.count) == int(full.count) < n0


def test_incremental_default_eps_gate_stays_close(coverage):
    """Under the default ``mesh_dirty_eps`` gate the cached mesh may lag
    by sub-eps drift but stays within 2% of a full re-extraction's count
    and on the sphere."""
    volume = port_sphere_volume(*coverage)
    vol, cache = tm.update_mesh_cache(volume.state, tm.create_mesh_cache(MC_CFG_T),
                                      MC_CFG_T)
    inc = tm.cache_to_mesh(vol, cache, MC_CFG_T)
    full = tm.extract_mesh(vol, MC_CFG_T)
    ni, nf = int(inc.count), int(full.count)
    assert nf > 500
    assert abs(ni - nf) <= max(10, 0.02 * nf), (ni, nf)
    verts = inc.positions[:ni].numpy().reshape(-1, 3)
    err = np.abs(np.linalg.norm(verts - np.asarray(SPHERE_CENTER), axis=-1) - SPHERE_RADIUS)
    assert np.median(err) < 0.5 * MC_CFG_T.voxel_size


def test_mesh_capacity_16384_blocks():
    """A 16384-block volume with thousands of allocated blocks (inserted
    through the port's hash, TSDF filled analytically) meshes with zero
    overflow onto the sphere (tests/test_mcubes.py's capacity case)."""
    kw = dict(num_blocks=16384, hash_size=65536, max_visible=16384,
              voxel_size=0.008, trunc_dist=0.04, max_mesh_triangles=1_000_000)
    cfg = dataclasses.replace(P.TINY, **kw)
    assert dataclasses.replace(J_TINY, **kw).num_blocks == cfg.num_blocks
    r = 1.0
    be = cfg.block_extent
    n = int(np.ceil((r + 0.1) / be))
    ax = np.arange(-n, n + 1, dtype=np.int32)
    coords = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    centers = (coords.astype(np.float32) + 0.5) * be
    shell = coords[np.abs(np.linalg.norm(centers, axis=-1) - r)
                   < cfg.trunc_dist + 0.87 * be]
    assert 4000 < len(shell) < 12000, len(shell)

    vol = tB.create_volume(cfg)
    codes, values, free = vol.hash_codes, vol.hash_values, vol.free_count
    for i in range(0, len(shell), 4096):
        part = np.zeros((4096, 3), np.int32)
        got = shell[i:i + 4096]
        part[:len(got)] = got
        want = torch.arange(4096) < len(got)
        codes, values, free, assigned, ok = th.insert_unique(
            codes, values, free, t(part), want, cfg)
        assert bool(ok.all())
        vol.block_coords[assigned[want].long()] = t(part)[want]
    nb_alloc = int(free) - 1
    assert nb_alloc == len(shell)

    bs = cfg.block_size
    local = np.stack(np.meshgrid(*[np.arange(bs)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    g = (vol.block_coords.numpy()[:, None, :] * bs + local[None]).astype(np.float32)
    tsdf = np.clip((np.linalg.norm(g * cfg.voxel_size, axis=-1) - r) / cfg.trunc_dist,
                   -1.0, 1.0).astype(np.float32)
    allocated = (np.arange(cfg.num_blocks) >= 1) & (np.arange(cfg.num_blocks) <= nb_alloc)
    tsdf[~allocated] = 1.0
    weight = np.broadcast_to(allocated[:, None], tsdf.shape).astype(np.float32)
    vol = dataclasses.replace(vol, hash_codes=codes, hash_values=values, free_count=free,
                              tsdf=t(tsdf), weight=t(weight))

    mesh = tm.extract_mesh(vol, cfg)
    count = int(mesh.count)
    assert int(mesh.overflow) == 0
    area_cells = 4 * np.pi * r * r / cfg.voxel_size ** 2
    assert 1.2 * area_cells < count < 3.0 * area_cells, (count, area_cells)
    verts = mesh.positions[:count].numpy().reshape(-1, 3)
    err = np.abs(np.linalg.norm(verts, axis=-1) - r)
    assert np.median(err) < 0.5 * cfg.voxel_size
    assert err.max() < 2.0 * cfg.voxel_size
