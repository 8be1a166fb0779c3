"""Guards of the PyTorch port: no JAX, no OpenCV, no nvcc or GPU needed
to import, plain versions only for CPU tensors, the native runtime built
under build/ and raising when it cannot be built, and a chip smoke test
that refuses to run without a card."""
import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu_torch.ops import cuda_kernels, sparse, splat
from vulcan_tpu_torch.pipeline import fusion

from ._torch_port import CAM_T, CFG_T, H, W, no_kernel, orbit, scene, se3_t

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "vulcan_tpu_torch"


def _run(code: str, env=None, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=cwd, env=env, timeout=300,
    )


def test_import_pulls_in_no_jax():
    mods = ", ".join(
        "vulcan_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in sorted(PKG.rglob("*.py")) if p.name != "__init__.py"
    )
    for m in ("ops.render_cache", "cli", "io.tum", "utils.runtime", "utils.timing",
              "native.build", "parallel.sharding", "tools.cli_counts"):
        assert f"vulcan_tpu_torch.{m}" in mods.split(", "), m
    proc = _run(
        "import importlib, sys\n"
        f"for m in '{mods}'.split(', '): importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'vulcan_tpu', 'cv2')]\n"
        "print('BAD', bad)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|vulcan_tpu|cv2)(\s|\.|$)", re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path


def test_sources_build_no_path_into_the_reference():
    """No string in the port's code (docstrings aside) names the JAX
    package or a file in it: nothing is loaded from ``vulcan_tpu/`` by
    path; what the port needs of it, it keeps a copy of."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
        }
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not re.search(r"(^|[^_\w])vulcan_tpu($|[/.\\])", node.value), (
                    path, node.value)
        assert not re.search(r"spec_from_file_location|SourceFileLoader|runpy",
                             path.read_text()), path


def test_kernel_module_imports_without_nvcc_or_gpu(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               CUDA_VISIBLE_DEVICES="")
    proc = _run(
        "from vulcan_tpu_torch.ops import cuda_kernels as k\n"
        "import torch\n"
        "assert k._lib is None and not torch.cuda.is_available()\n"
        "print(k.library_path().name)\n",
        env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert "libvulcan_tpu_torch.so" in proc.stdout


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building raises a clear error, nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(cuda_kernels, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_kernels._nvcc()


def _icp_live(x):
    """A live level for the track kernels' entry points: depth, vertices,
    normals, intensity."""
    v = x[..., None].expand(*x.shape, 3).contiguous()
    return x, v, v, x


_ICP_MAPS = tuple(torch.zeros((8, 8), dtype=torch.int32) for _ in range(3))
_ICP_CAM = (100.0, 100.0, 4.0, 4.0)


def _integrate_on(x):
    """I1's entry point on CPU tensors of 4 blocks: a list, its count, the
    pose, the packed image and the volume's arrays."""
    i32 = dict(dtype=torch.int32)
    vox = torch.zeros((4, 512))
    return cuda_kernels.integrate(
        torch.arange(4, **i32), torch.tensor(2, **i32), x.new_zeros(12), x.to(torch.int32),
        torch.zeros((4, 3), **i32), (vox, vox.clone(), vox.to(torch.int32)),
        (torch.zeros((4, 8), **i32), torch.zeros(4, **i32), torch.zeros(4, dtype=torch.bool)),
        torch.tensor(0, **i32), _ICP_CAM, sparse.i1_scalars(CFG_T))


def _splat_zbuf_on(x):
    """S1's entry point on CPU tensors of 4 blocks: the luma buffer, the
    visible list, its count, the surfels, the colours, the coordinates and
    the pose."""
    i32 = dict(dtype=torch.int32)
    return cuda_kernels.splat_zbuf(
        x.to(torch.int32), "luma", torch.arange(4, **i32), torch.tensor(2, **i32),
        (torch.zeros((4, 8), **i32), torch.zeros(4, **i32)), torch.zeros((4, 512), **i32),
        torch.zeros((4, 3), **i32), x.new_zeros(15), _ICP_CAM, splat.splat_scalars(CFG_T))


@pytest.mark.parametrize(
    "launch", ["bilateral", "fill_smooth", "fill_smooth_fused", "subsample2",
               "icp_associate", "icp_rows", "icp_solve", "icp_rows_solve", "range_image",
               "integrate", "splat_zbuf"])
def test_kernel_entry_refuses_cpu_tensors(launch):
    """A CUDA entry point given a CPU tensor raises before anything is
    built or loaded (the wrappers never send it one)."""
    fn = {
        "bilateral": lambda x: cuda_kernels.bilateral(
            x, cuda_kernels.bilateral_constants(2, 2.0, 0.05)),
        "fill_smooth": lambda x: cuda_kernels.fill_smooth(
            x, cuda_kernels.fill_smooth_plan(2), 0.08, 0.02),
        "fill_smooth_fused": lambda x: cuda_kernels.fill_smooth_fused(x, 2, 0.08, 0.02),
        "subsample2": lambda x: cuda_kernels.subsample2(x.to(torch.int32)),
        "icp_associate": lambda x: cuda_kernels.icp_associate(
            *_icp_live(x)[:2], x.new_zeros(16), x.new_zeros(15), _ICP_MAPS, None,
            _ICP_CAM, 0.1, 5.0, True, False),
        "icp_rows": lambda x: cuda_kernels.icp_rows(
            *_icp_live(x), x.new_zeros(16), x.new_zeros(15),
            (_icp_live(x)[1], _icp_live(x)[1], x > 0), None, _ICP_CAM,
            (0.1, 5.0, 0.01, 0.8, 0.03, 0.1, 0.1), True, False, False),
        "icp_solve": lambda x: cuda_kernels.icp_solve(
            x.new_zeros((2, 29)), x.new_zeros(16), 1e-4, True, False, False),
        "icp_rows_solve": lambda x: cuda_kernels.icp_rows_solve(
            *_icp_live(x), x.new_zeros(16), x.new_zeros(15),
            (_icp_live(x)[1], _icp_live(x)[1], x > 0), None, _ICP_CAM,
            (0.1, 5.0, 0.01, 0.8, 0.03, 0.1, 0.1), 1e-4, True, False, False),
        "range_image": lambda x: cuda_kernels.range_image(
            x.reshape(-1), x.reshape(-1), (x.reshape(-1).long(),) * 4,
            x.reshape(-1) > 0, torch.tensor(64, dtype=torch.int32), torch.tensor(False),
            x.sum(), x.sum(), (1, 1), 6, 16, (8, 8)),
        "integrate": lambda x: _integrate_on(x),
        "splat_zbuf": lambda x: _splat_zbuf_on(x),
    }[launch]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(torch.ones((8, 8)))
    assert cuda_kernels._lib is None


def test_cpu_step_launches_no_kernel(no_kernel):
    """Whole CPU steps go through the plain versions in every tracking
    mode and in fusion at a given pose: no kernel entry is reached, the
    track's (H1a-H1c and the fused step) among them."""
    poses = orbit(2)
    frames = [scene(pose) for pose in poses]
    for mode in fusion.MODES:
        pipe = P.Pipeline(CFG_T, CAM_T, H, W, init_pose=se3_t(poses[0]), mode=mode,
                          device="cpu")
        for d, c in frames:
            pipe.process(d, c)
        pipe.process(*frames[0], pose=se3_t(poses[0]))
        assert pipe.diagnostics()["frame"] == 3


@pytest.mark.parametrize(
    "setting", [dict(render_mode="march"), dict(splat_source="direct"),
                dict(splat_polish=2)], ids=["march", "direct", "polish"])
def test_render_settings_run_in_pipeline_on_cpu(setting, no_kernel):
    """The render settings that the port once refused run end to end in
    ``Pipeline`` on the CPU, tracked in depth and combined mode and fused
    at a given pose, through the plain versions (no kernel entry reached)."""
    cfg = dataclasses.replace(CFG_T, **setting)
    poses = orbit(2)
    frames = [scene(pose) for pose in poses]
    for mode in ("depth", "combined"):
        pipe = P.Pipeline(cfg, CAM_T, H, W, init_pose=se3_t(poses[0]), mode=mode,
                          device="cpu")
        for d, c in frames:
            pipe.process(d, c)
        err = pipe.pose.translation.numpy() - np.asarray(poses[-1].translation)
        assert float(np.linalg.norm(err)) < 0.01
        pipe.process(*frames[0], pose=se3_t(poses[0]))
        diag = pipe.diagnostics()
        assert diag["frame"] == 3 and diag["track_failures"] == 0
        assert pipe.state.model.valid.float().mean() > 0.3


_HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
               "__index__")


# (mode, known pose, Config overrides, WHILE nodes, IF/ELSE nodes, the
# z-buffer or cache functions the render must reach).  Depth mode's
# auto-photo colour render is a ``cond`` whose two branches are both
# captured: the luma render (tiers, or the render cache and its cached
# z-buffer off the surfel path) and the colourless one.  The march adds
# its render cache's loop and one compaction branch a level to each.
CAPTURED = {
    "depth": ("depth", False, {}, 5, 2, ("_splat_zbuf_surfels",)),
    "color": ("color", False, {}, 3, 0, ("_splat_zbuf_surfels",)),
    "combined": ("combined", False, {}, 3, 0, ("_splat_zbuf_surfels",)),
    "light": ("light", False, {}, 3, 0, ("_splat_zbuf_surfels",)),
    "known-pose": ("depth", True, {}, 3, 0, ("_splat_zbuf_surfels",)),
    "march": ("depth", False, dict(render_mode="march"), 3, 6, ("build",)),
    "march-combined": ("combined", False, dict(render_mode="march"), 2, 2, ("build",)),
    "direct": ("depth", False, dict(splat_source="direct"), 4, 2,
               ("_splat_zbuf_direct", "_splat_zbuf_cached")),
    "polish": ("depth", False, dict(splat_polish=2), 5, 2, ("_splat_zbuf_cached",)),
}


@pytest.mark.parametrize("case", list(CAPTURED))
def test_captured_branches_read_nothing(monkeypatch, case):
    """What a capture traces of ``fusion.step`` (every mode, auto-photo's
    two ``cond``s in depth mode; every renderer: the march, the direct and
    the polished splat) and of ``step_known_pose``, with
    ``sync.capturing()`` true and every conditional node's body run as a
    capture runs it (each WHILE body once a chunk to the capacity, both
    bodies of each IF/ELSE), after two eager frames that ran both sides of
    every ``cond`` (as ``Pipeline``'s warm-up does), reaches no host read
    and makes no tensor from host data: ``read_int`` / ``read_ints``, every
    tensor method that copies to the host, ``torch.tensor`` and
    ``torch.as_tensor`` raise, through ``sparse.integrate_sparse``, the
    render cache, the march and every z-buffer too.  Every loop is one
    WHILE node on a 0-d int32 device count and every ``cond`` one IF/ELSE
    node on a 0-d bool."""
    from vulcan_tpu_torch.ops import render_cache, sparse
    from vulcan_tpu_torch.utils import sync

    mode, known, override, n_loops, n_conds, renders = CAPTURED[case]
    cfg = dataclasses.replace(CFG_T, **override)
    poses = orbit(3)
    frames = [scene(pose) for pose in poses]
    state = fusion.init_state(cfg, CAM_T, H, W, se3_t(poses[0]), "cpu")
    with sync.warm_both():  # a model to track against, as after warm-up
        for d, c in frames[:2]:
            state = fusion.step(state, torch.from_numpy(d.copy()),
                                torch.from_numpy(c.copy()), cfg, mode)
    d, c = (torch.from_numpy(x.copy()) for x in frames[2])
    loops, conds = [], []
    calls = dict.fromkeys(("integrate", *renders), 0)

    def while_node(count, bound, chunk, body):
        loops.append((count, bound, chunk))
        for offset in torch.arange(0, bound, chunk):
            body(offset)

    def cond_node(pred, *bodies):
        conds.append((pred, len(bodies)))
        for body in bodies:
            body()

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    def read(*_a, **_k):
        raise AssertionError("a host read in the captured step")

    def upload(*_a, **_k):
        raise AssertionError("a tensor made from host data in the captured step")

    monkeypatch.setattr(sync, "capturing", lambda: True)
    monkeypatch.setattr(sync, "_while_node", while_node)
    monkeypatch.setattr(sync, "_cond_node", cond_node)
    monkeypatch.setattr(sparse, "integrate_sparse",
                        counted("integrate", sparse.integrate_sparse))
    for name in renders:
        mod = render_cache if name == "build" else splat
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    for mod in (sync, sparse, splat):
        for name in ("read_int", "read_ints"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, read)
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, read)
    monkeypatch.setattr(torch, "tensor", upload)
    monkeypatch.setattr(torch, "as_tensor", upload)
    if known:
        fusion.step_known_pose(state, d, c, se3_t(poses[2]), cfg)
    else:
        fusion.step(state, d, c, cfg, mode)
    monkeypatch.undo()
    assert calls["integrate"] == 1 and all(calls[name] >= 1 for name in renders)
    # The integrate loop, and the render's loops (both of the auto-photo
    # render's branches are captured).
    assert len(loops) == n_loops
    assert (cfg.alloc_capacity, cfg.integrate_chunk) in [(b, c) for _, b, c in loops]
    assert all(n.dtype == torch.int32 and n.ndim == 0 and b % c == 0 for n, b, c in loops)
    assert len(conds) == n_conds
    assert all(p.dtype == torch.bool and p.ndim == 0 and k == 2 for p, k in conds)


def test_uint16_uint8_input_equals_float_input():
    """Raw sensor dtypes convert on the device to the same metric frame."""
    pose = orbit(1)[0]
    d, c = scene(pose)
    d16 = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
    c8 = np.clip(c * 255.0, 0, 255).astype(np.uint8)
    as_f32 = (
        d16.astype(np.float32) * np.float32(1.0 / 5000.0),
        c8.astype(np.float32) * np.float32(1.0 / 255.0),
    )
    depths = []
    for depth, color in ((d16, c8), as_f32):
        pipe = P.Pipeline(CFG_T, CAM_T, H, W, init_pose=se3_t(pose), device="cpu")
        pipe.process(depth, color)
        depths.append(pipe.state.model.depth.numpy())
    assert (depths[0] > 0).mean() > 0.3
    np.testing.assert_array_equal(depths[0], depths[1])


def test_chip_smoke_refuses_without_a_card(tmp_path):
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        proc = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            cwd=cwd, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_chip_smoke_knows_every_counted_kernel():
    """``chip_smoke.py`` holds each frame's launches on the card against
    ``want_per_frame`` and ``want_nodes``: every kernel they name, under
    the splat and under the march, is one the card counts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for config in (P.Config(), P.Config(render_mode="march")):
        assert set(smoke.want_per_frame(config)) <= set(cuda_kernels.COUNTED)
        assert set(smoke.want_nodes(config)) <= set(cuda_kernels.COUNTED)


@pytest.mark.parametrize("entry", ["pipeline", "render_scene_depth", "volume",
                                   "tracker", "make_frame"])
def test_entry_point_without_device_needs_a_card(entry, monkeypatch):
    """With no ``device`` the port's entry points target the card; with no
    card they raise and name ``device="cpu"``, never falling back; with
    ``device="cpu"`` they run."""
    from vulcan_tpu_torch.io.synthetic import render_scene_depth

    calls = {
        "pipeline": lambda **kw: P.Pipeline(CFG_T, CAM_T, H, W, **kw),
        "render_scene_depth": lambda **kw: render_scene_depth(
            CAM_T, se3_t(orbit(1)[0]), H, W, **kw),
        "volume": lambda **kw: P.Volume(CFG_T, **kw),
        "tracker": lambda **kw: P.DepthTracker(CFG_T, **kw),
        "make_frame": lambda **kw: P.make_frame(np.zeros((H, W), np.float32), **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    calls[entry](device="cpu")


def test_native_library_builds_only_under_build():
    from vulcan_tpu_torch import native

    path = native.library_path()
    assert path.is_relative_to(ROOT / "build" / "vulcan_tpu_torch_native")
    native.load()
    assert path.is_file()
    assert not list(PKG.rglob("*.so"))


def test_failed_native_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A native build that fails raises with g++'s stderr, and the TUM
    reader raises with it rather than assuming a 640x480 camera."""
    import cv2

    from vulcan_tpu_torch import native
    from vulcan_tpu_torch.io.tum import TumDataset

    broken = tmp_path / "native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    seq = tmp_path / "seq"
    seq.mkdir()
    cv2.imwrite(str(seq / "d.png"), np.zeros((12, 16), np.uint16))
    (seq / "depth.txt").write_text("1.0 d.png\n")
    with pytest.raises(RuntimeError, match="native build failed(.|\n)*not C"):
        TumDataset(str(seq))
    assert not list((tmp_path / "build").rglob("*.so"))


def test_cli_without_device_needs_a_card(monkeypatch):
    """``vulcan-tpu-torch run`` targets the card; with no card it raises,
    never falling back to the CPU."""
    from vulcan_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["run", "--synthetic", "2"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["mesh", "snapshot.npz", "--out", "m.ply"])
