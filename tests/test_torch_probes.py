"""The port's kernel probes (T1-T5) against the JAX tools' Pallas kernels.

The JAX tools under ``tools/`` are imported by path and their
``pallas_call``s run in interpret mode on the CPU; the JAX package and the
tools are not changed for it.  Tolerances: exact for T2-T5 (integer
indexing, selection, and float adds in the same round order), 1e-6 m for
T1 (min/max fill is exact; the smoothing sum and division are the
reference's own order, so ulps at most).
"""
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from vulcan_tpu_torch.config import Config
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.tools import bench_gather, bench_stencil, bench_subsample

ROOT = Path(__file__).resolve().parents[1]
T1_TOL = 1e-6


def _load_tool(name: str):
    """Import ``tools/<name>.py`` under its own module name (the tools
    import each other by bare name, as when run from the repo root)."""
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode, as the JAX package's own
    CPU tests run its kernels."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def gather_cases():
    """Run the JAX tool's main() with ``run`` replaced by a capture of each
    case's function, arguments and interpreted output."""
    tool = _load_tool("bench_pallas_gather")
    captured = []

    def capture(tag, fn, *args):
        out = np.asarray(jax.jit(fn)(*args))
        captured.append((tag, [np.asarray(a) for a in args], out))
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True))
        mp.setattr(tool, "run", capture)
        tool.main()
    assert len(captured) == 3
    return dict(zip(("T2", "T3", "T4"), captured))


@pytest.mark.parametrize("name", ["T2", "T3", "T4"])
def test_chained_gather_matches_pallas(gather_cases, name):
    """T2-T4: the plain chained gather on the tool's own arrays equals the
    interpreted Pallas kernel bit for bit, and the port draws the same
    arrays from the same seed."""
    tag, (table, idx), want = gather_cases[name]
    case = {c.name: c for c in bench_gather.make_cases("cpu")}[name]
    assert case.rounds == (4 if name == "T4" else 32), tag
    np.testing.assert_array_equal(case.table.numpy(), table)
    np.testing.assert_array_equal(case.idx.numpy(), idx)
    got = bench_gather.chained_gather(
        torch.from_numpy(table.copy()), torch.from_numpy(idx.copy()), case.rounds
    )
    assert got.dtype == (torch.int32 if name == "T3" else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_subsample_chain_matches_pallas(interpret_pallas, monkeypatch):
    """T5: the tool's chained ``mk(s_pallas)`` (interpreted) against the
    port's plain chain, bit for bit (int32 adds wrap on both sides)."""
    tool = _load_tool("bench_subsample")
    captured = {}

    def capture(tag, fn, x0):
        if "pallas" in tag:
            captured["x0"] = np.asarray(x0)
            captured["out"] = np.asarray(jax.jit(fn)(x0))
        return 1.0

    monkeypatch.setattr(tool, "run_case", capture)
    tool.main()
    assert "out" in captured, "the tool's Pallas candidate did not run"
    x0 = bench_subsample.make_input("cpu")
    np.testing.assert_array_equal(x0.numpy(), captured["x0"])
    got = bench_subsample.chain(bench_subsample.subsample2, x0)
    np.testing.assert_array_equal(got.numpy(), captured["out"])
    s = bench_subsample.subsample2(x0)
    np.testing.assert_array_equal(s.numpy(), captured["x0"][::2, ::2])


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int32", "float32"])
@pytest.mark.parametrize("shape", [(479, 641), (2, 6), (1, 1), (5, 3)])
def test_subsample_on_cpu_equals_numpy_stride2(shape, dtype):
    """The T5 wrapper on a CPU tensor (its plain version) is numpy's
    ``x[::2, ::2]`` bit for bit, at odd and tiny shapes."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)
         if dtype == np.int32 else rng.standard_normal(shape).astype(np.float32))
    before = bench_subsample.subsample2.launches
    got = bench_subsample.subsample2(torch.from_numpy(x))
    assert bench_subsample.subsample2.launches == before
    assert got.is_contiguous() and got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy().view(np.int32), x[::2, ::2].view(np.int32))


def test_fused_fill_smooth_matches_pallas(interpret_pallas):
    """T1: ``make_pallas(48, 64, mu)`` interpreted against the port's plain
    fused version: finite masks equal, max abs error <= 1e-6 m."""
    tool = _load_tool("bench_pallas_stencil")
    mu = Config().trunc_dist
    d = bench_stencil.make_input(48, 64, "cpu")
    want = np.asarray(tool.make_pallas(48, 64, mu)(d.numpy()))
    got = bench_stencil.fill_smooth_fused(d, bench_stencil.probe_config(mu)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert 0 < fin.mean() < 1
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=T1_TOL)


def test_fused_plain_is_k2_math():
    """The fused probe's plain version is K2's math at mu, 2 rounds: the
    main path's wrapper gives the same image on the CPU."""
    cfg = bench_stencil.probe_config(Config().trunc_dist)
    assert cfg.splat_fill_rounds == 2
    d = bench_stencil.make_input(40, 56, "cpu")
    np.testing.assert_array_equal(bench_stencil.fill_smooth_fused(d, cfg).numpy(),
                                  bench_stencil.fill_smooth_k2(d, cfg).numpy())


@pytest.mark.parametrize(
    "tool,argv",
    [
        (bench_subsample, []),
        (bench_gather, []),
        (bench_stencil, ["48x64"]),
    ],
    ids=["subsample", "gather", "stencil"],
)
def test_probe_runs_end_to_end_on_cpu(tool, argv, capsys):
    """Each probe runs its cases through ``main`` with ``--device cpu``,
    checks them and prints its rates; nothing launches a kernel."""
    counts = (bench_subsample.subsample2.launches, bench_stencil.fill_smooth_fused.launches,
              dict(bench_gather.chained_gather.launches))
    result = tool.main(["--device", "cpu", *argv])
    assert result
    out = capsys.readouterr().out
    assert "host clock, CPU" in out
    assert counts == (bench_subsample.subsample2.launches,
                      bench_stencil.fill_smooth_fused.launches,
                      dict(bench_gather.chained_gather.launches))
    assert cuda_kernels._lib is None


@pytest.mark.parametrize("tool", [bench_subsample, bench_gather, bench_stencil],
                         ids=["subsample", "gather", "stencil"])
def test_probe_without_device_needs_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tool.main([])


_GOOD = {
    "fill_smooth_fused": lambda: (torch.ones((8, 8)),),
    "chained_gather": lambda: (torch.ones((16, 16)), torch.zeros((16, 16), dtype=torch.int32)),
    "subsample2": lambda: (torch.ones((8, 8), dtype=torch.int32),),
}


def _launch(name, args):
    if name == "fill_smooth_fused":
        return cuda_kernels.fill_smooth_fused(*args, 2, 0.16, 0.04)
    if name == "chained_gather":
        return cuda_kernels.chained_gather(*args, 4)
    return cuda_kernels.subsample2(*args)


@pytest.mark.parametrize("name", sorted(_GOOD))
@pytest.mark.parametrize("fault", ["cpu", "dtype", "strided"])
def test_probe_binding_refuses(name, fault):
    """Each new binding raises on what its kernel does not take, before
    anything is built or loaded."""
    args = list(_GOOD[name]())
    if fault == "dtype":
        args[0] = args[0].to(torch.float64)
        err, match = TypeError, "expected"
    elif fault == "strided":
        args[0] = args[0].t()
        err, match = ValueError, "contiguous"
    else:
        err, match = ValueError, "CUDA tensor"
    with pytest.raises(err, match=match):
        _launch(name, args)
    assert cuda_kernels._lib is None


@pytest.mark.parametrize("shape", [(24, 16), (16, 8)], ids=["height", "width"])
def test_gather_binding_refuses_shape(shape):
    """The chained gather takes a power-of-two height (its remainder is a
    mask) and a width of whole 16-column groups (its 16-byte staging)."""
    table = torch.ones(shape)
    idx = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        cuda_kernels.chained_gather(table, idx, 4)
    assert cuda_kernels._lib is None


def test_gather_path_by_table_height():
    assert cuda_kernels.gather_path(2048) == "smem"
    assert cuda_kernels.gather_path(4096) == "columns"
    assert cuda_kernels.gather_path(16384) == "columns"
    assert cuda_kernels.gather_path(32768) == "columns"
    assert cuda_kernels.gather_path(65536) == "l2"      # one column: 256 KB
    assert bench_gather.launch_key(torch.zeros((2048, 4), dtype=torch.int32)) == "int32/smem"
    assert bench_gather.launch_key(torch.zeros((16384, 16))) == "float32/columns"
    assert bench_gather.launch_key(torch.zeros((16384, 16)), "l2") == "float32/l2"
    assert bench_gather.launch_key(torch.zeros((2048, 16)), "columns") == "float32/columns"
    assert set(bench_gather.chained_gather.launches) == {
        f"{dt}/{path}" for dt in ("float32", "int32") for path in ("smem", "columns", "l2")}


@pytest.mark.parametrize("rows,path", [(4096, "smem"), (65536, "columns"), (65536, "smem"),
                                       (2048, "vmem")])
def test_forced_gather_path_raises_where_it_cannot_hold_the_table(rows, path):
    """A forced path that cannot hold the table raises, for a CPU tensor
    too, before anything is built; a path that can is taken as asked."""
    with pytest.raises(ValueError, match="path"):
        cuda_kernels.check_gather_path(rows, path)
    table = torch.ones((rows, 16))
    idx = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="path"):
        bench_gather.chained_gather(table, idx, 2, path=path)
    got = bench_gather.chained_gather(table, idx, 2, path="l2")
    assert torch.equal(got, torch.full((4, 16), 2.0))
    assert cuda_kernels._lib is None


def test_gather_plan_refuses_columns_that_do_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        cuda_kernels.gather_plan(65536, 128, 64, 132)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_kernels.gather_plan(32768, 128, 64, 132, cols_per_block=2)
    with pytest.raises(ValueError, match="do not fit"):     # 4 columns: 256 KB
        cuda_kernels.gather_plan(16384, 128, 64, 132, cluster_blocks=4, cols_per_block=4)
    with pytest.raises(ValueError, match="power of two"):
        cuda_kernels.gather_plan(16384, 128, 64, 132, cols_per_block=3)
    with pytest.raises(ValueError, match="at most"):
        cuda_kernels.gather_plan(4096, 128, 64, 132, cluster_blocks=16, cols_per_block=2)
    # two columns a block where they fit, one where not; two row slabs fill 128 of 132 SMs
    assert cuda_kernels.gather_plan(16384, 128, 16384, 132) == (2, 1, 2, 8192, False)
    assert cuda_kernels.gather_plan(32768, 128, 16384, 132) == (1, 1, 1, 16384, False)


@pytest.mark.parametrize("t_rows,cols,n,sms,kw", [
    (16384, 128, 16384, 132, {}),                                   # T4
    (16384, 128, 16384, 132, dict(cols_per_block=1)),
    (16384, 128, 16384, 132, dict(cluster_blocks=8, cols_per_block=2)),
    (16384, 128, 16384, 132, dict(cluster_blocks=16)),
    (16384, 128, 1000, 132, dict(cluster_blocks=8, cols_per_block=1)),
    (16384, 128, 1000, 132, {}),                                    # ragged N
    (16384, 128, 7, 132, {}),                                       # fewer rows than blocks
    (4096, 16, 5000, 132, {}),                                      # L = 16
    (4096, 16, 5000, 8, dict(cluster_blocks=4)),                    # a small card
    (32768, 32, 100000, 132, {}),                                   # one column a block
], ids=["T4", "T4-1col", "T4-8blocks", "T4-16blocks", "ragged-8blocks", "ragged", "7rows",
        "L16", "L16-8sms", "T32768"])
def test_gather_plan_owns_every_element_once(t_rows, cols, n, sms, kw):
    """The columns path's partition as a pure function: every (row, column)
    of idx is taken by exactly one block, every column of the table is held
    by exactly one block of each cluster that asks for it, whole, and fits."""
    plan = cuda_kernels.gather_plan(t_rows, cols, n, sms, **kw)
    gx, gy = plan.grid(cols)
    assert gx % plan.cluster_blocks == 0 and gx * gy <= max(sms, gx)
    assert plan.smem_bytes(t_rows) <= cuda_kernels.GATHER_BLOCK_BYTES
    assert plan.group_cols in (1, 2, 4, 8, 16)
    assert plan.rows_per_slab * plan.row_slabs >= n
    taken = np.zeros((n, cols), dtype=np.int32)
    for by in range(gy):
        held = np.zeros((t_rows, cols), dtype=np.int32)
        for bx in range(gx):
            r0, r1, c0, c1 = plan.block_extent(bx, by, n)
            taken[r0:r1, c0:c1] += 1
            tr0, tr1, tc0, tc1 = plan.staged_extent(bx, t_rows)
            held[tr0:tr1, tc0:tc1] += 1
            # the block's own columns lie inside the group it gathers for
            group0 = bx // plan.cluster_blocks * plan.group_cols
            assert group0 <= c0 <= tc0 and tc1 <= c1 <= group0 + plan.group_cols
            assert tc1 - tc0 == plan.cols_per_block
        assert (held == 1).all()
    assert (taken == 1).all()
