"""What the probe kernels T1-T3 compute on the host: the smem gather's
partition and shared-memory layout (``cuda_kernels.smem_plan``) and the
fused fill+smooth kernel's strips with their halo
(``cuda_kernels.fused_strips``).

The kernels themselves run on the card only; these tests hold the pure
functions their launches are built from, and show with the plain PyTorch
version that a strip with a halo of ``rounds + 1`` pixels computes exactly
what the whole image does (tolerance 0: the same operations on the same
values), and that a halo of ``rounds`` does not.
"""
import numpy as np
import pytest
import torch

from vulcan_tpu_torch.config import Config
from vulcan_tpu_torch.ops import cuda_kernels, splat
from vulcan_tpu_torch.tools import bench_gather, bench_stencil

INF = float("inf")


@pytest.mark.parametrize("cpb,blocks", [(16, 1), (8, 1), (4, 1), (2, 1), (2, 2), (8, 2), (16, 2),
                                        (8, 4)])
@pytest.mark.parametrize("t_rows,cols,n,sms", [
    (2048, 128, 2048, 132),     # T2, T3
    (2048, 128, 7, 132),        # fewer rows than slabs
    (1024, 48, 1000, 132),
    (64, 16, 3001, 132),        # one group at 16 columns a block
    (2048, 16, 1000, 8),        # a small card
])
def test_smem_plan_owns_every_element_once(t_rows, cols, n, sms, cpb, blocks):
    """The smem path's partition as a pure function: every (row, column) of
    idx is taken by exactly one block, the blocks of a cluster load every
    row of the table exactly once between them, and the staged words fit a
    block."""
    plan = cuda_kernels.smem_plan(t_rows, cols, n, sms, cpb, blocks)
    cuda_kernels.check_gather_plan("smem", plan, t_rows, n)
    gx, gy = plan.grid(cols)
    assert plan.cols_per_block * plan.copies == cuda_kernels.GATHER_COLS
    assert gx % plan.cluster_blocks == 0 and gx >= plan.cluster_blocks
    assert gx * gy <= max(sms, gy * plan.cluster_blocks)
    assert plan.smem_bytes(t_rows) <= cuda_kernels.GATHER_BLOCK_BYTES
    assert plan.rows_per_slab * plan.row_slabs >= n
    taken = np.zeros((n, cols), dtype=np.int32)
    for by in range(gy):
        for bx in range(gx):
            r0, r1, c0, c1 = plan.block_extent(bx, by, n)
            taken[r0:r1, c0:c1] += 1
            assert c1 - c0 == plan.cols_per_block
        for first in range(0, gx, plan.cluster_blocks):
            loaded = np.zeros(t_rows, dtype=np.int32)
            for bx in range(first, first + plan.cluster_blocks):
                lo, hi = plan.staged_rows(bx, t_rows)
                loaded[lo:hi] += 1
            assert (loaded == 1).all()
    assert (taken == 1).all()


@pytest.mark.parametrize("cpb", [2, 4, 8, 16])
def test_smem_layout_keeps_each_virtual_column_on_two_banks(cpb):
    """(copy, row, column) map to distinct words of a block's shared memory,
    16 a row, and the 16 (copy, column) pairs a half-warp asks for lie on
    the banks pair + 16 (row mod 2): two lanes of a warp collide only when
    their rows share parity."""
    t_rows = 64
    plan = cuda_kernels.smem_plan(t_rows, 128, 512, 132, cpb)
    words = {}
    for q in range(plan.copies):
        for r in range(t_rows):
            for j in range(cpb):
                words[plan.word(q, r, j)] = (q, r, j)
    assert len(words) == t_rows * cuda_kernels.GATHER_COLS
    assert max(words) * 4 + 4 == plan.smem_bytes(t_rows)
    for word, (q, r, j) in words.items():
        assert word % 32 == q * cpb + j + 16 * (r % 2)
    # lane l of a warp reads virtual column l mod 16, whose column is l mod cpb
    for lane in range(32):
        q, j = divmod(lane % 16, cpb)
        assert j == lane % cpb and q < plan.copies


def test_smem_plan_refuses_what_the_card_cannot_hold():
    """A forced variant the kernel cannot run raises ``ValueError`` on the
    CPU, before anything is built."""
    with pytest.raises(ValueError, match="do not fit"):
        cuda_kernels.smem_plan(4096, 128, 64, 132)
    with pytest.raises(ValueError, match="power of two"):
        cuda_kernels.smem_plan(2048, 128, 64, 132, cols_per_block=3)
    for cpb in (1, 32):
        with pytest.raises(ValueError, match="2 to 16 columns"):
            cuda_kernels.smem_plan(2048, 128, 64, 132, cols_per_block=cpb)
    with pytest.raises(ValueError, match="cluster"):
        cuda_kernels.smem_plan(2048, 128, 64, 132, cluster_blocks=16)
    with pytest.raises(ValueError, match="whole clusters"):
        cuda_kernels.smem_plan(2048, 128, 64, 132, cluster_blocks=2, row_slabs=3)
    table = torch.ones((2048, 16))
    idx = torch.zeros((40, 16), dtype=torch.int32)
    good = cuda_kernels.smem_plan(2048, 16, 40, 132)
    assert torch.equal(bench_gather.chained_gather(table, idx, 2, plan=good),
                       torch.full((40, 16), 2.0))
    for plan, path in [
        (cuda_kernels.SmemPlan(8, 16, 16, 4), None),             # a cluster of 16
        (cuda_kernels.SmemPlan(8, 2, 3, 20), None),              # not whole clusters
        (cuda_kernels.SmemPlan(8, 1, 2, 4), None),               # covers 8 of 40 rows
        (cuda_kernels.SmemPlan(1, 1, 40, 1), None),              # one column a block
        (cuda_kernels.gather_plan(2048, 16, 40, 132), None),     # the columns path's plan
        (good, "columns"), (good, "l2"),
    ]:
        with pytest.raises(ValueError, match="chained_gather"):
            bench_gather.chained_gather(table, idx, 2, path=path, plan=plan)
    assert cuda_kernels._lib is None


def test_smem_plan_default_fills_the_card_with_blocks_alone():
    plan = cuda_kernels.smem_plan(2048, 128, 2048, 132)
    assert (plan.cols_per_block, plan.copies, plan.cluster_blocks) == (16, 1, 1)
    assert plan.grid(128) == (16, 8) and plan.rows_per_slab == 128
    half = cuda_kernels.smem_plan(2048, 128, 2048, 132, cols_per_block=8)
    assert (half.copies, half.grid(128), half.rows_per_slab) == (2, (8, 16), 256)


@pytest.mark.parametrize("strip_rows", [1, 8, 16, 33])
@pytest.mark.parametrize("rounds", [0, 2, 4])
@pytest.mark.parametrize("h,w", [(480, 640), (121, 161), (479, 641), (5, 3)])
def test_fused_strips_tile_the_image_once(h, w, rounds, strip_rows):
    """T1's strips: every pixel lies in exactly one warp's output rectangle,
    and a rectangle with ``rounds + 1`` columns of halo on each side is what
    the warp's 32 lanes hold."""
    strips = cuda_kernels.fused_strips(h, w, rounds, strip_rows)
    core = cuda_kernels.fused_core(rounds)
    assert len(strips) == -(-h // strip_rows) * -(-w // core)
    seen = np.zeros((h, w), dtype=np.int32)
    for y0, y1, x0, x1 in strips:
        assert 0 < y1 - y0 <= strip_rows and 0 < x1 - x0 <= core
        assert (x1 - x0) + 2 * (rounds + 1) <= 32
        seen[y0:y1, x0:x1] += 1
    assert (seen == 1).all()


def _stripwise(d: torch.Tensor, config: Config, strip_rows: int, halo: int) -> torch.Tensor:
    """The plain version applied strip by strip, as T1's warps do: each
    strip of ``fused_strips`` with ``halo`` pixels around it, pixels outside
    the image +inf in every round (they are never filled), the strip's own
    rectangle kept."""
    h, w = d.shape
    mu, rounds = config.trunc_dist, config.splat_fill_rounds
    out = torch.empty_like(d)
    padded = torch.full((h + 2 * halo, w + 2 * halo), INF)
    padded[halo:halo + h, halo:halo + w] = d
    outside = torch.ones_like(padded, dtype=torch.bool)
    outside[halo:halo + h, halo:halo + w] = False
    for y0, y1, x0, x1 in cuda_kernels.fused_strips(h, w, rounds, strip_rows):
        rows, cols = slice(y0, y1 + 2 * halo), slice(x0, x1 + 2 * halo)
        tile, off = padded[rows, cols], outside[rows, cols]
        for _ in range(rounds):
            tile = torch.where(off, INF, splat._fill_smooth_steps(tile, mu, 1, False))
        tile = splat._fill_smooth_steps(tile, mu, 0, True)
        out[y0:y1, x0:x1] = tile[halo:halo + y1 - y0, halo:halo + x1 - x0]
    return out


def _patchy(h: int, w: int, seed: int) -> torch.Tensor:
    """A sloped surface with a step, noise, 25% holes and hole patches that
    take several rounds to close."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 1.5 + 0.3 * np.sin(xx / 40.0) + 0.2 * yy / h + 0.5 * (xx > w / 2)
    d = (d + rng.normal(0.0, 0.003, (h, w))).astype(np.float32)
    d[rng.random((h, w)) < 0.25] = np.inf
    for _ in range(max(2, h * w // 3000)):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        sy, sx = rng.integers(2, 10, size=2)
        d[y0:y0 + sy, x0:x0 + sx] = np.inf
    return torch.from_numpy(d)


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("h,w,strip_rows", [(480, 640, 60), (121, 161, 16), (5, 3, 2)])
def test_stripwise_plain_equals_whole_image(h, w, strip_rows, rounds):
    """A strip with a halo of ``rounds + 1`` computes exactly the whole
    image's pixels: T1's partition loses nothing (tolerance 0)."""
    cfg = bench_stencil.probe_config(Config().trunc_dist, rounds)
    d = _patchy(h, w, seed=h + rounds)
    want = bench_stencil.fill_smooth_plain(d, cfg)
    got = _stripwise(d, cfg, strip_rows, halo=rounds + 1)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert 0 < float(torch.isfinite(want).float().mean()) < 1 or (h, w) == (5, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_stripwise_needs_the_halo_of_rounds_plus_one(rounds):
    """Built to need it: the last column of the first strip is empty and is
    filled from the left in the last round; in the same round the column to
    its right is filled from a surface ``rounds + 1`` columns away, and the
    smoothing then averages the two.  A halo of ``rounds`` never sees that
    surface."""
    core = cuda_kernels.fused_core(rounds)
    cfg = bench_stencil.probe_config(Config().trunc_dist, rounds)
    d = torch.full((9, 2 * core), 1.0)
    d[:, core - rounds:core + rounds] = INF
    d[:, core + rounds:] = 1.0 - 0.2 * cfg.trunc_dist
    want = bench_stencil.fill_smooth_plain(d, cfg)
    assert torch.isfinite(want).all()
    assert torch.equal(_stripwise(d, cfg, 4, halo=rounds + 1), want)
    short = _stripwise(d, cfg, 4, halo=rounds)
    assert not torch.equal(short[:, core - 1], want[:, core - 1])


def test_fused_wrapper_refuses_bad_strips():
    with pytest.raises(ValueError, match="rounds"):
        cuda_kernels.fused_strips(480, 640, 5)
    with pytest.raises(ValueError, match="strip_rows"):
        cuda_kernels.fused_strips(480, 640, 2, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.fill_smooth_fused(torch.ones((8, 8)), 2, 0.16, 0.04, strip_rows=0)
    assert cuda_kernels._lib is None
