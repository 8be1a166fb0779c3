"""volume: ``volume_mismatch``, the share of the observed voxels of a
sample of blocks whose TSDF (by more than 1e-3), weight, colour (by more
than one level) or colour weight differs from the reference's fusion
(``reference/integrate.py``) of every fused frame of the run at the poses
the program fused them at.  The sample, drawn from the seed, takes a third
each from the program's allocated blocks, the reference's band of the last
fused frame and the blocks holding the surface of ``render``, the
reference's render of the program's final volume (a render check listed
before this one), so that the volume the render check reads is itself
checked."""
import numpy as np
import torch

from benchmark import check
from benchmark.reference import integrate

NUMBERS = ("volume_mismatch",)
FOLLOWS = {"ablate": ("",)}
NEEDS = ("render",)
SAMPLE_BLOCKS = 384


def read(pipe):
    return {"volume": check.program_volume(pipe)}


def sample_blocks(inp, rendered: dict) -> torch.Tensor:
    """Block coordinates (K, 3) drawn from the seed, a third from each of:
    the blocks the program allocated; the reference's truncation band of
    the last fused frame (so that blocks the program failed to allocate
    are sampled too); and the blocks that hold the surface points of
    ``rendered``."""
    rng = np.random.default_rng(inp.seed)
    part = SAMPLE_BLOCKS // 3

    def draw(keys: torch.Tensor) -> torch.Tensor:
        pick = rng.choice(keys.numel(), size=min(part, keys.numel()), replace=False)
        return keys[torch.from_numpy(pick).to(keys.device)]

    vol = inp.program["volume"]
    prog = integrate.block_key(vol["block_coords"][1:vol["free_count"]])
    i = int(np.flatnonzero(inp.fused)[-1])
    R = torch.from_numpy(inp.run["rot"][i]).to(inp.device)
    t = torch.from_numpy(inp.run["trans"][i]).to(inp.device)
    band = integrate.frame_band(inp.frames, i, R, t, inp.config)[1]
    seen = integrate.surface_keys(rendered["depth"], rendered["valid"], inp.config,
                                  *inp.last_pose())
    return integrate.key_coords(torch.unique(torch.cat([draw(prog), draw(band), draw(seen)])))


def unpack_colors(colorpack: torch.Tensor):
    c = torch.stack([(colorpack >> 16) & 0xFF, (colorpack >> 8) & 0xFF, colorpack & 0xFF], -1)
    return c.to(torch.int32), ((colorpack >> 24) & 0xFF).to(torch.int32)


def program_blocks(vol: dict, blocks: torch.Tensor):
    """The program's TSDF, weight, colour and colour weight of the blocks
    ``blocks`` (K, 3); a block it never allocated reads as unobserved."""
    n = vol["free_count"]
    keys, order = torch.sort(integrate.block_key(vol["block_coords"][1:n]))
    want = integrate.block_key(blocks)
    pos = torch.clamp(torch.searchsorted(keys, want), max=max(keys.numel() - 1, 0))
    found = (keys[pos] == want) if keys.numel() else torch.zeros_like(want, dtype=torch.bool)
    rows = torch.where(found, order[pos] + 1 if keys.numel() else pos, 0)
    col, cw = unpack_colors(vol["colorpack"][rows])
    f = found[:, None]
    return (torch.where(f, vol["tsdf"][rows], 1.0), torch.where(f, vol["weight"][rows], 0.0),
            torch.where(f[..., None], col, 0), torch.where(f, cw, 0))


def mismatch(got, want) -> float:
    """Share of the voxels observed on either side that differ."""
    gt, gw, gc, gcw = got
    wt, ww, wc, wcw = want
    seen = (gw > 0) | (ww > 0)
    bad = ((torch.abs(gt - wt) > 1e-3) | (torch.abs(gw - ww) > 0.5)
           | (torch.abs(gc - wc) > 1).any(-1) | (gcw != wcw))
    n = int(seen.sum())
    return float((bad & seen).sum()) / n if n else 1.0


def fuse(inp, blocks, dtype):
    r = inp.run
    return integrate.fuse_history(inp.frames, r["rot"], r["trans"], inp.fused, blocks,
                                  inp.config, dtype)


def numbers(inp, shared):
    blocks = sample_blocks(inp, shared["render"])
    shared["volume.blocks"] = blocks
    shared["volume.fused"] = fuse(inp, blocks, torch.float32)
    return {"volume_mismatch": mismatch(program_blocks(inp.program["volume"], blocks),
                                        shared["volume.fused"])}


def control(inp, shared):
    return {"volume_mismatch": mismatch(fuse(inp, shared["volume.blocks"], torch.bfloat16),
                                        shared["volume.fused"])}
