"""render_march: ``render_mismatch`` of the hierarchical TSDF march.  The
last frame's model maps against the reference's march
(``reference/march.py``) of the program's final volume at the last pose:
the share of the pixels valid on either side where the validity or the
depth (by more than ``check.RENDER_DEPTH_TOL``) differs."""
import torch

from benchmark import check
from benchmark.reference import march

NUMBERS = ("render_mismatch",)
FOLLOWS = {"render_mode": ("march",), "ablate": ("",)}
SHARES = ("render",)


def read(pipe):
    return {"volume": check.program_volume(pipe), "model": check.program_model(pipe)}


def render(inp, dtype):
    return march.render(inp.program["volume"], *inp.last_pose(), inp.config, dtype)


def numbers(inp, shared):
    shared["render"] = render(inp, torch.float32)
    return {"render_mismatch": check.render_mismatch(inp.program["model"], shared["render"])}


def control(inp, shared):
    return {"render_mismatch": check.render_mismatch(render(inp, torch.bfloat16),
                                                     shared["render"])}
