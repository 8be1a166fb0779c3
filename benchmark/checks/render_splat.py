"""render_splat: ``render_mismatch`` of the surfel splat.  The last
frame's model maps against the reference's render (``reference/splat.py``)
of the program's final volume at the last pose: the share of the pixels
valid on either side where the validity, the depth (by more than
``check.RENDER_DEPTH_TOL``), the normal (by more than 1e-3 a component)
or the luma (by more than 2/4095) differs.  The reference follows the
splat's default path alone: surfels, luma model colour, no polish."""
import torch

from benchmark import check
from benchmark.reference import splat

NUMBERS = ("render_mismatch",)
FOLLOWS = {"render_mode": ("splat",), "splat_source": ("surfels",), "splat_polish": (0,),
           "model_color": ("luma",), "ablate": ("",)}
SHARES = ("render",)


def read(pipe):
    return {"volume": check.program_volume(pipe), "model": check.program_model(pipe)}


def differ(got, want):
    return ((torch.abs(got["normal"] - want["normal"]) > 1e-3).any(-1)
            | (torch.abs(got["intensity"] - want["intensity"]) > 2.0 / 4095.0))


def render(inp, dtype):
    return splat.render(inp.program["volume"], *inp.last_pose(), inp.config, dtype)


def numbers(inp, shared):
    shared["render"] = render(inp, torch.float32)
    return {"render_mismatch": check.render_mismatch(inp.program["model"], shared["render"],
                                                     differ)}


def control(inp, shared):
    return {"render_mismatch": check.render_mismatch(render(inp, torch.bfloat16),
                                                     shared["render"], differ)}
