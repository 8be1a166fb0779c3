"""trajectory: ``ate_m``, the trajectory's RMSE after Horn alignment
against the true poses, every frame of the run (warm-up, window and
traced frames).  Its reference is the truth the traffic was rendered
from; the control works that truth out in bfloat16."""
import numpy as np
import torch

from benchmark import scene
from benchmark.reference import trajectory

NUMBERS = ("ate_m",)
FOLLOWS = {}
TRACK = True


def numbers(inp, shared):
    return {"ate_m": trajectory.ate_rmse(inp.run["trans"], inp.gt_trans)}


def control(inp, shared):
    rot16, trans16 = scene.trajectory(inp.traffic, dtype=torch.bfloat16)
    idx = np.arange(len(inp.run["rot"])) % inp.turn
    return {"ate_m": trajectory.ate_rmse(trans16.double().numpy()[idx], inp.gt_trans)}
