"""The trajectory's reference: the true poses the traffic was rendered
from, held to the tracked ones by the absolute trajectory error.
``horn_align`` / ``ate_rmse`` are a frozen copy of
``vulcan_tpu_torch/utils/evaluate.py``.  Plain numpy.
"""
from __future__ import annotations

import numpy as np


def horn_align(est: np.ndarray, gt: np.ndarray):
    """Closed-form rigid alignment est->gt for (N,3) point sets.
    Returns (R, t) minimizing ||R @ est + t - gt||^2 (no scale)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    return R, mu_g - R @ mu_e


def ate_rmse(est_positions, gt_positions) -> float:
    """Absolute trajectory error RMSE after Horn alignment (metres)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    R, t = horn_align(est, gt)
    err = np.linalg.norm(est @ R.T + t - gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))
