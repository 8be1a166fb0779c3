"""Trajectory evaluation and TUM trajectory files (host numpy).

The same algorithms as ``vulcan_tpu/utils/evaluate.py``: ATE RMSE by
closed-form SVD rigid alignment, greedy nearest-timestamp association (the
TUM ``associate.py`` algorithm), rotation matrix to quaternion, and the
TUM trajectory writer; kept here so the port imports nothing of the JAX
package.
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
    """Absolute trajectory error RMSE after Horn alignment (meters)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape or est.ndim != 2 or est.shape[1] != 3:
        raise ValueError(f"need two (N, 3) arrays, got {est.shape}, {gt.shape}")
    R, t = horn_align(est, gt)
    err = np.linalg.norm(est @ R.T + t - gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def associate_timestamps(
    ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02
):
    """Greedy nearest-timestamp association (TUM associate.py algorithm).

    Returns list of (i, j) index pairs with |ts_a[i]-ts_b[j]| <= max_dt,
    each index used at most once, best matches first.
    """
    pairs = []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        dt = abs(float(ts_b[j] - ta))
        if dt <= max_dt:
            pairs.append((dt, i, j))
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    out.sort()
    return out


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation matrix -> (4,) quaternion (qx, qy, qz, qw), unit.

    Shepperd's method (numerically stable branch selection); inverse of
    io/tum.py:quat_to_rotmat and the TUM trajectory-file convention.
    """
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def write_tum_trajectory(path: str, stamps, rotations, translations) -> None:
    """Write a TUM-format trajectory file: ``ts tx ty tz qx qy qz qw``
    per line -- directly consumable by the TUM benchmark tools."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, R, t in zip(stamps, rotations, translations):
            q = rotmat_to_quat(R)
            f.write(
                f"{float(ts):.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )
