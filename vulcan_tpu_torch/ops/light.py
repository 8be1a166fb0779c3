"""Scene illumination model for light-aware photometric tracking.

Counterpart of ``vulcan_tpu/ops/light.py``.  The illumination is a
9-coefficient real spherical-harmonics gain field over surface normals,
linear in its coefficients, so estimation is one stacked reduction into a
9x9 normal matrix and a Cholesky solve on the device.  In
``mode="light"`` tracking the model intensity is predicted as
``gain(n_m) * I_model``; the gain is refitted at every association round
with the pose frozen and a ridge prior toward unit gain.
"""
from __future__ import annotations

import dataclasses

import torch

from .icp import LOCAL, Reducer, _sum_positions

#: Gain clip range: a Lambertian gain is non-negative, and above 4x the
#: correspondence is junk, not lighting.
_GAIN_LO = 0.0
_GAIN_HI = 4.0

#: Fewer weighted samples than this give the unit gain.
_MIN_SAMPLES = 64.0


def sh_basis(nx: torch.Tensor, ny: torch.Tensor, nz: torch.Tensor):
    """The 9 order-2 real SH basis values of a unit normal, planar, in the
    unnormalized monomial form
    ``[1, ny, nz, nx, nx*ny, ny*nz, 3nz^2-1, nx*nz, nx^2-ny^2]``."""
    return (
        torch.ones_like(nx),
        ny, nz, nx,
        nx * ny, ny * nz,
        3.0 * nz * nz - 1.0,
        nx * nz,
        nx * nx - ny * ny,
    )


def unit_coeffs(device=None) -> torch.Tensor:
    """Coefficients of the identity gain field (gain(n) == 1)."""
    e0 = torch.zeros(9, device=device)
    e0[:1].fill_(1.0)   # a fill on the device: no host value to copy in a capture
    return e0


_MMAP, _YMAP = _sum_positions(9)


def estimate_gain(
    n_m: torch.Tensor,
    model_i: torch.Tensor,
    live_i: torch.Tensor,
    weight: torch.Tensor,
    ridge: float = 3e-2,
    reduce: Reducer = LOCAL,
) -> torch.Tensor:
    """Weighted linear least squares for the 9 SH gain coefficients:
    minimizes ``sum w (model_i * b(n_m).ell - live_i)^2 + lam |ell - e0|^2``
    with ``lam = ridge * tr(M) / 9``.  Planar (H, W) inputs, ``n_m``
    (H, W, 3); returns (9,) float32.  ``reduce`` adds the sums of the
    rows other processes hold (``icp.Reducer``).  A failed factorization,
    a non-finite solution or fewer than 64 samples give the unit gain."""
    b = sh_basis(n_m[..., 0], n_m[..., 1], n_m[..., 2])
    a = [model_i * bk for bk in b]
    w = weight.to(torch.float32)
    parts = []
    for j in range(9):
        wa = w * a[j]
        for k in range(j, 9):
            parts.append(wa * a[k])
        parts.append(wa * live_i)
    parts.append(w)
    sums = reduce(torch.sum(torch.stack(parts).reshape(len(parts), -1), dim=1))
    # Assembled from views of the sums (no host-built index tensor).
    M = torch.stack([sums[i] for i in _MMAP]).reshape(9, 9)
    y = torch.stack([sums[i] for i in _YMAP])
    cnt = sums[-1]

    dev = sums.device
    e0 = unit_coeffs(dev)
    lam = ridge * (torch.trace(M) / 9.0) + 1e-12
    L, info = torch.linalg.cholesky_ex(M + lam * torch.eye(9, device=dev))
    ell = torch.cholesky_solve((y + lam * e0)[:, None], L)[:, 0]
    good = torch.all(torch.isfinite(ell)) & (info == 0) & (cnt >= _MIN_SAMPLES)
    return torch.where(good, ell, e0)


def gain(n_m: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Planar gain field ``clip(b(n_m).ell)`` for (H, W, 3) normals."""
    b = sh_basis(n_m[..., 0], n_m[..., 1], n_m[..., 2])
    g = sum(coeffs[k] * bk for k, bk in enumerate(b))
    return torch.clamp(g, _GAIN_LO, _GAIN_HI)


def scale_photo_samples(samples, n_m: torch.Tensor, coeffs: torch.Tensor):
    """Scale the fixed photometric samples ``(i_m0, gu, gv, u0, v0, ok)``
    by the per-correspondence gain (the gain's own image gradient is
    dropped: it varies on the scale of surface curvature)."""
    i_m0, gu, gv, u0, v0, ok = samples
    g = gain(n_m, coeffs)
    return (g * i_m0, g * gu, g * gv, u0, v0, ok)


@dataclasses.dataclass(frozen=True)
class Light:
    """The illumination model as an object: 9 SH gain coefficients with
    estimate and shade entry points (the reference's ``Light``)."""

    coeffs: torch.Tensor  # (9,) float32

    @classmethod
    def identity(cls, device=None) -> "Light":
        return cls(coeffs=unit_coeffs(device))

    @classmethod
    def estimate(
        cls,
        normals: torch.Tensor,
        model_intensity: torch.Tensor,
        live_intensity: torch.Tensor,
        valid: torch.Tensor,
        ridge: float = 3e-2,
    ) -> "Light":
        """Fit the gain field mapping model to live intensity: ``normals``
        (H, W, 3) world-space unit normals, intensities (H, W), ``valid``
        (H, W) bool."""
        return cls(
            coeffs=estimate_gain(
                normals, model_intensity, live_intensity, valid, ridge
            )
        )

    def shade(self, normals: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
        """Predicted intensity ``albedo * gain(normals)``."""
        return albedo * gain(normals, self.coeffs)
