"""SE(3) rigid transforms on torch tensors.

Counterpart of ``vulcan_tpu/core/se3.py``.  Conventions are the same:

  * ``SE3`` maps points from its source frame to its target frame:
    ``x_target = R @ x_source + t``.
  * Camera poses are camera-to-world; ``pose.inverse()`` is world-to-camera.
  * ``SE3.exp(xi)`` takes the twist ``xi = (omega, v)``, rotation first.

The reference runs every product here at ``Precision.HIGHEST``.  The port
keeps full float32 by turning TF32 off for matmuls and convolutions when
the package is imported (``vulcan_tpu_torch/__init__.py``).
"""
from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-8
# Small-angle series threshold on theta^2: the closed forms cancel
# catastrophically in f32 below it (cos(1e-4) rounds to 1.0f and log()
# returns NaN), while the 2nd-order series is already exact to f32 there.
_SERIES_T2 = 1e-4


def skew(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    use_series = theta2 < _SERIES_T2
    a = torch.where(use_series, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2
    )
    K = skew(omega)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle. Accurate away from pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    theta2 = theta * theta
    use_series = theta2 < _SERIES_T2
    sin_theta = torch.sin(theta)
    one = torch.ones_like(theta)
    scale = torch.where(
        use_series,
        0.5 + theta2 / 12.0,
        theta / torch.where(use_series, one, 2.0 * sin_theta + _EPS),
    )
    return scale[..., None] * w


@dataclasses.dataclass(frozen=True)
class SE3:
    """Rigid transform: rotation (...,3,3) + translation (...,3)."""

    rotation: torch.Tensor
    translation: torch.Tensor

    @staticmethod
    def identity(device=None, dtype=torch.float32) -> "SE3":
        return SE3(
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device),
        )

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        """(...,4,4) or (...,3,4) homogeneous matrix -> SE3."""
        return SE3(T[..., :3, :3], T[..., :3, 3])

    def as_matrix(self) -> torch.Tensor:
        """-> (...,4,4) homogeneous matrix."""
        batch = self.translation.shape[:-1]
        bottom = torch.tensor(
            [0.0, 0.0, 0.0, 1.0], dtype=self.translation.dtype,
            device=self.translation.device,
        ).expand(*batch, 1, 4)
        top = torch.cat([self.rotation, self.translation[..., :, None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def to(self, device) -> "SE3":
        return SE3(self.rotation.to(device), self.translation.to(device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points (...,3)."""
        return self.rotate(points) + self.translation

    def rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        """Rotate direction vectors (...,3) (no translation)."""
        return torch.einsum("...ij,...j->...i", self.rotation, vectors)

    def compose(self, other: "SE3") -> "SE3":
        """self o other: first apply ``other``, then ``self``."""
        return SE3(
            self.rotation @ other.rotation,
            self.rotate(other.translation) + self.translation,
        )

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        Rt = self.rotation.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.translation))

    @staticmethod
    def exp(xi: torch.Tensor) -> "SE3":
        """se(3) exponential. ``xi=(...,6)`` = (omega, v), rotation first."""
        omega, v = xi[..., :3], xi[..., 3:]
        theta2 = torch.sum(omega * omega, dim=-1)
        theta = torch.sqrt(theta2 + _EPS * _EPS)
        use_series = theta2 < _SERIES_T2
        R = so3_exp(omega)
        # Left Jacobian V: t = V @ v.
        b = torch.where(
            use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2
        )
        c = torch.where(
            use_series,
            1.0 / 6.0 - theta2 / 120.0,
            (theta - torch.sin(theta)) / (theta2 * theta),
        )
        K = skew(omega)
        V = _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)
        return SE3(R, torch.einsum("...ij,...j->...i", V, v))

    def log(self) -> torch.Tensor:
        """-> twist (...,6) = (omega, v) with SE3.exp(log(T)) == T."""
        omega = so3_log(self.rotation)
        theta2 = torch.sum(omega * omega, dim=-1)
        theta = torch.sqrt(theta2 + _EPS * _EPS)
        use_series = theta2 < _SERIES_T2
        K = skew(omega)
        # V^-1 = I - K/2 + (1/theta^2)(1 - a/(2b)) K^2
        a = torch.where(use_series, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
        b = torch.where(
            use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2
        )
        one = torch.ones_like(theta2)
        coef = torch.where(
            use_series,
            1.0 / 12.0 + theta2 / 720.0,
            (1.0 - a / (2.0 * b)) / torch.where(use_series, one, theta2),
        )
        Vinv = _eye_like(K) - 0.5 * K + coef[..., None, None] * (K @ K)
        v = torch.einsum("...ij,...j->...i", Vinv, self.translation)
        return torch.cat([omega, v], dim=-1)


def where(cond: torch.Tensor, a: SE3, b: SE3) -> SE3:
    """Select ``a`` where the scalar ``cond`` holds, else ``b`` (on device,
    no host read)."""
    return SE3(
        torch.where(cond, a.rotation, b.rotation),
        torch.where(cond, a.translation, b.translation),
    )
