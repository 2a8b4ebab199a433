"""SE(3): rigid transforms, batched over leading dims.

Counterpart of ``lie/se3.py`` of the JAX package (reference: Sophus SE3).
Twists are ordered (rho, phi): translation first, rotation second.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


def _matvec(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, x)


class SE3(NamedTuple):
    """Rigid transform: x_out = R @ x + t."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            *batch_shape, 3, 3).clone()
        return SE3(R, torch.zeros(*batch_shape, 3, dtype=dtype, device=device))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points x [..., 3]."""
        return _matvec(self.R, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other (apply other first)."""
        return SE3(self.R @ other.R, _matvec(self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_matvec(Rt, self.t))

    def normalized(self) -> "SE3":
        return SE3(so3.normalize(self.R), self.t)


def exp(xi: torch.Tensor) -> SE3:
    """se(3) exp: twist [..., 6] = (rho, phi) -> SE3 (t = Jl(phi) rho)."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    return SE3(so3.exp(phi), _matvec(so3.left_jacobian(phi), rho))


def log(T: SE3) -> torch.Tensor:
    """SE3 -> twist [..., 6] = (rho, phi)."""
    phi = so3.log(T.R)
    rho = _matvec(so3.inv_left_jacobian(phi), T.t)
    return torch.cat([rho, phi], dim=-1)


def adjoint(T: SE3) -> torch.Tensor:
    """Adjoint [..., 6, 6] for the (rho, phi) ordering:
    Ad = [[R, hat(t) R], [0, R]]."""
    top = torch.cat([T.R, so3.hat(T.t) @ T.R], dim=-1)
    bot = torch.cat([torch.zeros_like(T.R), T.R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def boxplus(T: SE3, xi: torch.Tensor) -> SE3:
    """Left-multiplicative update exp(xi) ∘ T (the GN/LM retraction)."""
    return exp(xi).compose(T)


def relative(T_a: SE3, T_b: SE3) -> SE3:
    """T_a^-1 ∘ T_b."""
    return T_a.inverse().compose(T_b)
