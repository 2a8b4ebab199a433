"""Sim(3): similarity transforms (scale * rotation + translation).

Counterpart of ``lie/sim3.py`` of the JAX package (reference: Sophus Sim3
and the g2o Sim3 type used by loop closing and map merging). Tangent
ordering: (rho, phi, sigma): translation, rotation, log-scale.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3

_EPS = 1e-6


def _matvec(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, x)


class Sim3(NamedTuple):
    """x_out = s * R @ x + t."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    s: torch.Tensor  # [...]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "Sim3":
        return Sim3(
            torch.eye(3, dtype=dtype, device=device).expand(
                *batch_shape, 3, 3).clone(),
            torch.zeros(*batch_shape, 3, dtype=dtype, device=device),
            torch.ones(batch_shape, dtype=dtype, device=device))

    @staticmethod
    def from_se3(R: torch.Tensor, t: torch.Tensor, s=None) -> "Sim3":
        if s is None:
            s = torch.ones(t.shape[:-1], dtype=t.dtype, device=t.device)
        return Sim3(R, t, s)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * _matvec(self.R, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.R @ other.R,
                    self.s[..., None] * _matvec(self.R, other.t) + self.t,
                    self.s * other.s)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        inv_s = 1.0 / self.s
        return Sim3(Rt, -inv_s[..., None] * _matvec(Rt, self.t), inv_s)


def _wv_coeffs(phi: torch.Tensor, sigma: torch.Tensor):
    """Coefficients (A, B, C) of W = C I + A hat(phi) + B hat(phi)^2 with
    t = W rho in the sim3 exp (Sophus sim3.hpp calcW), with the same
    small-angle and small-scale branches as the JAX version."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    s = torch.exp(sigma)
    small_sig = torch.abs(sigma) < _EPS
    small_th = theta < _EPS
    one = torch.ones_like(sigma)
    safe_sig = torch.where(small_sig, one, sigma)
    safe_th = torch.where(small_th, one, theta)

    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / safe_sig)
    sin_t, cos_t = torch.sin(safe_th), torch.cos(safe_th)
    sig2 = safe_sig * safe_sig
    th2 = safe_th * safe_th
    denom = sig2 + th2

    a_g = s * sin_t
    b_g = s * cos_t
    A_gen = (a_g * safe_sig + (1.0 - b_g) * safe_th) / (safe_th * denom)
    B_gen = (C - ((b_g - 1.0) * safe_sig + a_g * safe_th) / denom) / th2
    A_s0 = (1.0 - cos_t) / th2
    B_s0 = (safe_th - sin_t) / (th2 * safe_th)
    A_t0 = ((safe_sig - 1.0) * s + 1.0) / sig2
    B_t0 = (s * 0.5 * sig2 + s - 1.0 - safe_sig * s) / (sig2 * safe_sig)
    A_00 = 0.5 + sigma / 6.0
    B_00 = 1.0 / 6.0 + sigma / 24.0

    both = small_sig & small_th
    A = torch.where(both, A_00, torch.where(
        small_sig, A_s0, torch.where(small_th, A_t0, A_gen)))
    B = torch.where(both, B_00, torch.where(
        small_sig, B_s0, torch.where(small_th, B_t0, B_gen)))
    return A, B, C


def _calc_w(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    A, B, C = _wv_coeffs(phi, sigma)
    W = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return (C[..., None, None] * eye + A[..., None, None] * W
            + B[..., None, None] * (W @ W))


def exp(xi: torch.Tensor) -> Sim3:
    """sim(3) exp: [..., 7] = (rho, phi, sigma) -> Sim3."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    return Sim3(so3.exp(phi), _matvec(_calc_w(phi, sigma), rho),
                torch.exp(sigma))


def log(S: Sim3) -> torch.Tensor:
    """Sim3 -> [..., 7] = (rho, phi, sigma)."""
    phi = so3.log(S.R)
    sigma = torch.log(S.s)
    rho = torch.linalg.solve(_calc_w(phi, sigma), S.t[..., :, None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
