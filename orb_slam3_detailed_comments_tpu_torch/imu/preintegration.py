"""IMU preintegration on manifold (Forster et al.).

Counterpart of ``imu/preintegration.py`` of the JAX package (reference:
IMU::Preintegrated, src/ImuTypes.cc:247 IntegrateNewMeasurement,
include/ImuTypes.h:210-266): delta rotation / velocity / position between
frames, the 15x15 noise covariance, and the five bias Jacobians (JRg, JVg,
JVa, JPg, JPa) that correct for a bias change to first order without
re-integrating.

Covariance order: [phi (3), v (3), p (3), bg (3), ba (3)]. Every function
takes tensors on any device and broadcasts over leading dimensions, so a
stack of windows ([E] leading) runs as one batch. ``integrate`` is the JAX
package's ``lax.scan`` as a loop over the window's real samples: a padded
sample of the JAX scan leaves the state as it was, so skipping it gives the
same result.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..lie import so3


class ImuCalib(NamedTuple):
    """Noise densities (per sqrt(s)) and the body <- camera extrinsic as
    host arrays (reference: IMU::Calib, include/ImuTypes.h:92-126)."""
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    R_bc: np.ndarray = None   # body <- camera rotation
    t_bc: np.ndarray = None

    @staticmethod
    def default() -> "ImuCalib":
        return ImuCalib(R_bc=np.eye(3, dtype=np.float32),
                        t_bc=np.zeros(3, np.float32))


class Preintegrated(NamedTuple):
    dT: torch.Tensor      # [...] total time
    dR: torch.Tensor      # [..., 3, 3]
    dV: torch.Tensor      # [..., 3]
    dP: torch.Tensor      # [..., 3]
    C: torch.Tensor       # [..., 15, 15] covariance
    JRg: torch.Tensor     # [..., 3, 3] d dR / d bg
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg0: torch.Tensor     # [..., 3] gyro bias the window was integrated at
    ba0: torch.Tensor     # [..., 3] accelerometer bias


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def init(bg0: torch.Tensor, ba0: torch.Tensor) -> Preintegrated:
    """An empty window at biases (bg0, ba0) [3]."""
    z3 = torch.zeros_like(bg0)
    z33 = torch.zeros((3, 3), dtype=bg0.dtype, device=bg0.device)
    return Preintegrated(
        dT=torch.zeros((), dtype=bg0.dtype, device=bg0.device),
        dR=torch.eye(3, dtype=bg0.dtype, device=bg0.device), dV=z3, dP=z3,
        C=torch.zeros((15, 15), dtype=bg0.dtype, device=bg0.device),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33, bg0=bg0, ba0=ba0)


def _noise(calib: ImuCalib, device):
    """The continuous noise diagonals (gyro / acc white noise, then the two
    random walks) as float32 [6] tensors on the device, uploaded once."""
    return _noise_on(float(calib.noise_gyro), float(calib.noise_acc),
                     float(calib.walk_gyro), float(calib.walk_acc),
                     torch.device(device))


@functools.lru_cache(maxsize=None)
def _noise_on(ng, na, wg, wa, device):
    n = np.array([[ng ** 2] * 3 + [na ** 2] * 3,
                  [wg ** 2] * 3 + [wa ** 2] * 3], np.float32)
    d = torch.from_numpy(n).to(device)
    return d[0], d[1]


def integrate_step(s: Preintegrated, acc, gyro, dt, noise) -> Preintegrated:
    """One measurement (acc [3], gyro [3], dt []) — the reference's
    IntegrateNewMeasurement (ImuTypes.cc:247-330). noise: ``_noise``."""
    ng, nw = noise
    a = acc - s.ba0
    w = gyro - s.bg0
    dt2 = dt * dt
    a_hat = so3.hat(a)
    Ra = _mv(s.dR, a)
    # position / velocity with the old rotation (the reference's order)
    dP = s.dP + s.dV * dt + 0.5 * Ra * dt2
    dV = s.dV + Ra * dt
    dRi = so3.exp(w * dt)
    Jr = so3.right_jacobian(w * dt)

    I3 = torch.eye(3, dtype=acc.dtype, device=acc.device)
    Z3 = torch.zeros_like(I3)
    RA = s.dR @ a_hat
    A = torch.cat([
        torch.cat([dRi.T, Z3, Z3], 1),
        torch.cat([-RA * dt, I3, Z3], 1),
        torch.cat([-0.5 * RA * dt2, I3 * dt, I3], 1)], 0)
    B = torch.cat([
        torch.cat([Jr * dt, Z3], 1),
        torch.cat([Z3, s.dR * dt], 1),
        torch.cat([Z3, 0.5 * s.dR * dt2], 1)], 0)
    Cnav = A @ s.C[0:9, 0:9] @ A.T + B @ torch.diag(ng / dt) @ B.T
    C = torch.cat([
        torch.cat([Cnav, s.C[0:9, 9:15]], 1),
        torch.cat([s.C[9:15, 0:9],
                   s.C[9:15, 9:15] + torch.diag(nw * dt)], 1)], 0)

    # bias Jacobians (reference: ImuTypes.cc:310-325)
    JPa = s.JPa + s.JVa * dt - 0.5 * s.dR * dt2
    JPg = s.JPg + s.JVg * dt - 0.5 * RA @ s.JRg * dt2
    JVa = s.JVa - s.dR * dt
    JVg = s.JVg - RA @ s.JRg * dt
    JRg = dRi.T @ s.JRg - Jr * dt
    dR = so3.normalize(s.dR @ dRi)
    return Preintegrated(s.dT + dt, dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa,
                         s.bg0, s.ba0)


def integrate(accs: torch.Tensor, gyros: torch.Tensor, dts: torch.Tensor,
              calib: ImuCalib, bg0: torch.Tensor = None,
              ba0: torch.Tensor = None) -> Preintegrated:
    """Integrate a window [M, 3] x [M, 3] x [M] of real samples, on the
    samples' device (the JAX function's valid mask: pass only the valid
    rows)."""
    dev, dt_ = accs.device, accs.dtype
    z3 = torch.zeros(3, dtype=dt_, device=dev)
    s = init(z3 if bg0 is None else bg0, z3 if ba0 is None else ba0)
    noise = tuple(x.to(dt_) for x in _noise(calib, dev))
    for i in range(accs.shape[0]):
        s = integrate_step(s, accs[i], gyros[i], dts[i], noise)
    return s


# --- bias-corrected getters (reference: ImuTypes.cc GetDeltaRotation etc.) --

def delta_rotation(pre: Preintegrated, bg) -> torch.Tensor:
    return pre.dR @ so3.exp(_mv(pre.JRg, bg - pre.bg0))


def delta_velocity(pre: Preintegrated, bg, ba) -> torch.Tensor:
    return pre.dV + _mv(pre.JVg, bg - pre.bg0) + _mv(pre.JVa, ba - pre.ba0)


def delta_position(pre: Preintegrated, bg, ba) -> torch.Tensor:
    return pre.dP + _mv(pre.JPg, bg - pre.bg0) + _mv(pre.JPa, ba - pre.ba0)


def merge(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """a then b, at a's bias (reference: Preintegrated::MergePrevious,
    ImuTypes.cc:330): first order in b's bias change; the covariances add
    (the JAX package's conservative combination)."""
    dRb = delta_rotation(b, a.bg0)
    dVb = delta_velocity(b, a.bg0, a.ba0)
    dPb = delta_position(b, a.bg0, a.ba0)
    bdT = b.dT[..., None, None]
    dR = so3.normalize(a.dR @ dRb)
    dV = a.dV + _mv(a.dR, dVb)
    dP = a.dP + a.dV * b.dT[..., None] + _mv(a.dR, dPb)
    JRg = dRb.transpose(-1, -2) @ a.JRg + b.JRg
    JVg = a.JVg + a.dR @ b.JVg - a.dR @ so3.hat(dVb) @ a.JRg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = (a.JPg + a.JVg * bdT + a.dR @ b.JPg
           - a.dR @ so3.hat(dPb) @ a.JRg)
    JPa = a.JPa + a.JVa * bdT + a.dR @ b.JPa
    return Preintegrated(a.dT + b.dT, dR, dV, dP, a.C + b.C, JRg, JVg, JVa,
                         JPg, JPa, a.bg0, a.ba0)


def predict_state(R_wb, v_w, p_w, pre: Preintegrated, bg, ba, g):
    """Dead-reckon the next body state (reference: Tracking::PredictStateIMU,
    Tracking.cc:1892). g [3]: world gravity."""
    dt = pre.dT[..., None]
    dR = delta_rotation(pre, bg)
    dV = delta_velocity(pre, bg, ba)
    dP = delta_position(pre, bg, ba)
    R2 = so3.normalize(R_wb @ dR)
    v2 = v_w + g * dt + _mv(R_wb, dV)
    p2 = p_w + v_w * dt + 0.5 * g * dt * dt + _mv(R_wb, dP)
    return R2, v2, p2


def stack(pres) -> Preintegrated:
    """A list of windows as one batched Preintegrated ([E] leading)."""
    return Preintegrated(*[torch.stack(xs) for xs in zip(*pres)])


def index(pre: Preintegrated, i) -> Preintegrated:
    return Preintegrated(*[x[i] for x in pre])
