"""Inertial residuals between consecutive states, and their Jacobians.

Counterpart of ``imu/factors.py`` of the JAX package (reference:
src/G2oTypes.cc EdgeInertial:576, EdgeGyroRW / EdgeAccRW :736 / :778).
States are world-frame body poses (R_wb, p_w), velocities v_w and biases;
every function broadcasts over leading dimensions.

``inertial_jacobians`` writes out the derivatives of the 9-dof residual
(reference: EdgeInertial::linearizeOplus) where the JAX package takes
``jax.jacfwd``: the same derivatives, each block a closed form (the log's
inverse right Jacobian, the bias Jacobians of the window), at a few dozen
small tensor operations where a forward-mode pass of the residual takes
hundreds.
"""
from __future__ import annotations

import torch

from ..lie import so3
from . import preintegration as pre_mod
from .preintegration import Preintegrated


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def inertial_residual(R_i, p_i, v_i, R_j, p_j, v_j, bg, ba,
                      pre: Preintegrated, g) -> torch.Tensor:
    """[..., 9] = [er, ev, ep] (reference: EdgeInertial::computeError);
    g [3] world gravity."""
    dt = pre.dT[..., None]
    dR = pre_mod.delta_rotation(pre, bg)
    dV = pre_mod.delta_velocity(pre, bg, ba)
    dP = pre_mod.delta_position(pre, bg, ba)
    R_iT = R_i.transpose(-1, -2)
    er = so3.log(dR.transpose(-1, -2) @ R_iT @ R_j)
    ev = _mv(R_iT, v_j - v_i - g * dt) - dV
    ep = _mv(R_iT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)


def information_9(pre: Preintegrated) -> torch.Tensor:
    """Information of the 9-dof residual: the inverse of the nav-state
    covariance block, symmetrised (reference: the EdgeInertial ctor)."""
    C = pre.C[..., 0:9, 0:9]
    eye = torch.eye(9, dtype=C.dtype, device=C.device)
    C = 0.5 * (C + C.transpose(-1, -2)) + 1e-10 * eye
    info = torch.linalg.inv(C)
    return 0.5 * (info + info.transpose(-1, -2))


def bias_walk_residual(bg_i, ba_i, bg_j, ba_j) -> torch.Tensor:
    """Random-walk residual between consecutive biases (reference:
    EdgeGyroRW / EdgeAccRW)."""
    return torch.cat([bg_j - bg_i, ba_j - ba_i], dim=-1)


def bias_walk_information(pre: Preintegrated) -> torch.Tensor:
    Cw = pre.C[..., 9:15, 9:15]
    Cw = Cw + 1e-12 * torch.eye(6, dtype=Cw.dtype, device=Cw.device)
    info = torch.linalg.inv(Cw)
    return 0.5 * (info + info.transpose(-1, -2))


def inertial_jacobians(R_i, p_i, v_i, R_j, p_j, v_j, bg, ba,
                       pre: Preintegrated, g):
    """(r [..., 9], J_i [..., 9, 9], J_j [..., 9, 9], J_bg [..., 9, 3],
    J_ba [..., 9, 3]) of ``inertial_residual``: J_i and J_j over each
    state's (dphi, dp, dv) for R <- R Exp(dphi), p <- p + dp (world),
    v <- v + dv; J_bg, J_ba over the window's biases (bg <- bg + dbg)."""
    dt = pre.dT[..., None]
    db = bg - pre.bg0
    u = _mv(pre.JRg, db)
    dR = pre.dR @ so3.exp(u)
    dV = pre_mod.delta_velocity(pre, bg, ba)
    dP = pre_mod.delta_position(pre, bg, ba)
    R_iT = R_i.transpose(-1, -2)
    E = dR.transpose(-1, -2) @ R_iT @ R_j
    er = so3.log(E)
    a_v = _mv(R_iT, v_j - v_i - g * dt)
    a_p = _mv(R_iT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt)
    r = torch.cat([er, a_v - dV, a_p - dP], dim=-1)
    Jinv = so3.inv_right_jacobian(er)
    z = torch.zeros_like(R_iT)
    dtm = dt[..., None]
    # rows (er, ev, ep); columns (dphi, dp, dv)
    J_i = torch.cat([
        torch.cat([-Jinv @ R_j.transpose(-1, -2) @ R_i, z, z], -1),
        torch.cat([so3.hat(a_v), z, -R_iT], -1),
        torch.cat([so3.hat(a_p), -R_iT, -R_iT * dtm], -1)], -2)
    J_j = torch.cat([
        torch.cat([Jinv, z, z], -1),
        torch.cat([z, z, R_iT], -1),
        torch.cat([z, R_iT, z], -1)], -2)
    J_bg = torch.cat([-Jinv @ E.transpose(-1, -2) @ so3.right_jacobian(u)
                      @ pre.JRg, -pre.JVg, -pre.JPg], -2)
    J_ba = torch.cat([z, -pre.JVa, -pre.JPa], -2)
    return r, J_i, J_j, J_bg, J_ba
