"""Pose-graph (essential graph) optimisation over Sim3 / SE3-4DoF.

Counterpart of ``optim/pose_graph.py`` of the JAX package (reference:
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:4509, its merge variant
at 5667, and OptimizeEssentialGraph4DoF at 4852): after a loop is detected,
keyframe similarities are relaxed over the graph of spanning-tree + loop +
strong-covisibility edges, by damped Gauss-Newton with accept / reject.

The edge residuals and their Jacobians are batched over the edges (the
Jacobians as forward-mode derivatives, one per tangent direction); the
[DK, DK] system is solved with an equilibrated dense Cholesky.

Where this differs from the JAX code: the normal equations are summed and
solved in float64 (the scatter-add on the card sums in an arbitrary order;
in float64 that order no longer shows in the float32 step), while the
residuals, the poses and the costs stay float32 as in JAX; every iteration
runs with the accept test freezing a rejected step on the device, so a
solve makes no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..lie import SE3, Sim3, se3, sim3, so3


class PoseGraphResult(NamedTuple):
    R: torch.Tensor    # [K, 3, 3]
    t: torch.Tensor    # [K, 3]
    s: torch.Tensor    # [K]
    cost: torch.Tensor


def _solve_damped(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """Levenberg damping, Jacobi equilibration and a Cholesky solve of
    H x = g (NaN where the factorisation fails)."""
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H)
    Hd = H + lam * torch.diag(torch.clamp(diag, min=1e-6))
    E = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-10))
    Hs = Hd * E[:, None] * E[None, :]
    L, info = torch.linalg.cholesky_ex(Hs + 1e-6 * eye)
    y = torch.cholesky_solve((g * E)[:, None], L)[:, 0]
    y = torch.where(info == 0, y, torch.full_like(y, float("nan")))
    return y * E


def _jacobians(res, z: torch.Tensor):
    """(r [E, R], Ji [E, R, D], Jj [E, R, D]) of res(pi, pj) at pi = pj = z
    [E, D]: edge e depends only on row e, so one forward derivative per
    tangent direction (a dual-number pass, ``torch.autograd.forward_ad``)
    gives every edge's column at once."""
    D = z.shape[-1]
    r = res(z, z)
    Ji, Jj = [], []
    for k in range(D):
        e = torch.zeros_like(z)
        e[:, k] = 1.0
        with fwAD.dual_level():
            Ji.append(fwAD.unpack_dual(res(fwAD.make_dual(z, e), z)).tangent)
        with fwAD.dual_level():
            Jj.append(fwAD.unpack_dual(res(z, fwAD.make_dual(z, e))).tangent)
    return r, torch.stack(Ji, -1), torch.stack(Jj, -1)


def _normal_equations(r, Ji, Jj, w, ei, ej, fixed, K: int, D: int,
                      fixed_dofs=()):
    """H [DK, DK] and g [DK] in float64, fixed states (and fixed degrees of
    freedom) as identity rows with a zero right-hand side."""
    r, Ji, Jj, w = r.double(), Ji.double(), Jj.double(), w.double()
    JiW = Ji * w[:, None, None]
    JjW = Jj * w[:, None, None]
    blocks = torch.cat([
        torch.einsum("eki,ekj->eij", JiW, Ji),
        torch.einsum("eki,ekj->eij", JjW, Jj),
        torch.einsum("eki,ekj->eij", JiW, Jj),
        torch.einsum("eki,ekj->eij", JjW, Ji)])
    pairs = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    Hb = torch.zeros((K * K, D, D), dtype=torch.float64, device=r.device)
    Hb.index_add_(0, pairs, blocks)
    H = Hb.reshape(K, K, D, D).permute(0, 2, 1, 3)
    g = torch.zeros((K, D), dtype=torch.float64, device=r.device)
    g.index_add_(0, torch.cat([ei, ej]),
                 -torch.cat([torch.einsum("eki,ek->ei", JiW, r),
                             torch.einsum("eki,ek->ei", JjW, r)]))
    fm = (~fixed).double()
    eye = torch.eye(D, dtype=torch.float64, device=r.device)
    H = H * fm[:, None, None, None] * fm[None, None, :, None]
    ar = torch.arange(K, device=r.device)
    H = H.clone()
    H[ar, :, ar, :] += eye * fixed.double()[:, None, None]
    g = g * fm[:, None]
    if fixed_dofs:
        dofm = torch.ones(D, dtype=torch.float64, device=r.device)
        dofm[list(fixed_dofs)] = 0.0
        H = H * dofm[None, :, None, None] * dofm[None, None, None, :]
        for d in fixed_dofs:
            H[ar, d, ar, d] += 1.0
        g = g * dofm[None, :]
    return H.reshape(K * D, K * D), g.reshape(-1)


def _lm(state, residual, retract, w, ei, ej, fixed, D: int, iters: int,
        fixed_dofs=()):
    """Damped GN over the edge residuals residual(state, pi, pj) with
    accept / reject on the weighted cost; retract(state, dx [K, D])."""
    K = fixed.shape[0]
    dev = fixed.device
    z = torch.zeros((ei.shape[0], D), dtype=torch.float32, device=dev)

    def cost_of(st):
        r = residual(st, z, z)
        return torch.sum(w * torch.sum(r * r, -1))

    cost = cost_of(state)
    lam = torch.full((), 1e-6, dtype=torch.float32, device=dev)
    fm = (~fixed).to(torch.float32)
    for _ in range(iters):
        r, Ji, Jj = _jacobians(lambda pi, pj: residual(state, pi, pj), z)
        H, g = _normal_equations(r, Ji, Jj, w, ei, ej, fixed, K, D,
                                 fixed_dofs)
        dx = _solve_damped(H, g, lam.double()).to(torch.float32)
        dx = dx.reshape(K, D) * fm[:, None]
        cand = retract(state, dx)
        new_cost = cost_of(cand)
        acc = (new_cost < cost) & torch.isfinite(new_cost)
        state = tuple(torch.where(acc, c, s) for c, s in zip(cand, state))
        lam = torch.where(acc, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e3))
        cost = torch.where(acc, new_cost, cost)
    return state, cost


def optimize_sim3_graph(R0, t0, s0, edge_i, edge_j, edge_R, edge_t, edge_s,
                        edge_w, fixed, iters: int = 12,
                        fix_scale: bool = False) -> PoseGraphResult:
    """States S_k = (R0[k], t0[k], s0[k]) world -> keyframe similarities;
    edges carry the measured relative similarity m_ij = S_i S_j^-1 with
    weight edge_w; fixed [K] holds keyframes constant; fix_scale holds
    every s_k (the SE3 essential graph of metric maps)."""
    ei, ej = edge_i.long(), edge_j.long()
    m_inv = Sim3(edge_R, edge_t, edge_s).inverse()

    def residual(st, pi, pj):
        R, t, s = st
        Si = sim3.exp(pi).compose(Sim3(R[ei], t[ei], s[ei]))
        Sj = sim3.exp(pj).compose(Sim3(R[ej], t[ej], s[ej]))
        return sim3.log(m_inv.compose(Si).compose(Sj.inverse()))

    def retract(st, dx):
        R, t, s = st
        dS = sim3.exp(dx)
        return (dS.R @ R,
                dS.s[:, None] * torch.einsum("kij,kj->ki", dS.R, t) + dS.t,
                dS.s * s)

    (R, t, s), cost = _lm((R0, t0, s0), residual, retract, edge_w, ei, ej,
                          fixed, 7, iters, (6,) if fix_scale else ())
    return PoseGraphResult(so3.normalize(R), t, s, cost)


def optimize_4dof_graph(R0, t0, edge_i, edge_j, edge_R, edge_t, edge_w,
                        fixed, iters: int = 12) -> PoseGraphResult:
    """Yaw + translation pose graph for gravity-aligned maps (reference:
    OptimizeEssentialGraph4DoF): the perturbation [dyaw, dt(3)] acts in
    the world frame, x_k = R (Rz x_w + dt) + t."""
    ei, ej = edge_i.long(), edge_j.long()
    m_inv = SE3(edge_R, edge_t).inverse()
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=R0.dtype, device=R0.device)

    def pert(R, t, p):
        return (R @ so3.exp(ez * p[..., :1]),
                t + torch.einsum("...ij,...j->...i", R, p[..., 1:4]))

    def residual(st, pi, pj):
        R, t = st
        Ti = SE3(*pert(R[ei], t[ei], pi))
        Tj = SE3(*pert(R[ej], t[ej], pj))
        return se3.log(m_inv.compose(Ti).compose(Tj.inverse()))

    (R, t), cost = _lm((R0, t0), residual, lambda st, dx: pert(*st, dx),
                       edge_w, ei, ej, fixed, 4, iters)
    K = R0.shape[0]
    return PoseGraphResult(so3.normalize(R), t,
                           torch.ones(K, dtype=R0.dtype, device=R0.device),
                           cost)
