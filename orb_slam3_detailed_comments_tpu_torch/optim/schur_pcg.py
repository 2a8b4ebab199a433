"""Atlas-scale global bundle adjustment: matrix-free Schur-complement PCG.

Counterpart of ``optim/schur_pcg.py`` of the JAX package (reference: the
sparse BlockSolver of Optimizer::GlobalBundleAdjustemnt, src/Optimizer.cc:
2813). Each LM iteration runs preconditioned conjugate gradients on the
reduced camera system S dc = rhs, S = U_d - W V_d^-1 W^T, without forming
W or S: every S-matvec is two gathers and two segment sums over the
observations. The preconditioner is the exact block diagonal of S. The LM
loop (damping, accept / reject, the two-phase outlier gate, the final chi2
inlier mask) is ``ba.ba_solve``'s, so the tiers are interchangeable;
``ba.ba_solve`` routes here above ``ba._PCG_C_MIN`` cameras.

Where this differs from the JAX code: the segment sums accumulate in
float64 (``ba.segment_sum``); the CG loop and the LM loop run their full
counts with a sticky stop flag on the device (the JAX ``while_loop``s stop
early), so a solve makes no host sync.

With a process group (``group``, the JAX code's mesh ``axis``) the
observations are this rank's block while poses, points and masks are
whole on every rank: the float64 partials of each segment sum and the
robust cost are summed over the group before the rounding, at the JAX
code's ``_psum`` sites, so every rank walks the same LM and CG steps
(``parallel/dist_ba.make_dist_gba_pcg``). Each reduction then waits on
the host, so the CG and LM loops are left at their stop flags (every rank
reads the same flag), with the results of the full counts.
"""
from __future__ import annotations

import torch

from .. import comm
from ..lie import SE3, se3
from ..models import cameras
from . import reproj
from .ba import (BAProblem, BAResult, _coo_residuals, _coo_robust_cost,
                 _damped_blocks, _inv3x3, _jt_r, _outer2, segment_sum)

_CG_RTOL = 1e-3
_REL_TOL = 1e-6


def _jc_dot(J: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[O, 2, k] x [O, k] -> [O, 2]."""
    return torch.stack([torch.sum(J[:, 0, :] * x, -1),
                        torch.sum(J[:, 1, :] * x, -1)], dim=-1)


def _schur_matvec(x, Ud, Vinv, Jc, Jp, w, oc, op, free, group=None):
    """S x for x [C, 6]; fixed cameras act as identity rows. Under a
    group the per-point partials are reduced before V^-1 and the
    per-camera ones after it."""
    C, P = Ud.shape[0], Vinv.shape[0]
    xf = x * free[:, None]
    a = _jc_dot(Jc, xf[oc]) * w[:, None]
    y = torch.einsum("pij,pj->pi", Vinv,
                     segment_sum(_jt_r(Jp, a), op, P, group))
    b = _jc_dot(Jp, y[op]) * w[:, None]
    Sx = (torch.einsum("cij,cj->ci", Ud, xf)
          - segment_sum(_jt_r(Jc, b), oc, C, group))
    return Sx * free[:, None] + x * (1.0 - free[:, None])


def _block_jacobi(Ud, Vinv, Jc, Jp, w, oc, op, free, group=None):
    """The exact diagonal blocks of S, inverted [C, 6, 6]: a point is
    observed at most once per camera, so block c is U_d,c minus a plain
    per-observation sum of K_o V^-1 K_o^T, K_o = Jc^T w Jp (under a group
    too: each (camera, point) pair is one observation on one rank)."""
    C = Ud.shape[0]
    K = _outer2(Jc * w[:, None, None], Jp)                  # [O, 6, 3]
    KVKt = K @ Vinv[op] @ K.transpose(1, 2)
    M = Ud - segment_sum(KVKt, oc, C, group)
    eye = torch.eye(6, dtype=M.dtype, device=M.device)
    M = M * free[:, None, None] + eye * (1.0 - free)[:, None, None]
    tr = torch.einsum("cii->c", M)
    M = M + eye * (1e-6 * tr[:, None, None] + 1e-8)
    return torch.linalg.inv(M)


def _pcg(rhs, Minv, matvec, iters: int, leave: bool = False):
    """Preconditioned CG on S x = rhs, stopping at ||r|| <= _CG_RTOL
    ||rhs|| (a sticky flag freezes the state from then on; with leave,
    the loop is left there instead, on the host, with the same x)."""
    tol = _CG_RTOL * torch.sqrt(torch.sum(rhs * rhs)) + 1e-12

    def apply_m(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    x = torch.zeros_like(rhs)
    r = rhs
    z = apply_m(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        go = torch.sqrt(torch.sum(r * r)) > tol
        if leave and not bool(go):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = apply_m(r_n)
        rz_n = torch.sum(r_n * z)
        p_n = z + (rz_n / torch.clamp(rz, min=1e-30)) * p
        x = torch.where(go, x_n, x)
        r = torch.where(go, r_n, r)
        p = torch.where(go, p_n, p)
        rz = torch.where(go, rz_n, rz)
    return x


def _robust_cost(prob, cam, kf_R, kf_t, points, obs_valid, delta2, group):
    """``ba._coo_robust_cost``, summed over the group under one."""
    cost = _coo_robust_cost(prob, cam, kf_R, kf_t, points, obs_valid, delta2)
    if group is None:
        return cost
    return comm.all_reduce(cost.double(), group).to(cost.dtype)


def ba_solve_pcg(prob: BAProblem, cam: cameras.CameraParams, iters: int = 10,
                 delta2: float = reproj.CHI2_MONO, lm_lambda0: float = 1e-4,
                 cg_iters: int = 100, group=None) -> BAResult:
    """LM bundle adjustment with an inner Schur-PCG; the API of
    ``ba.ba_solve``, for C beyond the dense solvers' reach. group: a
    process group of which each rank passes its own block of the
    observations (the module's docstring); None, or a group of one
    process, solves in this process alone."""
    group = comm.active(group)
    # under a group every reduction waits on the host anyway: the loops are
    # left where the sticky flags would freeze them, as the JAX
    # while_loops are, which skips the frozen iterations' collectives
    leave = group is not None
    C = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    dev = prob.points.device
    free = (~prob.fixed_cam).to(torch.float32)
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()

    def lm_step(kf_R, kf_t, points, obs_valid, lam, cost):
        r, Jc, Jp, depth_ok = _coo_residuals(prob, cam, kf_R, kf_t, points)
        ok = obs_valid & depth_ok & prob.point_valid[op]
        chi2 = torch.sum(r * r, dim=-1) * prob.obs_w
        w = prob.obs_w * reproj.huber_weight(chi2, delta2) * ok
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        U = segment_sum(_outer2(JcW, Jc), oc, C, group)
        b_c = segment_sum(_jt_r(JcW, r), oc, C, group)
        V = segment_sum(_outer2(JpW, Jp), op, P, group)
        b_p = segment_sum(_jt_r(JpW, r), op, P, group)
        Ud, Vd = _damped_blocks(U, V, lam)
        Vinv = torch.where(prob.point_valid[:, None, None], _inv3x3(Vd),
                           torch.zeros_like(Vd))
        y = torch.einsum("pij,pj->pi", Vinv, b_p)
        b = _jc_dot(Jp, y[op]) * w[:, None]
        rhs = (b_c - segment_sum(_jt_r(Jc, b), oc, C, group)) * free[:, None]
        Minv = _block_jacobi(Ud, Vinv, Jc, Jp, w, oc, op, free, group)
        dc = _pcg(rhs, Minv,
                  lambda x: _schur_matvec(x, Ud, Vinv, Jc, Jp, w, oc, op,
                                          free, group),
                  cg_iters, leave) * free[:, None]
        a = _jc_dot(Jc, dc[oc]) * w[:, None]
        dp = torch.einsum("pij,pj->pi", Vinv,
                          b_p - segment_sum(_jt_r(Jp, a), op, P, group))
        dp = torch.where(prob.point_valid[:, None], dp, torch.zeros_like(dp))
        T_new = se3.exp(dc).compose(SE3(kf_R, kf_t))
        pts_new = points + dp
        new_cost = _robust_cost(prob, cam, T_new.R, T_new.t, pts_new,
                                obs_valid, delta2, group)
        accept = ((new_cost < cost) & torch.isfinite(new_cost)
                  & torch.isfinite(dc).all() & torch.isfinite(dp).all())
        return T_new, pts_new, new_cost, accept

    def run(kf_R, kf_t, points, obs_valid, n):
        cost = _robust_cost(prob, cam, kf_R, kf_t, points, obs_valid, delta2,
                            group)
        lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(n):
            if leave and bool(done):
                break
            T_new, pts_new, new_cost, accept = lm_step(
                kf_R, kf_t, points, obs_valid, lam, cost)
            take = accept & ~done
            kf_R = torch.where(take, T_new.R, kf_R)
            kf_t = torch.where(take, T_new.t, kf_t)
            points = torch.where(take, pts_new, points)
            lam_next = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                                   torch.clamp(lam * 4.0, max=1e2))
            lam = torch.where(done, lam, lam_next)
            done_now = accept & (cost - new_cost <= _REL_TOL * cost + 1e-6)
            cost = torch.where(take, new_cost, cost)
            done = done | done_now
        return kf_R, kf_t, points, cost

    def gate(kf_R, kf_t, points, obs_valid, th):
        r, _, _, depth_ok = _coo_residuals(prob, cam, kf_R, kf_t, points)
        chi2 = torch.sum(r * r, dim=-1) * prob.obs_w
        return obs_valid & depth_ok & (chi2 <= th)

    n1 = max(iters // 3, 2)
    kf_R, kf_t, points, _ = run(prob.kf_R, prob.kf_t, prob.points,
                                prob.obs_valid, n1)
    obs_valid = gate(kf_R, kf_t, points, prob.obs_valid, 2.0 * delta2)
    kf_R, kf_t, points, cost = run(kf_R, kf_t, points, obs_valid,
                                   max(iters - n1, 1))
    kf_R = SE3(kf_R, kf_t).normalized().R
    inlier = gate(kf_R, kf_t, points, obs_valid, delta2)
    return BAResult(kf_R, kf_t, points, inlier, cost)
