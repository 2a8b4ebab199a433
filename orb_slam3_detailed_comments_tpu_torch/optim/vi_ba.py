"""Visual-inertial bundle adjustment: 15-dof keyframe states.

Counterpart of ``optim/vi_ba.py`` of the JAX package (reference:
Optimizer::LocalInertialBA / FullInertialBA, src/Optimizer.cc:2203, 3237).
Each keyframe state is [dp (3), dphi (3), v (3), bg (3), ba (3)]: the body
pose in the world (R_wb <- R_wb Exp(dphi), p <- p + R_wb dp), the velocity
and per-keyframe biases with random-walk coupling. Per LM iteration:

* the reprojection terms (through the body -> camera extrinsic) enter the
  pose blocks, the landmarks are Schur-eliminated as in ``optim/ba.py``;
* the 9-dof preintegration edges between consecutive keyframes are
  linearised over the 24-dim pair state (the written-out derivatives of
  ``factors.inertial_jacobians``, where the JAX code takes ``jacfwd``) and
  placed into the [15C, 15C] reduced system, with the 6-dof bias
  random-walk edges and the bias priors (priorG / priorA, reference
  LocalMapping.cc:236-244);
* the reduced system is equilibrated (Jacobi) and solved by a jittered
  Cholesky; the step is accepted where the cost falls.

Where this differs from the JAX code, with the same optimum: the visual
terms are summed per observation (the COO form of ``ba._ba_solve_coo``),
and the normal equations, the Schur reduction, the solve and the costs run
in float64. The accept test and the Cholesky decide on floats; in float64
the card's sums in arbitrary order and the CPU's land on the same side.
The states stay float32, as in JAX, and every iteration runs (the JAX loop
has no early exit either), so a solve makes no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..imu import factors
from ..imu.preintegration import Preintegrated
from ..lie import so3
from ..models import cameras
from . import ba as ba_mod
from . import reproj

D = 15  # per-keyframe state dim


class VIBAProblem(NamedTuple):
    R_wb: torch.Tensor       # [C, 3, 3] body states (world frame)
    p_w: torch.Tensor        # [C, 3]
    v_w: torch.Tensor        # [C, 3]
    bg: torch.Tensor         # [C, 3]
    ba: torch.Tensor         # [C, 3]
    points: torch.Tensor     # [P, 3]
    point_valid: torch.Tensor
    obs_cam: torch.Tensor    # [O] int32
    obs_pt: torch.Tensor     # [O] int32
    obs_uv: torch.Tensor     # [O, 2]
    obs_w: torch.Tensor      # [O]
    obs_valid: torch.Tensor  # [O]
    edge_i: torch.Tensor     # [E] int32, inertial edges i -> j
    edge_j: torch.Tensor
    edge_pre: Preintegrated  # [E] leading
    edge_valid: torch.Tensor  # [E]
    fixed_cam: torch.Tensor  # [C]


class VIBAResult(NamedTuple):
    R_wb: torch.Tensor
    p_w: torch.Tensor
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


_STATE = ("R_wb", "p_w", "v_w", "bg", "ba", "points")


def _visual_terms(pr: VIBAProblem, cam, R_cb, t_cb):
    """Per observation: r = uv - pred [O, 2], d pred / d (dp, dphi)
    [O, 2, 6], d pred / d X [O, 2, 3] and the depth gate."""
    oc, op = pr.obs_cam.long(), pr.obs_pt.long()
    R_bw = pr.R_wb[oc].transpose(-1, -2)
    x_b = torch.einsum("oij,oj->oi", R_bw, pr.points[op] - pr.p_w[oc])
    x_c = x_b @ R_cb.T + t_cb
    r = pr.obs_uv - cameras.project(cam, x_c)
    JR = reproj._point_jac(cameras.project_jac(cam, x_c), R_cb)
    # d x_b / d (dp, dphi) = [-I | hat(x_b)]: Jc = JR [-I | hat(x_b)]
    Jc = -reproj._twist_jac(JR, x_b)
    Jp = reproj._point_jac(JR, R_bw)
    return r, Jc, Jp, x_c[:, 2] > 0.05


def _huber_rho(chi2, delta2):
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0))
                       - delta2)


def _edge_states(pr: VIBAProblem):
    ei, ej = pr.edge_i.long(), pr.edge_j.long()
    return (pr.R_wb[ei], pr.p_w[ei], pr.v_w[ei], pr.R_wb[ej], pr.p_w[ej],
            pr.v_w[ej], pr.bg[ei], pr.ba[ei])


def _edge_residual(pr: VIBAProblem, gravity):
    """The 9-dof residual of every edge [E, 9] at the current states."""
    return factors.inertial_residual(*_edge_states(pr), pr.edge_pre, gravity)


def _edge_linearisation(pr: VIBAProblem, gravity):
    """(r [E, 9], J [E, 9, 24]) over the pair state (dims 0:15 keyframe i's
    (dp, dphi, dv, dbg, dba), 15:24 keyframe j's (dp, dphi, dv)), for
    R <- R Exp(dphi), p <- p + R dp."""
    st = _edge_states(pr)
    R_i, R_j = st[0], st[3]
    r, J_i, J_j, J_bg, J_ba = factors.inertial_jacobians(
        *st, pr.edge_pre, gravity)
    J = torch.cat([J_i[..., 3:6] @ R_i, J_i[..., 0:3], J_i[..., 6:9], J_bg,
                   J_ba, J_j[..., 3:6] @ R_j, J_j[..., 0:3], J_j[..., 6:9]],
                  dim=-1)
    return r, J


def vi_ba_solve(prob: VIBAProblem, cam: cameras.CameraParams,
                R_cb: torch.Tensor, t_cb: torch.Tensor, gravity,
                prior_gyro: float = 0.0, prior_acc: float = 0.0,
                iters: int = 8, delta2: float = reproj.CHI2_MONO,
                huber_imu2: float = 1e9,
                fix_points: bool = False) -> VIBAResult:
    C = prob.R_wb.shape[0]
    P = prob.points.shape[0]
    E = prob.edge_i.shape[0]
    dev = prob.points.device
    f64 = torch.float64
    CD = C * D

    # ---- loop-invariant edge quantities ---------------------------------
    info_e = factors.information_9(prob.edge_pre).to(f64)       # [E, 9, 9]
    infb_e = factors.bias_walk_information(prob.edge_pre).to(f64)
    ev = prob.edge_valid.to(f64)
    oh_i = torch.nn.functional.one_hot(prob.edge_i.long(), C).to(f64)
    oh_j = torch.nn.functional.one_hot(prob.edge_j.long(), C).to(f64)
    eye = torch.eye(D, dtype=f64, device=dev)
    # pair-state placement Q [E, 24, C*D]: dims 0:15 at keyframe i, 15:24
    # at keyframe j's (dp, dphi, dv)
    Q = torch.cat([oh_i[:, None, :, None] * eye[None, :, None, :],
                   oh_j[:, None, :, None] * eye[:9][None, :, None, :]],
                  dim=1).reshape(E, 24, CD)
    # bias random walk d rb / d x [E, 6, C*D]: +I at j's bias block, -I at
    # i's
    J_rw = ((oh_j - oh_i)[:, None, :, None]
            * eye[9:15][None, :, None, :]).reshape(E, 6, CD)
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    pt_ok = prob.point_valid[op]
    free = ~prob.fixed_cam
    fmask = free.to(f64)
    prior_diag = torch.zeros(D, dtype=f64, device=dev)
    prior_diag[9:12] = prior_gyro
    prior_diag[12:15] = prior_acc

    def cost_fn(pr: VIBAProblem):
        r, _, _, depth_ok = _visual_terms(pr, cam, R_cb, t_cb)
        chi2 = (torch.sum(r * r, -1) * pr.obs_w).double()
        ok = pr.obs_valid & depth_ok & pt_ok
        cv = torch.sum(torch.where(ok, _huber_rho(chi2, delta2), 0.0))
        re = _edge_residual(pr, gravity).double()
        c = torch.einsum("ei,eij,ej->e", re, info_e, re)
        ci = torch.sum(torch.where(prob.edge_valid,
                                   _huber_rho(c, huber_imu2), 0.0))
        cp = (prior_gyro * torch.sum(pr.bg.double() ** 2)
              + prior_acc * torch.sum(pr.ba.double() ** 2))
        return cv + ci + cp

    def lm_step(pr: VIBAProblem, lam, cost):
        # ---- visual part with Schur elimination ---------------------------
        r, Jc, Jp, depth_ok = _visual_terms(pr, cam, R_cb, t_cb)
        chi2 = torch.sum(r * r, -1) * pr.obs_w
        w = (pr.obs_w * reproj.huber_weight(chi2, delta2)
             * (pr.obs_valid & depth_ok & pt_ok)).double()
        r, Jc, Jp = r.double(), Jc.double(), Jp.double()
        JcW = Jc * w[:, None, None]
        U6 = torch.zeros((C, 6, 6), dtype=f64, device=dev).index_add_(
            0, oc, ba_mod._outer2(JcW, Jc))
        b6 = torch.zeros((C, 6), dtype=f64, device=dev).index_add_(
            0, oc, ba_mod._jt_r(JcW, r))
        JpW = Jp * w[:, None, None]
        V = torch.zeros((P, 3, 3), dtype=f64, device=dev).index_add_(
            0, op, ba_mod._outer2(JpW, Jp))
        b_p = torch.zeros((P, 3), dtype=f64, device=dev).index_add_(
            0, op, ba_mod._jt_r(JpW, r))
        Wd = torch.zeros((P * C, 6, 3), dtype=f64, device=dev).index_add_(
            0, op * C + oc, ba_mod._outer2(JcW, Jp)).reshape(P, C, 6, 3)

        eye3 = torch.eye(3, dtype=f64, device=dev)
        Vd = V + lam * eye3 * torch.clamp(
            torch.einsum("pii->p", V), min=1e-3)[:, None, None] / 3.0
        Vinv = ba_mod._inv3x3(Vd)
        keep = prob.point_valid & (not fix_points)
        Vinv = torch.where(keep[:, None, None], Vinv, 0.0)
        A = Wd.reshape(P, C * 6, 3)
        Y = A @ Vinv
        Yf = Y.permute(1, 0, 2).reshape(C * 6, P * 3)
        Wf = A.permute(1, 0, 2).reshape(C * 6, P * 3)
        S6 = (-(Yf @ Wf.T)).reshape(C, 6, C, 6)
        rhs6 = b6 - (Yf @ b_p.reshape(P * 3)).reshape(C, 6)

        # ---- the [C*D, C*D] reduced system --------------------------------
        H = torch.zeros((C, D, C, D), dtype=f64, device=dev)
        H[:, 0:6, :, 0:6] = S6
        ar = torch.arange(C, device=dev)
        H[ar, 0:6, ar, 0:6] += U6
        H[ar, :, ar, :] += torch.diag(prior_diag)
        g = torch.zeros((C, D), dtype=f64, device=dev)
        g[:, 0:6] = rhs6
        g[:, 9:12] -= prior_gyro * pr.bg.double()
        g[:, 12:15] -= prior_acc * pr.ba.double()
        H = H.reshape(CD, CD)
        g = g.reshape(CD)

        # inertial edges: H += sum_e Q^T Hee Q, g += sum_e Q^T ge
        re, Je = _edge_linearisation(pr, gravity)
        re, Je = re.double(), Je.double()                   # [E,9], [E,9,24]
        chi_i = torch.einsum("ei,eij,ej->e", re, info_e, re)
        w_imu = reproj.huber_weight(chi_i, huber_imu2) * ev
        JtW = (torch.einsum("eki,ekl->eil", Je, info_e)
               * w_imu[:, None, None])
        Hee = JtW @ Je                                      # [E, 24, 24]
        ge = -torch.einsum("eil,el->ei", JtW, re)
        H = H + Q.reshape(E * 24, CD).T @ (Hee @ Q).reshape(E * 24, CD)
        g = g + ge.reshape(E * 24) @ Q.reshape(E * 24, CD)
        # bias random walk: H += J^T W J, g -= J^T W rb
        rb = torch.cat([pr.bg[prob.edge_j.long()] - pr.bg[prob.edge_i.long()],
                        pr.ba[prob.edge_j.long()] - pr.ba[prob.edge_i.long()]],
                       dim=1).double()
        WB = infb_e * ev[:, None, None]
        H = H + J_rw.reshape(E * 6, CD).T @ (WB @ J_rw).reshape(E * 6, CD)
        g = g - torch.einsum("eij,ej->ei", WB, rb).reshape(E * 6) @ \
            J_rw.reshape(E * 6, CD)

        # fixed keyframes, damping, Jacobi equilibration, Cholesky
        fm = fmask.repeat_interleave(D)
        H = H * fm[:, None] * fm[None, :]
        g = g * fm
        diagH = torch.diagonal(H)
        H = H + torch.diag(lam * torch.clamp(diagH, min=1e-3) + (1.0 - fm))
        Es = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-8))
        Hs = H * Es[:, None] * Es[None, :]
        Lc, info = torch.linalg.cholesky_ex(
            Hs + 1e-5 * torch.eye(CD, dtype=f64, device=dev))
        y = torch.cholesky_solve((g * Es)[:, None], Lc)[:, 0]
        y = torch.where(info == 0, y, torch.full_like(y, float("nan")))
        dx = (y * Es).reshape(C, D)
        dx = torch.where(free[:, None], dx, 0.0)

        # landmark back-substitution (visual only)
        WTdc = torch.einsum("pcix,ci->px", Wd, dx[:, 0:6])
        dpt = torch.einsum("pxy,py->px", Vinv, b_p - WTdc)

        dxf, dptf = dx.to(torch.float32), dpt.to(torch.float32)
        R_new = so3.normalize(pr.R_wb @ so3.exp(dxf[:, 3:6]))
        p_new = pr.p_w + torch.einsum("cij,cj->ci", pr.R_wb, dxf[:, 0:3])
        cand = pr._replace(R_wb=R_new, p_w=p_new, v_w=pr.v_w + dxf[:, 6:9],
                           bg=pr.bg + dxf[:, 9:12], ba=pr.ba + dxf[:, 12:15],
                           points=pr.points + dptf)
        new_cost = cost_fn(cand)
        accept = ((new_cost < cost) & torch.isfinite(new_cost)
                  & torch.isfinite(dx).all())
        pr = pr._replace(**{f: torch.where(accept, getattr(cand, f),
                                           getattr(pr, f)) for f in _STATE})
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e2))
        cost = torch.where(accept, new_cost, cost)
        return pr, lam, cost

    pr = prob
    cost = cost_fn(pr)
    lam = torch.full((), 1e-4, dtype=f64, device=dev)
    for _ in range(iters):
        pr, lam, cost = lm_step(pr, lam, cost)

    r, _, _, depth_ok = _visual_terms(pr, cam, R_cb, t_cb)
    chi2 = torch.sum(r * r, -1) * pr.obs_w
    inlier = pr.obs_valid & depth_ok & (chi2 <= delta2)
    return VIBAResult(pr.R_wb, pr.p_w, pr.v_w, pr.bg, pr.ba, pr.points,
                      inlier, cost.to(torch.float32))
