"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
elimination, batched; the dense-table tier.

Counterpart of ``optim/ba.py`` of the JAX package (reference:
Optimizer::LocalBundleAdjustment / GlobalBundleAdjustemnt,
src/Optimizer.cc:1740, 2813). The problem is SoA COO (observations padded
to a static size); observations are re-laid once as a dense [P, d] table
(points on rows, observing cameras on a padded depth axis), after which
every per-iteration reduction is a dense product: U (per-camera 6x6),
V (per-point 3x3) and the [P, C, 6, 3] coupling W, the Schur system
S = U - W V^-1 W^T, a dense Cholesky of the [6C, 6C] system, and batched
back-substitution for the landmarks. Damping adapts with accept / reject.

``ba_solve`` routes by the camera count C as the JAX package does: the
table tier up to ``_TABLE_C_MAX`` cameras, the COO tier (``_ba_solve_coo``:
per-observation scatter-adds into U, V and W, then the same Schur solve)
up to ``_PCG_C_MIN``, and the matrix-free Schur-PCG solver of
``optim/schur_pcg.py`` above it. Global BA takes every keyframe of a map,
so it is the one caller of the upper two tiers.

Where this differs from the JAX code, with the same results:

* the JAX solve is a ``lax.while_loop`` that leaves early once an accepted
  step no longer lowers the cost. Here every iteration runs and a sticky
  ``done`` flag on the device freezes the state from then on, so a solve
  makes no host sync at all (the form of ``optim/pose_opt.py``);
* ``torch.linalg.cholesky_ex`` reports a non-positive-definite system in a
  flag where JAX's Cholesky returns NaN; the flag turns the step into NaN,
  which the same ``isfinite`` accept test then rejects;
* per-entry poses are row gathers by camera index, not one-hot products;
* the COO tier's scatter-adds sum in float64 and round once to float32:
  ``index_add_`` on the card adds in an arbitrary order, and in float64
  that order no longer shows in the float32 sums, so the card repeats
  itself and stays within rounding of the CPU.

The per-camera sums are float32 matrix products against the one-hot: keep
TF32 off on the card (``device.resolve`` does).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import comm, device as device_mod
from ..lie import SE3, se3
from ..models import cameras
from . import reproj


class BAProblem(NamedTuple):
    """Static-shape BA problem. C cameras, P points, O observations."""

    kf_R: torch.Tensor        # [C, 3, 3] world->camera rotations
    kf_t: torch.Tensor        # [C, 3]
    points: torch.Tensor      # [P, 3] world points
    obs_cam: torch.Tensor     # [O] int32
    obs_pt: torch.Tensor      # [O] int32
    obs_uv: torch.Tensor      # [O, 2]
    obs_w: torch.Tensor       # [O] information (1/sigma^2)
    obs_valid: torch.Tensor   # [O] bool
    fixed_cam: torch.Tensor   # [C] bool: poses held constant
    point_valid: torch.Tensor  # [P] bool


class BAResult(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # [O] bool after the final chi2 gate
    cost: torch.Tensor        # final robust cost


_PROBLEM_DTYPES = dict(
    kf_R=torch.float32, kf_t=torch.float32, points=torch.float32,
    obs_cam=torch.int32, obs_pt=torch.int32, obs_uv=torch.float32,
    obs_w=torch.float32, obs_valid=torch.bool, fixed_cam=torch.bool,
    point_valid=torch.bool)


def problem_from_numpy(arrays: dict, device="cpu") -> BAProblem:
    """A BAProblem from numpy arrays by field name (for a JAX ``BAProblem``
    p: ``{k: np.asarray(v) for k, v in p._asdict().items()}``), copied
    to the device in one transfer."""
    np_types = {torch.float32: np.float32, torch.int32: np.int32,
                torch.bool: bool}
    parts = device_mod.upload_packed(
        [np.asarray(arrays[k]).astype(np_types[dt], copy=False)
         for k, dt in _PROBLEM_DTYPES.items()], device)
    return BAProblem(**dict(zip(_PROBLEM_DTYPES, parts)))


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (0 where the determinant vanishes)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _damped_blocks(U, V, lam):
    """Trace-scaled LM damping of the camera / point diagonal blocks."""
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    trU = torch.clamp(torch.einsum("cii->c", U), min=1e-3)
    trV = torch.clamp(torch.einsum("pii->p", V), min=1e-3)
    Ud = U + lam * eye6 * trU[:, None, None] / 6.0
    Vd = V + lam * eye3 * trV[:, None, None] / 3.0
    return Ud, Vd


def _schur_lm_solve(U, b_c, V, b_p, Wd, lam, fixed_cam, point_valid):
    """Damped Schur reduction + dense Cholesky + landmark back-substitution.
    U [C, 6, 6], b_c [C, 6], V [P, 3, 3], b_p [P, 3], Wd [P, C, 6, 3]."""
    C = U.shape[0]
    P = Wd.shape[0]
    dev = U.device
    Ud, Vd = _damped_blocks(U, V, lam)
    Vinv = _inv3x3(Vd)
    Vinv = torch.where(point_valid[:, None, None], Vinv,
                       torch.zeros_like(Vinv))

    # S = U - W V^-1 W^T, rhs = b_c - W V^-1 b_p; the contraction over the
    # points runs as one flat [6C, 3P] x [3P, 6C] product
    A = Wd.reshape(P, C * 6, 3)
    Y = A @ Vinv                                         # [P, C*6, 3]
    Yf = Y.permute(1, 0, 2).reshape(C * 6, P * 3)
    Wf = A.permute(1, 0, 2).reshape(C * 6, P * 3)
    S = (-(Yf @ Wf.T)).reshape(C, 6, C, 6)
    ar = torch.arange(C, device=dev)
    S[ar, :, ar, :] += Ud
    rhs = b_c - (Yf @ b_p.reshape(P * 3)).reshape(C, 6)

    # fixed cameras: identity rows / columns, zero rhs
    free = ~fixed_cam
    fmask = free[:, None].to(S.dtype)
    S = S * fmask[:, :, None, None] * fmask[None, None, :, :]
    eye6 = torch.eye(6, dtype=S.dtype, device=dev)
    S[ar, :, ar, :] += eye6 * fixed_cam[:, None, None].to(S.dtype)
    rhs = rhs * fmask

    Sm = S.reshape(6 * C, 6 * C)
    # the f32 Schur reduction leaves O(eps * ||S||) asymmetry: the jitter
    # scales with the spectrum or Cholesky fails at small lambda
    jitter = 1e-5 * torch.max(torch.diagonal(Sm)) + 1e-3
    L, info = torch.linalg.cholesky_ex(
        Sm + jitter * torch.eye(6 * C, dtype=S.dtype, device=dev))
    dc = torch.cholesky_solve(rhs.reshape(-1, 1), L)[:, 0].reshape(C, 6)
    # a failed factorisation becomes NaN, which the accept test rejects
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
    dc = torch.where(free[:, None], dc, torch.zeros_like(dc))

    # back-substitute the landmarks: dp = Vinv (b_p - W^T dc)
    WTdc = torch.einsum("pcix,ci->px", Wd, dc)
    dp = torch.einsum("pxy,py->px", Vinv, b_p - WTdc)
    dp = torch.where(point_valid[:, None], dp, torch.zeros_like(dp))
    return dc, dp


# Relative cost decrease below which an accepted LM step ends the solve.
_REL_TOL = 1e-6

# Above this camera count the [P, d] tables outgrow their use: assemble by
# COO scatter-add instead (global BA).
_TABLE_C_MAX = 48

# Above this camera count even the COO tier's dense [P, C, 6, 3] coupling
# and [6C, 6C] Cholesky are too large: the matrix-free Schur-PCG solver.
_PCG_C_MIN = 128


def tier_of(C: int) -> str:
    """The tier ``ba_solve`` takes for C cameras: "table", "coo" or "pcg"."""
    return ("pcg" if C > _PCG_C_MIN else "coo" if C > _TABLE_C_MAX
            else "table")


class ObsTable(NamedTuple):
    """Dense [P, d] observation-table layout.

    tab: [P, d] obs id or -1; tvalid: [P, d]; cam_t: [P, d] camera per slot;
    uv_t: [P, d, 2]; w_t: [P, d] (0 on padding / invalid points);
    onehot: [P, d, C] camera one-hot (0 rows on padding); inval: [P, d]
    float 1.0 on padding; pos: [O] flat table slot per obs (P*d = absent).
    """
    tab: torch.Tensor
    tvalid: torch.Tensor
    cam_t: torch.Tensor
    uv_t: torch.Tensor
    w_t: torch.Tensor
    onehot: torch.Tensor
    inval: torch.Tensor
    pos: torch.Tensor


def build_obs_table(obs_pt, obs_cam, obs_uv, obs_w, obs_valid, point_valid,
                    P: int, C: int, d: int) -> ObsTable:
    """Re-lay observations as a dense [P, d] table: one stable sort by point
    and one scatter into a (P+1, d+1) table whose last row and column take
    the invalid and the overflowing observations."""
    O = obs_pt.shape[0]
    dev = obs_pt.device
    pt = torch.where(obs_valid, obs_pt.long(),
                     torch.full((O,), P, dtype=torch.long, device=dev))
    pt_s, order = torch.sort(pt, stable=True)
    starts = torch.searchsorted(pt_s, torch.arange(P, device=dev))
    rank = (torch.arange(O, device=dev)
            - starts[torch.clamp(pt_s, 0, P - 1)])
    rank = torch.where(pt_s < P, rank, torch.full_like(rank, d))
    tab = torch.full((P + 1, d + 1), -1, dtype=torch.int32, device=dev)
    tab[torch.clamp(pt_s, max=P), torch.clamp(rank, 0, d)] = order.to(
        torch.int32)
    tab = tab[:P, :d].contiguous()
    tvalid = tab >= 0
    # inverse mapping obs id -> flat table slot (P*d = "not in the table")
    in_tab = (pt_s < P) & (rank < d)
    flat_slot = torch.clamp(pt_s, max=P - 1) * d + torch.clamp(rank, 0, d - 1)
    pos = torch.full((O,), P * d, dtype=torch.long, device=dev)
    pos[order] = torch.where(in_tab, flat_slot,
                             torch.full_like(flat_slot, P * d))
    idx = torch.clamp(tab, min=0).long()
    cam_t = torch.where(tvalid, obs_cam[idx].to(torch.int32),
                        torch.zeros_like(tab))
    uv_t = obs_uv[idx]
    w_t = torch.where(tvalid & point_valid[:, None], obs_w[idx],
                      torch.zeros((), dtype=obs_w.dtype, device=dev))
    onehot = (torch.nn.functional.one_hot(cam_t.long(), C).to(torch.float32)
              * tvalid[..., None].to(torch.float32))
    inval = (~tvalid).to(torch.float32)
    return ObsTable(tab, tvalid, cam_t, uv_t, w_t, onehot, inval,
                    pos.to(torch.int32))


def table_depth_of(prob: BAProblem, table_depth: int = 0) -> int:
    C = int(prob.kf_R.shape[0])
    return min(table_depth, C) if table_depth > 0 else C


def prepare_table(prob: BAProblem, table_depth: int = 0) -> ObsTable:
    """The observation table of a problem. It depends only on the problem's
    structure, so callers that re-solve with updated states build it once."""
    return build_obs_table(
        prob.obs_pt, prob.obs_cam, prob.obs_uv, prob.obs_w, prob.obs_valid,
        prob.point_valid, int(prob.points.shape[0]), int(prob.kf_R.shape[0]),
        table_depth_of(prob, table_depth))


def _entry_poses(TL: ObsTable, kf_R, kf_t):
    """Per-entry pose; padding entries get the identity pose at z = 1, so
    no NaN leaks into the 0-weighted sums."""
    cam = TL.cam_t.long()
    eye3 = torch.eye(3, dtype=kf_R.dtype, device=kf_R.device)
    ez = eye3[2]
    R_e = torch.where(TL.tvalid[..., None, None], kf_R[cam], eye3)
    t_e = torch.where(TL.tvalid[..., None], kf_t[cam], ez)
    return R_e, t_e


def _chi2_sweep(TL, kf_R, kf_t, points, cam):
    """Per-entry squared error and depth gate, no Jacobians."""
    R_e, t_e = _entry_poses(TL, kf_R, kf_t)
    pc = torch.einsum("pdij,pj->pdi", R_e, points) + t_e
    r = TL.uv_t - cameras.project(cam, pc)
    return torch.sum(r * r, dim=-1), pc[..., 2] > 0.05


def _robust_cost(TL, kf_R, kf_t, points, w_t, cam, delta2: float):
    err2, depth_ok = _chi2_sweep(TL, kf_R, kf_t, points, cam)
    chi2 = err2 * w_t
    ok = (w_t > 0) & depth_ok
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0))
                      - delta2)
    return torch.sum(torch.where(ok, rho, torch.zeros_like(rho)))


def assemble_normal_equations(TL: ObsTable, kf_R, kf_t, points, w_t, cam,
                              delta2: float):
    """(U [C,6,6], b_c [C,6], V [P,3,3], b_p [P,3], Wd [P,C,6,3]) of the
    Huber-weighted Gauss-Newton system at the given state."""
    P, d = TL.tab.shape
    C = kf_R.shape[0]
    R_e, t_e = _entry_poses(TL, kf_R, kf_t)
    X = points[:, None, :].expand(P, d, 3)
    r, Jc, Jp, depth_ok = reproj.residual_full(SE3(R_e, t_e), X, TL.uv_t, cam)
    chi2 = torch.sum(r * r, dim=-1) * w_t
    w = w_t * reproj.huber_weight(chi2, delta2) * depth_ok

    oh2 = TL.onehot.reshape(P * d, C)
    JcW = Jc * w[..., None, None]                              # [P, d, 2, 6]
    G = torch.einsum("pdki,pdkj->pdij", JcW, Jc).reshape(P * d, 36)
    U = (oh2.T @ G).reshape(C, 6, 6)
    b_c = oh2.T @ torch.einsum("pdki,pdk->pdi", JcW, r).reshape(P * d, 6)

    JpW = Jp * w[..., None, None]                              # [P, d, 2, 3]
    V = torch.einsum("pdkx,pdky->pxy", JpW, Jp)
    b_p = torch.einsum("pdkx,pdk->px", JpW, r)
    Hm = torch.einsum("pdki,pdkx->pdix", JcW, Jp).reshape(P, d, 18)
    Wd = torch.einsum("pdc,pdk->pck", TL.onehot, Hm).reshape(P, C, 6, 3)
    return U, b_c, V, b_p, Wd


def _ba_solve_tables(prob: BAProblem, cam: cameras.CameraParams, iters: int,
                     delta2: float, lm_lambda0: float,
                     TL: ObsTable) -> BAResult:
    """LM-BA on the dense observation table (see the module docstring)."""
    P, d = TL.tab.shape
    dev = prob.points.device
    w_t0 = TL.w_t

    def run(kf_R, kf_t, points, w_t, n):
        cost = _robust_cost(TL, kf_R, kf_t, points, w_t, cam, delta2)
        # filled on the device: a tensor from a Python number is an upload
        lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(n):
            U, b_c, V, b_p, Wd = assemble_normal_equations(
                TL, kf_R, kf_t, points, w_t, cam, delta2)
            dc, dp = _schur_lm_solve(U, b_c, V, b_p, Wd, lam,
                                     prob.fixed_cam, prob.point_valid)
            T_new = se3.exp(dc).compose(SE3(kf_R, kf_t))
            pts_new = points + dp
            new_cost = _robust_cost(TL, T_new.R, T_new.t, pts_new, w_t, cam,
                                    delta2)
            accept = ((new_cost < cost) & torch.isfinite(new_cost)
                      & torch.isfinite(dc).all() & torch.isfinite(dp).all())
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

    # phase 1 with Huber, drop gross outliers at the chi2 gate, phase 2 on
    # the survivors (reference LocalBundleAdjustment)
    n1 = max(iters // 3, 2)
    kf_R, kf_t, points, _ = run(prob.kf_R, prob.kf_t, prob.points, w_t0, n1)
    err2, depth_ok = _chi2_sweep(TL, kf_R, kf_t, points, cam)
    w_t = torch.where(depth_ok & (err2 * w_t0 <= 2.0 * delta2), w_t0,
                      torch.zeros_like(w_t0))
    kf_R, kf_t, points, cost = run(kf_R, kf_t, points, w_t,
                                   max(iters - n1, 1))

    # final renormalisation + chi2 gate in observation order (reference
    # erases obs above the chi2 threshold, Optimizer.cc:2040-2100)
    kf_R = SE3(kf_R, kf_t).normalized().R
    err2, depth_ok = _chi2_sweep(TL, kf_R, kf_t, points, cam)
    ok_t = TL.tvalid & depth_ok & (err2 * w_t0 <= delta2) & (w_t0 > 0)
    # slot P*d is True: a valid observation that overflowed the table depth
    # was never solved against and is not detached as an outlier
    ok_flat = torch.cat([ok_t.reshape(P * d),
                         torch.ones(1, dtype=torch.bool, device=dev)])
    inlier = ok_flat[TL.pos.long()] & prob.obs_valid
    return BAResult(kf_R, kf_t, points, inlier, cost)


def _coo_residuals(prob: BAProblem, cam, kf_R, kf_t, points):
    T = SE3(kf_R[prob.obs_cam.long()], kf_t[prob.obs_cam.long()])
    return reproj.residual_full(T, points[prob.obs_pt.long()], prob.obs_uv,
                                cam)


def _coo_robust_cost(prob: BAProblem, cam, kf_R, kf_t, points, obs_valid,
                     delta2: float):
    r, _, _, depth_ok = _coo_residuals(prob, cam, kf_R, kf_t, points)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_w
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0))
                      - delta2)
    return torch.sum(torch.where(obs_valid & depth_ok, rho,
                                 torch.zeros_like(rho)))


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                n: int, group=None) -> torch.Tensor:
    """Sum of the rows of values [O, ...] per segment id [O] -> [n, ...],
    accumulated in float64 and rounded once to the values' type. With a
    process group (``comm``) each rank holds a block of the
    observations: the float64 partial sums are summed over the group
    before the rounding."""
    out = torch.zeros((n, *values.shape[1:]), dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, segments.long(), values.double())
    if group is not None:
        comm.all_reduce(out, group)
    return out.to(values.dtype)


def _outer2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """sum_k A[:, k, :, None] * B[:, k, None, :] over the 2 residual rows."""
    return A[:, 0, :, None] * B[:, 0, None, :] + A[:, 1, :, None] * B[:, 1, None, :]


def _jt_r(J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[O, 2, k]^T x [O, 2] -> [O, k]."""
    return J[:, 0, :] * r[:, 0, None] + J[:, 1, :] * r[:, 1, None]


def coo_normal_equations(prob: BAProblem, cam: cameras.CameraParams,
                         kf_R, kf_t, points, obs_valid, delta2: float,
                         group=None):
    """The COO tier's robust Gauss-Newton system at one state, summed per
    observation: U [C, 6, 6], b_c [C, 6], V [P, 3, 3], b_p [P, 3] and the
    coupling W [P, C, 6, 3], in the state's type. Each observation's terms
    are evaluated in float64 from the state: at a converged state the
    per-point sums of J^T r cancel to a small fraction of their terms, and
    float32 terms (FMA and matmul order) left the card's and the CPU's
    b_p apart by up to 1.8e-4 of its largest entry. With a process group
    the observations are this rank's block, and every sum is reduced over
    the group (``segment_sum``)."""
    C = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    r, Jc, Jp, depth_ok = _coo_residuals(prob, cam, kf_R.double(),
                                         kf_t.double(), points.double())
    ok = obs_valid & depth_ok & prob.point_valid[op]
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_w
    w = prob.obs_w * reproj.huber_weight(chi2, delta2) * ok
    JcW = Jc * w[:, None, None]
    JpW = Jp * w[:, None, None]
    U = segment_sum(_outer2(JcW, Jc), oc, C, group)
    b_c = segment_sum(_jt_r(JcW, r), oc, C, group)
    V = segment_sum(_outer2(JpW, Jp), op, P, group)
    b_p = segment_sum(_jt_r(JpW, r), op, P, group)
    Wd = segment_sum(_outer2(JcW, Jp), op * C + oc, P * C, group).reshape(
        P, C, 6, 3)
    return tuple(x.to(points.dtype) for x in (U, b_c, V, b_p, Wd))


def _ba_solve_coo(prob: BAProblem, cam: cameras.CameraParams, iters: int,
                  delta2: float, lm_lambda0: float) -> BAResult:
    """COO scatter-add assembly for mid-size C (the table too wide, PCG not
    yet warranted): ``coo_normal_equations``, then ``_schur_lm_solve``.
    Every iteration runs (the JAX tier has no early exit either)."""
    dev = prob.points.device

    def run(kf_R, kf_t, points, obs_valid, n):
        cost = _coo_robust_cost(prob, cam, kf_R, kf_t, points, obs_valid,
                                delta2)
        lam = torch.full((), lm_lambda0, dtype=torch.float32, device=dev)
        for _ in range(n):
            U, b_c, V, b_p, Wd = coo_normal_equations(
                prob, cam, kf_R, kf_t, points, obs_valid, delta2)
            dc, dp = _schur_lm_solve(U, b_c, V, b_p, Wd, lam,
                                     prob.fixed_cam, prob.point_valid)
            T_new = se3.exp(dc).compose(SE3(kf_R, kf_t))
            pts_new = points + dp
            new_cost = _coo_robust_cost(prob, cam, T_new.R, T_new.t, pts_new,
                                        obs_valid, delta2)
            accept = ((new_cost < cost) & torch.isfinite(new_cost)
                      & torch.isfinite(dc).all() & torch.isfinite(dp).all())
            kf_R = torch.where(accept, T_new.R, kf_R)
            kf_t = torch.where(accept, T_new.t, kf_t)
            points = torch.where(accept, pts_new, points)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 4.0, max=1e2))
            cost = torch.where(accept, new_cost, cost)
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
                                   iters - n1)
    kf_R = SE3(kf_R, kf_t).normalized().R
    inlier = gate(kf_R, kf_t, points, obs_valid, delta2)
    return BAResult(kf_R, kf_t, points, inlier, cost)


def ba_solve(prob: BAProblem, cam: cameras.CameraParams, iters: int = 10,
             delta2: float = reproj.CHI2_MONO, lm_lambda0: float = 1e-4,
             table_depth: int = 0, table: ObsTable | None = None) -> BAResult:
    """Run LM-BA; returns updated poses / points and the final inlier mask.

    table_depth: static depth of the observation table (0 = C). Callers
    pass the true maximum of observations per point, bucketed (see
    ``local_mapping.build_ba_problem``); observations beyond it are not
    solved against. table: optional prebuilt table (``prepare_table``).
    Above ``_TABLE_C_MAX`` cameras both are ignored: the COO tier, and
    above ``_PCG_C_MIN`` the Schur-PCG solver, take the problem."""
    C = int(prob.kf_R.shape[0])
    if C > _PCG_C_MIN:
        from . import schur_pcg   # schur_pcg imports this module
        return schur_pcg.ba_solve_pcg(prob, cam, iters, delta2, lm_lambda0)
    if C > _TABLE_C_MAX:
        return _ba_solve_coo(prob, cam, iters, delta2, lm_lambda0)
    if table is None:
        table = prepare_table(prob, table_depth)
    return _ba_solve_tables(prob, cam, iters, delta2, lm_lambda0, table)


def ba_solve_fused(prob: BAProblem, cam: cameras.CameraParams,
                   iters: int = 10, delta2: float = reproj.CHI2_MONO,
                   lm_lambda0: float = 1e-4, table_depth: int = 0) -> BAResult:
    """Build and solve in one call, with ``ba_solve``'s routing (the JAX
    package's single-program form; here the same as ``ba_solve`` without a
    prebuilt table)."""
    return ba_solve(prob, cam, iters, delta2, lm_lambda0, table_depth)
