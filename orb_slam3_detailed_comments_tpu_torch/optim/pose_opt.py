"""Motion-only pose optimization (tracking hot loop #2).

Counterpart of ``optim/pose_opt.py::pose_optimization`` of the JAX package
(reference: Optimizer::PoseOptimization, src/Optimizer.cc:55): 4 rounds x 10
Gauss-Newton iterations with a Huber kernel, re-classifying outliers at the
chi2(0.95) gate between rounds.

The JAX version leaves a round's GN loop once the applied step is below
tolerance (a ``while_loop``). Eager PyTorch would pay one host sync per
iteration to test that; here every iteration runs and a sticky done flag on
the device freezes the pose once a step converged, which gives exactly the
JAX result (after convergence the pose is frozen, not advanced) with no
host sync inside the optimizer.

``pose_optimization`` runs that plain twin (``pose_optimization_plain``)
on a CPU tensor. On a CUDA tensor it launches ``csrc/pose_gn.cu`` once: a
thread block runs the whole solve, the same iterations, gates and damping,
with the normal equations summed and solved in float64 (the twin sums and
solves in float32), and leaves a round once its step converged. Every
output is a fresh tensor and no input is written. ``native.launches
["pose_gn"]`` counts the launches.

The visual-inertial optimisers follow (``pose_opt.py:79-377`` of the JAX
package): ``pose_inertial_optimization`` (the frame's 9-dof nav state
against its matches and one preintegrated edge to a fixed anchor),
``pose_inertial_optimization_last_frame`` (30 dof: the last frame's 15-dof
state under its marginalisation prior jointly with the current frame's,
then the Schur marginalisation of the older frame into the next prior) and
``build_frame_prior``. Their GN loops take the same sticky done flag. The
JAX code takes ``jax.jacfwd`` of each residual; here the Jacobians are
written out: the visual rows (d x_b / d phi = hat(x_b), d x_b / d p = -R^T
for R <- R Exp(phi), p <- p + dp), the inertial rows
(``factors.inertial_jacobians``), the bias walk's +-I and the prior's
inverse right Jacobian. Where the JAX code sums and solves in float32, the
normal equations here are summed and solved in float64 and the step rounded
once to float32: the inlier gates downstream turn on the pose, and in
float64 the card's and the CPU's sums no longer part.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import native
from ..imu import factors
from ..lie import SE3, se3, so3
from ..models import cameras
from ..utils import timing
from . import reproj


class PoseOptResult(NamedTuple):
    T_cw: SE3
    inlier: torch.Tensor     # [M] bool
    n_inliers: torch.Tensor  # scalar int32


def pose_optimization(T_cw0: SE3, X_w: torch.Tensor, uv: torch.Tensor,
                      inv_sigma2: torch.Tensor, valid: torch.Tensor,
                      cam: cameras.CameraParams, iters: int = 10,
                      rounds: int = 4) -> PoseOptResult:
    """X_w [M, 3] world points, uv [M, 2] observations, inv_sigma2 [M]
    per-level information weights, valid [M] observation mask. The plain
    twin on the CPU, one kernel launch on the card."""
    if X_w.device.type == "cpu":
        return pose_optimization_plain(T_cw0, X_w, uv, inv_sigma2, valid,
                                       cam, iters, rounds)
    R, t, inlier, n = _pose_gn(T_cw0.R, T_cw0.t, X_w, uv, inv_sigma2, valid,
                               cam, iters, rounds)
    return PoseOptResult(SE3(R, t), inlier, n)


def _pose_gn(R0, t0, X_w, uv, inv_sigma2, valid, cam: cameras.CameraParams,
             iters: int, rounds: int):
    """(R, t, inlier, n_inliers) of one ``csrc/pose_gn.cu`` launch: a solve
    for each index of the inputs' leading batch (none, or F)."""
    dev = X_w.device
    if dev.type != "cuda":
        raise ValueError(f"pose_optimization: unsupported device {dev}")
    lead = tuple(X_w.shape[:-2])
    nb = len(lead)
    for x, name, dtype, nd in (
            (R0, "T_cw0.R", torch.float32, nb + 2),
            (t0, "T_cw0.t", torch.float32, nb + 1),
            (X_w, "X_w", torch.float32, nb + 2),
            (uv, "uv", torch.float32, nb + 2),
            (inv_sigma2, "inv_sigma2", torch.float32, nb + 1),
            (valid, "valid", torch.bool, nb + 1)):
        native.require(x, name, dtype, nd, dev)
    M = X_w.shape[-2]
    if (nb > 1 or R0.shape != (*lead, 3, 3) or t0.shape != (*lead, 3)
            or X_w.shape != (*lead, M, 3) or uv.shape != (*lead, M, 2)
            or inv_sigma2.shape != (*lead, M) or valid.shape != (*lead, M)):
        raise ValueError("pose_optimization: expected R [.., 3, 3], "
                         "t [.., 3], X_w [.., M, 3], uv [.., M, 2], "
                         "inv_sigma2 and valid [.., M] with one leading "
                         "batch at most")
    if cam.kind not in (cameras.PINHOLE, cameras.FISHEYE_KB8):
        raise ValueError(f"unknown camera kind {cam.kind}")
    R = torch.empty((*lead, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    inlier = torch.empty((*lead, M), dtype=torch.bool, device=dev)
    n = torch.empty(lead, dtype=torch.int64, device=dev)
    F = lead[0] if lead else 1
    if F == 0:
        return R, t, inlier, n
    rc = native.lib().slam_pose_gn(
        R0.data_ptr(), t0.data_ptr(), X_w.data_ptr(), uv.data_ptr(),
        inv_sigma2.data_ptr(), valid.data_ptr(), F, M, cam.kind,
        native.float_array((cam.fx, cam.fy, cam.cx, cam.cy, *cam.dist)),
        iters, rounds, R.data_ptr(), t.data_ptr(), inlier.data_ptr(),
        n.data_ptr(), native.stream_ptr(X_w))
    native.check(rc, "pose_gn")
    native.launches.bump("pose_gn")
    return R, t, inlier, n


def pose_optimization_plain(T_cw0: SE3, X_w: torch.Tensor, uv: torch.Tensor,
                            inv_sigma2: torch.Tensor, valid: torch.Tensor,
                            cam: cameras.CameraParams, iters: int = 10,
                            rounds: int = 4) -> PoseOptResult:
    """The plain twin of ``csrc/pose_gn.cu``, on any device: the CPU's
    path, and the reference that the tests hold the kernel to."""
    delta2 = reproj.CHI2_MONO
    tol = 1e-8   # on ||dx||^2, i.e. ||dx|| ~ 1e-4
    dev = X_w.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    T = T_cw0
    inlier = torch.ones(X_w.shape[0], dtype=torch.bool, device=dev)
    for _ in range(rounds):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            r, J, depth_ok = reproj.residual_pose(T, X_w, uv, cam)
            w_info = inv_sigma2 * (valid & inlier & depth_ok)
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = w_info * reproj.huber_weight(chi2, delta2)
            H = torch.einsum("mki,m,mkj->ij", J, w, J)
            b = torch.einsum("mki,m,mk->i", J, w, r)
            H = H + 1e-5 * eye6 * torch.clamp(torch.trace(H) / 6.0, min=1.0)
            dx = torch.linalg.solve_ex(H, b)[0]
            T_new = se3.exp(dx).compose(T)
            T = SE3(torch.where(done, T.R, T_new.R),
                    torch.where(done, T.t, T_new.t))
            # the JAX loop stops once ||dx||^2 <= tol (or is NaN)
            done = done | ~(torch.sum(dx * dx) > tol)
        r, _, depth_ok = reproj.residual_pose(T, X_w, uv, cam)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        inlier = (chi2 <= delta2) & depth_ok & valid
    return PoseOptResult(T.normalized(), inlier,
                         torch.sum(inlier.to(torch.int32)))


def pose_optimization_batch(T_cw0: SE3, X_w: torch.Tensor, uv: torch.Tensor,
                            inv_sigma2: torch.Tensor, valid: torch.Tensor,
                            cam: cameras.CameraParams, iters: int = 10,
                            rounds: int = 4) -> PoseOptResult:
    """``pose_optimization`` over a leading batch of F frames, each frame
    its own solve. T_cw0: R [F, 3, 3], t [F, 3]; X_w [F, M, 3], uv [F, M,
    2], inv_sigma2 [F, M], valid [F, M]. The result has the leading F. On
    the card one launch of F blocks; on the CPU the twin under
    ``torch.func.vmap`` (every frame's done flag is its own)."""
    if X_w.device.type != "cpu":
        R, t, inlier, n = _pose_gn(T_cw0.R, T_cw0.t, X_w, uv, inv_sigma2,
                                   valid, cam, iters, rounds)
        return PoseOptResult(SE3(R, t), inlier, n)

    def one(R, t, X, u, w, v):
        res = pose_optimization_plain(SE3(R, t), X, u, w, v, cam, iters,
                                      rounds)
        return res.T_cw.R, res.T_cw.t, res.inlier, res.n_inliers

    R, t, inlier, n = torch.func.vmap(one)(T_cw0.R, T_cw0.t, X_w, uv,
                                           inv_sigma2, valid)
    return PoseOptResult(SE3(R, t), inlier, n)


class PoseInertialResult(NamedTuple):
    T_cw: SE3
    v_w: torch.Tensor        # [3] optimised world velocity
    inlier: torch.Tensor     # [M] bool
    n_inliers: torch.Tensor


class PriorPoseImu(NamedTuple):
    """Marginalisation prior on one frame's 15-dof nav state (reference:
    ConstraintPoseImu / EdgePriorPoseImu, src/G2oTypes.h:820, .cc:851):
    mean (R_wb, p, v, bg, ba), information H [15, 15] in the tangent order
    [phi, dp, dv, dbg, dba]."""
    R_wb: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    H: torch.Tensor


class PoseInertialLFResult(NamedTuple):
    T_cw: SE3
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inlier: torch.Tensor
    n_inliers: torch.Tensor
    prior: PriorPoseImu      # the prior on THIS frame, for the next one


def _body_of(T_cw: SE3, R_cb, t_cb):
    """Body state (R_wb, p_wb) of a camera pose: R_bw = R_cb^T R_cw."""
    R_wb = (R_cb.T @ T_cw.R).T
    return R_wb, T_cw.R.T @ (t_cb - T_cw.t)


def _camera_of(R_wb, p_w, R_cb, t_cb) -> SE3:
    R_cw = R_cb @ R_wb.T
    return SE3(R_cw, t_cb - R_cw @ p_w)


def _visual(R_wb, p_w, X_w, uv, cam, R_cb, t_cb):
    """r = proj(x_c) - uv [M, 2], its Jacobian [M, 2, 6] in (dphi, dp)
    for R <- R Exp(dphi), p <- p + dp, and the depth gate."""
    x_b = (X_w - p_w) @ R_wb                   # rows of R^T (X - p)
    x_c = x_b @ R_cb.T + t_cb
    r = cameras.project(cam, x_c) - uv
    JR = reproj._point_jac(cameras.project_jac(cam, x_c), R_cb)
    J = torch.cat([reproj._point_jac(JR, so3.hat(x_b)),
                   -reproj._point_jac(JR, R_wb.T)], dim=-1)
    return r, J, x_c[:, 2] > 0.05


def _chi2_weights(r, inv_sigma2, mask):
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    return (chi2, inv_sigma2 * reproj.huber_weight(chi2, reproj.CHI2_MONO)
            * mask)


def _solve64(H, g, n: int):
    """-(H + 1e-5 I max(tr H / n, 1))^-1 g in float64, rounded to float32."""
    eye = torch.eye(n, dtype=torch.float64, device=H.device)
    H = H + 1e-5 * eye * torch.clamp(torch.trace(H) / n, min=1.0)
    return (-torch.linalg.solve_ex(H, g)[0]).to(torch.float32)


def _cholesky_upper(A: torch.Tensor, jitter: float) -> torch.Tensor:
    """L^T of A + jitter I = L L^T: whitens a residual r as L^T r. The
    factorisation's error check reads its status on the host: a host
    sync."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    with timing.span("host sync"):
        L = torch.linalg.cholesky(A + jitter * eye)
    return L.transpose(-1, -2)


def _extrinsic(R_cb, t_cb, like: torch.Tensor):
    if R_cb is None:
        R_cb = torch.eye(3, dtype=like.dtype, device=like.device)
    if t_cb is None:
        t_cb = torch.zeros(3, dtype=like.dtype, device=like.device)
    return R_cb, t_cb


def pose_inertial_optimization(T_cw0: SE3, v0, R_wb_a, p_a, v_a, bg, ba, pre,
                               X_w, uv, inv_sigma2, valid,
                               cam: cameras.CameraParams, gravity,
                               R_cb=None, t_cb=None, iters: int = 8,
                               rounds: int = 2) -> PoseInertialResult:
    """The frame's nav state (pose + velocity) against its matches and one
    preintegrated edge to a fixed anchor state (reference:
    Optimizer::PoseInertialOptimizationLastKeyFrame, Optimizer.cc:416).
    Biases stay at the anchor's, as in the JAX code."""
    R_cb, t_cb = _extrinsic(R_cb, t_cb, X_w)
    dev = X_w.device
    R, p = _body_of(T_cw0, R_cb, t_cb)
    v = v0
    LT9 = _cholesky_upper(factors.information_9(pre), 1e-6)
    inlier = torch.ones(X_w.shape[0], dtype=torch.bool, device=dev)
    for _ in range(rounds):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            r_uv, J6, depth_ok = _visual(R, p, X_w, uv, cam, R_cb, t_cb)
            r_i, _, J_j, _, _ = factors.inertial_jacobians(
                R_wb_a, p_a, v_a, R, p, v, bg, ba, pre, gravity)
            r_i, J_i = LT9 @ r_i, LT9 @ J_j
            _, w = _chi2_weights(r_uv, inv_sigma2, valid & inlier & depth_ok)
            J6d, wd = J6.double(), w.double()
            Jd = J_i.double()
            H = torch.zeros((9, 9), dtype=torch.float64, device=dev)
            H[0:6, 0:6] = torch.einsum("mki,m,mkj->ij", J6d, wd, J6d)
            H = H + Jd.T @ Jd
            g = torch.zeros(9, dtype=torch.float64, device=dev)
            g[0:6] = torch.einsum("mki,m,mk->i", J6d, wd, r_uv.double())
            g = g + Jd.T @ r_i.double()
            dx = _solve64(H, g, 9)
            R_n = R @ so3.exp(dx[0:3])
            R = torch.where(done, R, R_n)
            p = torch.where(done, p, p + dx[3:6])
            v = torch.where(done, v, v + dx[6:9])
            done = done | ~(torch.sum(dx * dx) > 1e-8)
        r_uv, _, depth_ok = _visual(R, p, X_w, uv, cam, R_cb, t_cb)
        chi2 = torch.sum(r_uv * r_uv, dim=-1) * inv_sigma2
        inlier = (chi2 <= reproj.CHI2_MONO) & depth_ok & valid
    R = so3.normalize(R)
    return PoseInertialResult(_camera_of(R, p, R_cb, t_cb), v, inlier,
                              torch.sum(inlier.to(torch.int32)))


def _prior_residual(R, p, v, bg, ba, prior: PriorPoseImu):
    return torch.cat([so3.log(prior.R_wb.T @ R), p - prior.p, v - prior.v,
                      bg - prior.bg, ba - prior.ba], dim=-1)


def pose_inertial_optimization_last_frame(
        T_cw0: SE3, v0, prior: PriorPoseImu, pre, X_w, uv, inv_sigma2,
        valid, cam: cameras.CameraParams, gravity, R_cb=None, t_cb=None,
        iters: int = 8, rounds: int = 2) -> PoseInertialLFResult:
    """The current frame jointly with the last frame's 15-dof state under
    the running marginalisation prior, then the Schur marginalisation of
    the last frame into the next prior (reference:
    Optimizer::PoseInertialOptimizationLastFrame + Marginalize,
    src/Optimizer.cc:983 / 1644). State order: last frame (phi, p, v, bg,
    ba), then the current frame's."""
    R_cb, t_cb = _extrinsic(R_cb, t_cb, X_w)
    dev = X_w.device
    R2, p2 = _body_of(T_cw0, R_cb, t_cb)
    LT9 = _cholesky_upper(factors.information_9(pre), 1e-6)
    LT6 = _cholesky_upper(factors.bias_walk_information(pre), 1e-6)
    Hp = 0.5 * (prior.H + prior.H.T)
    LTp = _cholesky_upper(Hp, 1e-4)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def unpack(x, b):
        return (b[0] @ so3.exp(x[..., 0:3]), b[1] + x[..., 3:6],
                b[2] + x[..., 6:9], b[3] + x[..., 9:12], b[4] + x[..., 12:15],
                b[5] @ so3.exp(x[..., 15:18]), b[6] + x[..., 18:21],
                b[7] + x[..., 21:24], b[8] + x[..., 24:27],
                b[9] + x[..., 27:30])

    def rest(b):
        """The whitened inertial, bias-walk and prior rows [30] at the
        base b, and their Jacobian [30, 30] (state order: the last frame's
        phi, p, v, bg, ba, then the current frame's)."""
        R1, p1, v1, bg1, ba1, R2, p2, v2, bg2, ba2 = b
        r_i, J_i, J_j, J_bg, J_ba = factors.inertial_jacobians(
            R1, p1, v1, R2, p2, v2, bg1, ba1, pre, gravity)
        z96 = torch.zeros((9, 6), dtype=r_i.dtype, device=dev)
        J_ri = torch.cat([J_i, J_bg, J_ba, J_j, z96], -1)
        z69 = torch.zeros((6, 9), dtype=r_i.dtype, device=dev)
        J_bw = torch.cat([z69, -eye6, z69, eye6], -1)
        r_pr = _prior_residual(R1, p1, v1, bg1, ba1, prior)
        J_pr = torch.block_diag(so3.inv_right_jacobian(r_pr[0:3]), eye3,
                                eye3, eye3, eye3)
        J_pr = torch.cat([J_pr, torch.zeros_like(J_pr)], -1)
        r = torch.cat([LT9 @ r_i,
                       LT6 @ factors.bias_walk_residual(bg1, ba1, bg2, ba2),
                       LTp @ r_pr])
        return r, torch.cat([LT9 @ J_ri, LT6 @ J_bw, LTp @ J_pr], 0)

    def normal_eqs(b, inlier):
        """(H, g) of the 30-dof system at the base b, in float64."""
        r_uv, J6, depth_ok = _visual(b[5], b[6], X_w, uv, cam, R_cb, t_cb)
        r_c, J_c = rest(b)
        _, w = _chi2_weights(r_uv, inv_sigma2, valid & inlier & depth_ok)
        J6d, wd, Jc = J6.double(), w.double(), J_c.double()
        H = Jc.T @ Jc
        H[15:21, 15:21] += torch.einsum("mki,m,mkj->ij", J6d, wd, J6d)
        g = Jc.T @ r_c.double()
        g[15:21] += torch.einsum("mki,m,mk->i", J6d, wd, r_uv.double())
        return H, g

    b = (prior.R_wb, prior.p, prior.v, prior.bg, prior.ba,
         R2, p2, v0, prior.bg, prior.ba)
    inlier = torch.ones(X_w.shape[0], dtype=torch.bool, device=dev)
    for _ in range(rounds):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            H, g = normal_eqs(b, inlier)
            dx = _solve64(H, g, 30)
            nb = unpack(dx, b)
            b = tuple(torch.where(done, o, n) for o, n in zip(b, nb))
            done = done | ~(torch.sum(dx * dx) > 1e-8)
        r_uv, _, depth_ok = _visual(b[5], b[6], X_w, uv, cam, R_cb, t_cb)
        chi2 = torch.sum(r_uv * r_uv, dim=-1) * inv_sigma2
        inlier = (chi2 <= reproj.CHI2_MONO) & depth_ok & valid

    # Schur-marginalise the older frame: the next frame's prior
    # (reference: Optimizer::Marginalize, src/Optimizer.cc:1644)
    H, _ = normal_eqs(b, inlier)
    eye15 = torch.eye(15, dtype=torch.float64, device=dev)
    H11 = H[0:15, 0:15] + 1e-4 * eye15
    with timing.span("host sync"):      # the solve's error check
        H11_inv_H12 = torch.linalg.solve(H11, H[0:15, 15:30])
    Hm = H[15:30, 15:30] - H[15:30, 0:15] @ H11_inv_H12
    Hm = (0.5 * (Hm + Hm.T)).to(torch.float32)
    R2 = so3.normalize(b[5])
    p2, v2, bg2, ba2 = b[6], b[7], b[8], b[9]
    return PoseInertialLFResult(
        _camera_of(R2, p2, R_cb, t_cb), v2, bg2, ba2, inlier,
        torch.sum(inlier.to(torch.int32)),
        PriorPoseImu(R2, p2, v2, bg2, ba2, Hm))


def build_frame_prior(T_cw: SE3, v_w, bg, ba, R_wb_a, p_a, v_a, pre, X_w, uv,
                      inv_sigma2, inlier, cam: cameras.CameraParams, gravity,
                      R_cb=None, t_cb=None) -> PriorPoseImu:
    """Seed the marginalisation prior after an anchored optimisation: the
    15x15 information of the frame from its visual edges and the inertial
    edge to the fixed anchor at the solution, with the window's random-walk
    information on the bias block (reference: the mpcpi construction after
    PoseInertialOptimizationLastKeyFrame, src/Optimizer.cc:945-980)."""
    R_cb, t_cb = _extrinsic(R_cb, t_cb, X_w)
    dev = X_w.device
    R_wb, p_w = _body_of(T_cw, R_cb, t_cb)
    r_uv, J6, _ = _visual(R_wb, p_w, X_w, uv, cam, R_cb, t_cb)
    _, w = _chi2_weights(r_uv, inv_sigma2, inlier)
    _, _, J_j, _, _ = factors.inertial_jacobians(R_wb_a, p_a, v_a, R_wb, p_w,
                                                 v_w, bg, ba, pre, gravity)
    J6d, wd, Jd = J6.double(), w.double(), J_j.double()
    H = torch.zeros((15, 15), dtype=torch.float64, device=dev)
    H[0:9, 0:9] = Jd.T @ factors.information_9(pre).double() @ Jd
    H[0:6, 0:6] += torch.einsum("mki,m,mkj->ij", J6d, wd, J6d)
    H[9:15, 9:15] = factors.bias_walk_information(pre).double()
    return PriorPoseImu(R_wb, p_w, v_w, bg, ba, H.to(torch.float32))
