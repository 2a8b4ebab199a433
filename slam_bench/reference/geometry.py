"""Plain pose optimisation and local bundle adjustment: the solves that the
benchmark holds the port's against, from the same inputs.

Both follow ORB-SLAM3 (Optimizer::PoseOptimization and
LocalBundleAdjustment) as the port at commit d23e9c2 schedules them, so
that a sound solve and this one end at the same state:

* ``pose_gn``: 4 rounds of 10 Gauss-Newton iterations with a Huber kernel
  (delta^2 = 5.991) on the left-multiplied twist (rho, phi), damping 1e-5
  of the mean diagonal, a round frozen once a step's squared norm is at
  most 1e-8, the observations re-classified at the chi2 gate after each
  round;
* ``local_ba``: Levenberg-Marquardt over the cameras and points with the
  points eliminated by the Schur complement, trace-scaled damping (1e-4,
  halved on an accepted step, times 4 on a rejected one), 3 iterations
  with the Huber kernel, the observations above twice the gate dropped,
  7 more, then the chi2 gate in observation order.

The observations are undistorted keypoints and the projection is the
ideal pinhole of the camera's intrinsics (ORB-SLAM3's Pinhole::project on
mvKeysUn). Everything is computed in ``dtype`` (float64 for the reference);
the points are moved into the camera frames by matrix products (a pose's
points at once; a bundle adjustment's points into all its cameras at
once), so that a lower matrix-product precision (TF32) reaches every
residual.
"""
from __future__ import annotations

import torch

CHI2_MONO = 5.991


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """Twist [..., 6] = (rho, phi) -> (R, t), t = Jl(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(phi * phi, -1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    st = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1 - th2 / 6, torch.sin(st) / st)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(st)) / torch.where(
        small, torch.ones_like(th2), th2))
    C = torch.where(small, 1 / 6 - th2 / 120, (st - torch.sin(st)) / torch.where(
        small, torch.ones_like(th2), th2 * st))
    W = hat(phi)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    WW = W @ W
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    J = I + B[..., None, None] * W + C[..., None, None] * WW
    return R, (J @ rho[..., None])[..., 0]


def project(cam: dict, pc):
    """Ideal pinhole: [..., 3] camera-frame points -> [..., 2] pixels."""
    z = pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return torch.stack([cam["fx"] * pc[..., 0] / z + cam["cx"],
                        cam["fy"] * pc[..., 1] / z + cam["cy"]], -1)


def _proj_jac(cam: dict, pc):
    """d project / d pc: [..., 2, 3]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([cam["fx"] * iz, zero, -cam["fx"] * x * iz * iz], -1),
        torch.stack([zero, cam["fy"] * iz, -cam["fy"] * y * iz * iz], -1)], -2)


def _twist_jac(Jp, pc):
    """d proj / d twist for T <- exp(delta) T: Jp [I | -hat(pc)]."""
    return torch.cat([Jp, -Jp @ hat(pc)], -1)


def transform(R, t, X):
    """R X + t over rows, as one matrix product a pose (or a batch)."""
    return (X[..., None, :] @ R.transpose(-1, -2))[..., 0, :] + t


def huber_weight(chi2, delta2):
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def pose_gn(R0, t0, X, uv, w_level, valid, cam: dict, dtype=torch.float64,
            iters: int = 10, rounds: int = 4, delta2: float = CHI2_MONO):
    """(R [3, 3], t [3], inlier [M]) of a frame's pose from its matched
    points X [M, 3] and keypoints uv [M, 2] (information w_level [M],
    observation mask valid [M]), starting from (R0, t0)."""
    R, t = R0.to(dtype), t0.to(dtype)
    X, uv, w_level = X.to(dtype), uv.to(dtype), w_level.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=X.device)
    inlier = torch.ones_like(valid)
    for _ in range(rounds):
        done = False
        for _ in range(iters):
            if done:
                break
            pc = transform(R, t, X)
            r = uv - project(cam, pc)
            J = _twist_jac(_proj_jac(cam, pc), pc)
            ok = valid & inlier & (pc[:, 2] > 0.05)
            chi2 = torch.sum(r * r, -1) * w_level
            w = w_level * ok * huber_weight(chi2, delta2)
            Jw = J * w[:, None, None]
            H = torch.einsum("mki,mkj->ij", Jw, J)
            b = torch.einsum("mki,mk->i", Jw, r)
            H = H + 1e-5 * eye6 * torch.clamp(torch.trace(H) / 6.0, min=1.0)
            dx = torch.linalg.solve(H, b)
            Rd, td = se3_exp(dx)
            R, t = Rd @ R, (Rd @ t[:, None])[:, 0] + td
            done = not bool(torch.sum(dx * dx) > 1e-8)
        pc = transform(R, t, X)
        r = uv - project(cam, pc)
        chi2 = torch.sum(r * r, -1) * w_level
        inlier = (chi2 <= delta2) & (pc[:, 2] > 0.05) & valid
    return R, t, inlier


def local_ba(prob: dict, cam: dict, dtype=torch.float64, iters: int = 10,
             delta2: float = CHI2_MONO, lam0: float = 1e-4):
    """(kf_R [C, 3, 3], kf_t [C, 3], points [P, 3], inlier [O]) of a
    bundle adjustment problem (the fields of the port's BAProblem:
    kf_R, kf_t, points, obs_cam, obs_pt, obs_uv, obs_w, obs_valid,
    fixed_cam, point_valid)."""
    dev = prob["points"].device
    R, t = prob["kf_R"].to(dtype), prob["kf_t"].to(dtype)
    X = prob["points"].to(dtype)
    oc, op = prob["obs_cam"].long(), prob["obs_pt"].long()
    uv, w0 = prob["obs_uv"].to(dtype), prob["obs_w"].to(dtype)
    w0 = torch.where(prob["obs_valid"], w0, torch.zeros_like(w0))
    fixed, pvalid = prob["fixed_cam"], prob["point_valid"]
    C, P = R.shape[0], X.shape[0]

    def residuals(R, t, X):
        # every point into every camera's frame as one product [P, 3C],
        # then each observation's pair
        pc_all = (X @ R.reshape(C * 3, 3).T).reshape(P, C, 3) + t
        pc = pc_all[op, oc]
        return uv - project(cam, pc), pc

    def cost(R, t, X, w):
        r, pc = residuals(R, t, X)
        chi2 = torch.sum(r * r, -1) * w
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0))
                          - delta2)
        return torch.sum(torch.where((w > 0) & (pc[:, 2] > 0.05), rho,
                                     torch.zeros_like(rho)))

    def step(R, t, X, w, lam):
        r, pc = residuals(R, t, X)
        Jp = _proj_jac(cam, pc)
        Jc = _twist_jac(Jp, pc)
        Jx = Jp @ R[oc]
        chi2 = torch.sum(r * r, -1) * w
        wk = w * huber_weight(chi2, delta2) * (pc[:, 2] > 0.05)
        Jcw, Jxw = Jc * wk[:, None, None], Jx * wk[:, None, None]
        U = torch.zeros(C, 6, 6, dtype=dtype, device=dev).index_add_(
            0, oc, Jcw.transpose(1, 2) @ Jc)
        bc = torch.zeros(C, 6, dtype=dtype, device=dev).index_add_(
            0, oc, torch.einsum("oki,ok->oi", Jcw, r))
        V = torch.zeros(P, 3, 3, dtype=dtype, device=dev).index_add_(
            0, op, Jxw.transpose(1, 2) @ Jx)
        bp = torch.zeros(P, 3, dtype=dtype, device=dev).index_add_(
            0, op, torch.einsum("oki,ok->oi", Jxw, r))
        Wd = torch.zeros(P, C, 6, 3, dtype=dtype, device=dev).index_put_(
            (op, oc), Jcw.transpose(1, 2) @ Jx, accumulate=True)
        trU = torch.clamp(torch.einsum("cii->c", U), min=1e-3)
        trV = torch.clamp(torch.einsum("pii->p", V), min=1e-3)
        Ud = U + lam * torch.eye(6, dtype=dtype, device=dev) * trU[:, None, None] / 6
        Vd = V + lam * torch.eye(3, dtype=dtype, device=dev) * trV[:, None, None] / 3
        Vinv = torch.where(pvalid[:, None, None], torch.linalg.inv(torch.where(
            pvalid[:, None, None], Vd, torch.eye(3, dtype=dtype, device=dev))),
            torch.zeros_like(Vd))
        A = Wd.reshape(P, C * 6, 3)
        Y = A @ Vinv
        S = -(Y.permute(1, 0, 2).reshape(C * 6, P * 3)
              @ A.permute(1, 0, 2).reshape(C * 6, P * 3).T)
        S = S.reshape(C, 6, C, 6)
        ar = torch.arange(C, device=dev)
        S[ar, :, ar, :] += Ud
        rhs = bc - (Y.permute(1, 0, 2).reshape(C * 6, P * 3)
                    @ bp.reshape(-1)).reshape(C, 6)
        free = (~fixed).to(dtype)
        S = S * free[:, None, None, None] * free[None, None, :, None]
        S[ar, :, ar, :] += torch.eye(6, dtype=dtype, device=dev) * fixed[
            :, None, None].to(dtype)
        rhs = rhs * free[:, None]
        Sm = S.reshape(6 * C, 6 * C)
        jitter = 1e-5 * torch.max(torch.diagonal(Sm)) + 1e-3
        dc = torch.linalg.solve(Sm + jitter * torch.eye(6 * C, dtype=dtype,
                                                         device=dev),
                                rhs.reshape(-1)).reshape(C, 6)
        dc = dc * free[:, None]
        dp = torch.einsum("pxy,py->px", Vinv,
                          bp - torch.einsum("pcix,ci->px", Wd, dc))
        dp = torch.where(pvalid[:, None], dp, torch.zeros_like(dp))
        Rd, td = se3_exp(dc)
        return Rd @ R, (Rd @ t[..., None])[..., 0] + td, X + dp

    def run(R, t, X, w, n):
        c = cost(R, t, X, w)
        lam = lam0
        for _ in range(n):
            Rn, tn, Xn = step(R, t, X, w, lam)
            cn = cost(Rn, tn, Xn, w)
            accept = bool(torch.isfinite(cn)) and bool(cn < c) and bool(
                torch.isfinite(Rn).all() and torch.isfinite(Xn).all())
            if accept:
                converged = bool(c - cn <= 1e-6 * c + 1e-6)
                R, t, X, c = Rn, tn, Xn, cn
                lam = max(lam * 0.5, 1e-7)
                if converged:
                    break
            else:
                lam = min(lam * 4.0, 1e2)
        return R, t, X

    n1 = max(iters // 3, 2)
    R, t, X = run(R, t, X, w0, n1)
    r, pc = residuals(R, t, X)
    err2 = torch.sum(r * r, -1)
    w = torch.where((pc[:, 2] > 0.05) & (err2 * w0 <= 2.0 * delta2), w0,
                    torch.zeros_like(w0))
    R, t, X = run(R, t, X, w, max(iters - n1, 1))
    r, pc = residuals(R, t, X)
    inlier = ((pc[:, 2] > 0.05) & (torch.sum(r * r, -1) * w0 <= delta2)
              & (w0 > 0) & prob["obs_valid"])
    return R, t, X, inlier
