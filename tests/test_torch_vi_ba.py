"""The port's visual-inertial optimisers against the JAX package's: the
inertial pose optimisers of ``optim/pose_opt.py`` (the anchored one, the
last-frame one with its Schur marginalisation, ``build_frame_prior``) and
``optim/vi_ba.vi_ba_solve``, on ``tests/test_vi_ba.py``'s problems.

Tolerances: the optimised poses, velocities and biases within 1e-3 (the
port sums and solves the normal equations in float64, JAX in float32), the
inlier counts equal, the priors' information within 1e-3 relative to its
largest entry; ``vi_ba_solve``'s states within 1e-3, its points within
1e-3 and its cost within 1e-4 relative. The written-out visual Jacobian of
the pose optimisers equals ``torch.func.jacfwd`` of the same residual
within 1e-3 (pixels per unit perturbation, entries of order 1e2).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu.lie import so3 as jso3
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.optim import pose_opt as jpo
from orb_slam3_detailed_comments_tpu.optim import vi_ba as jvi
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.lie import SE3, so3
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.optim import pose_opt, vi_ba

from synthetic import CAM as JCAM
from test_imu import CAL, simulate_imu
from test_vi_ba import build_vi_problem

torch.set_num_threads(2)

CAM = cameras.pinhole(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width,
                      JCAM.height)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pre(P):
    return tpre.Preintegrated(*[T(x) for x in P])


def _frame_problem(rng, n_pts=200, noise=0.4):
    """test_vi_ba.py's motion-only problem: an exact IMU edge from the
    anchor, noisy projections, a perturbed start."""
    from orb_slam3_detailed_comments_tpu.imu import preintegration as jpre
    sim = simulate_imu(rng, n=20, dt=0.005)
    P = jpre.integrate(jnp.asarray(sim["acc"]), jnp.asarray(sim["gyro"]),
                       jnp.asarray(sim["dt"]), CAL)
    R_j, p_j = sim["R"][-1], sim["p"][-1]
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(4, 9, n_pts)], 1).astype(np.float32)
    xc = (pts - p_j) @ R_j
    uv = np.asarray(jcam.project(JCAM, jnp.asarray(xc))).copy()
    uv += rng.normal(0, noise, uv.shape)
    valid = (xc[:, 2] > 0.5) & np.asarray(
        jcam.in_image(JCAM, jnp.asarray(uv)))
    R0 = R_j @ np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.02, 3),
                                               jnp.float32)))
    p0 = p_j + rng.normal(0, 0.05, 3)
    v0 = sim["v"][-1] + rng.normal(0, 0.2, 3)
    Rc, tc = R0.T.astype(np.float32), (-R0.T @ p0).astype(np.float32)
    return dict(sim=sim, P=P, pts=pts, uv=uv.astype(np.float32), valid=valid,
                Rc=Rc, tc=tc, v0=v0.astype(np.float32),
                g=sim["g"].astype(np.float32))


def _assert_pose_close(jr, tr, tol=1e-3):
    np.testing.assert_allclose(tr.T_cw.R.numpy(), np.asarray(jr.T_cw.R),
                               atol=tol)
    np.testing.assert_allclose(tr.T_cw.t.numpy(), np.asarray(jr.T_cw.t),
                               atol=tol)
    np.testing.assert_allclose(tr.v_w.numpy(), np.asarray(jr.v_w), atol=tol)
    assert int(tr.n_inliers) == int(jr.n_inliers)


def test_pose_inertial_optimization_and_prior_match_jax(rng):
    d = _frame_problem(rng)
    sim, n = d["sim"], len(d["pts"])
    a = [sim["R"][0], sim["p"][0], sim["v"][0]]
    jr = jpo.pose_inertial_optimization(
        JSE3(jnp.asarray(d["Rc"]), jnp.asarray(d["tc"])),
        jnp.asarray(d["v0"]), *(jnp.asarray(x, jnp.float32) for x in a),
        jnp.zeros(3), jnp.zeros(3), d["P"], jnp.asarray(d["pts"]),
        jnp.asarray(d["uv"]), jnp.ones(n, jnp.float32),
        jnp.asarray(d["valid"]), JCAM, gravity=jnp.asarray(d["g"]))
    tr = pose_opt.pose_inertial_optimization(
        SE3(T(d["Rc"]), T(d["tc"])), T(d["v0"]), *(T(x) for x in a),
        torch.zeros(3), torch.zeros(3), _pre(d["P"]), T(d["pts"]),
        T(d["uv"]), torch.ones(n), torch.from_numpy(d["valid"]), CAM,
        T(d["g"]))
    _assert_pose_close(jr, tr)
    # test_vi_ba.py's gates on the port
    R_est = tr.T_cw.R.numpy().T
    p_est = -R_est @ tr.T_cw.t.numpy()
    assert np.linalg.norm(p_est - sim["p"][-1]) < 5e-3
    assert np.linalg.norm(tr.v_w.numpy() - sim["v"][-1]) < 0.05
    assert int(tr.n_inliers) > 0.8 * d["valid"].sum()

    pj = jpo.build_frame_prior(
        jr.T_cw, jr.v_w, jnp.zeros(3), jnp.zeros(3),
        *(jnp.asarray(x, jnp.float32) for x in a), d["P"],
        jnp.asarray(d["pts"]), jnp.asarray(d["uv"]),
        jnp.ones(n, jnp.float32), jr.inlier, JCAM, jnp.asarray(d["g"]))
    pt = pose_opt.build_frame_prior(
        SE3(T(jr.T_cw.R), T(jr.T_cw.t)), T(jr.v_w), torch.zeros(3),
        torch.zeros(3), *(T(x) for x in a), _pre(d["P"]), T(d["pts"]),
        T(d["uv"]), torch.ones(n), torch.from_numpy(np.asarray(jr.inlier)),
        CAM, T(d["g"]))
    Hj = np.asarray(pj.H)
    assert np.abs(pt.H.numpy() - Hj).max() < 1e-3 * np.abs(Hj).max()
    for f in ("R_wb", "p", "v"):
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)), atol=1e-5)


@pytest.mark.parametrize("strong", [True, False])
def test_pose_inertial_last_frame_matches_jax(rng, strong):
    """test_vi_ba.py's two last-frame cases (a strong prior pinning the last
    frame, a weak one): the joint 30-dof solve and the marginal prior."""
    d = _frame_problem(rng, n_pts=200 if strong else 300,
                       noise=0.4 if strong else 0.3)
    sim, n = d["sim"], len(d["pts"])
    H = (np.diag(np.concatenate([np.full(9, 1e6), np.full(6, 1e4)]))
         if strong else 1e2 * np.eye(15)).astype(np.float32)
    a = [sim["R"][0], sim["p"][0], sim["v"][0]]
    prj = jpo.PriorPoseImu(*(jnp.asarray(x, jnp.float32) for x in a),
                           jnp.zeros(3), jnp.zeros(3), jnp.asarray(H))
    prt = pose_opt.PriorPoseImu(*(T(x) for x in a), torch.zeros(3),
                                torch.zeros(3), T(H))
    jr = jpo.pose_inertial_optimization_last_frame(
        JSE3(jnp.asarray(d["Rc"]), jnp.asarray(d["tc"])),
        jnp.asarray(d["v0"]), prj, d["P"], jnp.asarray(d["pts"]),
        jnp.asarray(d["uv"]), jnp.ones(n, jnp.float32),
        jnp.asarray(d["valid"]), JCAM, gravity=jnp.asarray(d["g"]))
    tr = pose_opt.pose_inertial_optimization_last_frame(
        SE3(T(d["Rc"]), T(d["tc"])), T(d["v0"]), prt, _pre(d["P"]),
        T(d["pts"]), T(d["uv"]), torch.ones(n), torch.from_numpy(d["valid"]),
        CAM, T(d["g"]))
    _assert_pose_close(jr, tr)
    np.testing.assert_allclose(tr.bg.numpy(), np.asarray(jr.bg), atol=1e-4)
    np.testing.assert_allclose(tr.ba.numpy(), np.asarray(jr.ba), atol=1e-3)
    Hj = np.asarray(jr.prior.H)
    assert np.abs(tr.prior.H.numpy() - Hj).max() < 1e-3 * np.abs(Hj).max()
    R_est = tr.T_cw.R.numpy().T
    p_est = -R_est @ tr.T_cw.t.numpy()
    assert np.linalg.norm(p_est - sim["p"][-1]) < (5e-3 if strong else 1e-2)
    np.testing.assert_allclose(tr.prior.p.numpy(), p_est, atol=1e-5)


def test_visual_jacobian_is_the_forward_derivative(rng):
    """The pose optimisers' written-out visual rows equal torch.func.jacfwd
    of the same residual in (dphi, dp) for R <- R Exp(dphi), p <- p + dp,
    with a camera <- body extrinsic."""
    R = so3.exp(T(rng.normal(0, 0.2, 3)))
    p = T(rng.normal(0, 0.3, 3))
    R_cb = so3.exp(T(rng.normal(0, 0.1, 3)))
    t_cb = T([0.05, -0.02, 0.03])
    X = T(np.stack([rng.uniform(-3, 3, 64), rng.uniform(-2, 2, 64),
                    rng.uniform(4, 8, 64)], 1))
    uv = cameras.project(CAM, (X - p) @ R @ R_cb.T + t_cb) + 1.0

    def res(x):
        x_b = (X - (p + x[..., 3:6])[..., None, :]) @ (
            R @ so3.exp(x[..., 0:3]))
        return cameras.project(CAM, x_b @ R_cb.T + t_cb) - uv

    r, J, _ = pose_opt._visual(R, p, X, uv, CAM, R_cb, t_cb)
    z = torch.zeros((1, 6))
    J_ref = torch.func.jacfwd(res)(z)[0, :, :, 0, :]
    np.testing.assert_allclose(r.numpy(), res(z)[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(J.numpy(), J_ref.numpy(), atol=1e-3)


def _as_torch(prob):
    f = {}
    for name in prob._fields:
        v = getattr(prob, name)
        f[name] = (tpre.Preintegrated(*[torch.from_numpy(np.array(x))
                                        for x in v])
                   if name == "edge_pre" else torch.from_numpy(np.array(v)))
    return vi_ba.VIBAProblem(**f)


@pytest.mark.parametrize("n_pts,vel_noise", [(150, 0.1), (40, 0.3)])
def test_vi_ba_solve_matches_jax(rng, n_pts, vel_noise):
    """test_vi_ba.py's TestVIBA problems: the same states from both
    packages, and that file's gates on the port."""
    prob, truth = build_vi_problem(rng, n_pts=n_pts, vel_noise=vel_noise)
    g = truth["g"].astype(np.float32)
    rj = jvi.vi_ba_solve(prob, JCAM, jnp.eye(3), jnp.zeros(3),
                         gravity=jnp.asarray(g), prior_gyro=1.0,
                         prior_acc=1e4, iters=12)
    rt = vi_ba.vi_ba_solve(_as_torch(prob), CAM, torch.eye(3),
                           torch.zeros(3), T(g), prior_gyro=1.0,
                           prior_acc=1e4, iters=12)
    for f in ("R_wb", "p_w", "v_w", "bg", "ba", "points"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), atol=1e-3)
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * float(rj.cost)
    np.testing.assert_array_equal(rt.obs_inlier.numpy(),
                                  np.asarray(rj.obs_inlier))
    p_err = np.linalg.norm(rt.p_w.numpy() - truth["p"], axis=1)
    if n_pts == 150:
        assert p_err.max() < 0.02
        v_err = np.linalg.norm(rt.v_w.numpy() - truth["v"], axis=1)
        assert np.median(v_err) < 0.05
        assert np.abs(rt.bg.numpy() - truth["bg"]).max() < 2e-3
    else:
        assert np.isfinite(rt.p_w.numpy()).all() and p_err.max() < 0.08
