"""The port's IMU preintegration, inertial factors and inertial-only
initialisation against the JAX package's, on the same numpy inputs.

Tolerances: the preintegrated deltas and bias Jacobians within 1e-5
relative to their largest entry, the covariance within 1e-4 relative;
``merge``, the bias-corrected getters and ``predict_state`` within 1e-5
relative; the 9-dof residual within 1e-5 and its information within 1e-4
relative; the written-out Jacobian of the residual within 1e-4 of
``torch.func.jacfwd``. The initialisation (``inertial_optimization``, solved in float64
in the port, float32 in JAX): scale within 1e-3, the gravity direction
within 1e-3 rad, the biases within 1e-4. The mirrors of
``tests/test_imu.py:48-178`` hold the port alone to that file's gates.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.imu import factors as jfac
from orb_slam3_detailed_comments_tpu.imu import inertial_init as jinit
from orb_slam3_detailed_comments_tpu.imu import preintegration as jpre
from orb_slam3_detailed_comments_tpu.pipeline import inertial as jinertial
from orb_slam3_detailed_comments_tpu_torch.imu import factors as tfac
from orb_slam3_detailed_comments_tpu_torch.imu import inertial_init as tinit
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.lie import so3
from orb_slam3_detailed_comments_tpu_torch.optim import jac
from orb_slam3_detailed_comments_tpu_torch.pipeline import inertial

from test_imu import CAL, simulate_imu

torch.set_num_threads(2)

TCAL = tpre.ImuCalib.default()


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _windows(sim, lo, hi, gyro=None):
    g = sim["gyro"] if gyro is None else gyro
    P = jpre.integrate(jnp.asarray(sim["acc"][lo:hi]), jnp.asarray(g[lo:hi]),
                       jnp.asarray(sim["dt"][lo:hi]), CAL)
    Q = tpre.integrate(T(sim["acc"][lo:hi]), T(g[lo:hi]), T(sim["dt"][lo:hi]),
                       TCAL)
    return P, Q


def _close(a, b, rel):
    a, b = np.asarray(a), b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-30), (a, b)


def _as_torch(P):
    return tpre.Preintegrated(*[T(x) for x in P])


@pytest.mark.parametrize("n,bias", [(40, False), (100, True)])
def test_preintegration_matches_jax(n, bias):
    sim = simulate_imu(np.random.default_rng(n), n=n)
    bg = np.array([0.01, -0.02, 0.015], np.float32) if bias else np.zeros(3)
    ba = np.array([0.05, 0.02, -0.04], np.float32) if bias else np.zeros(3)
    P = jpre.integrate(jnp.asarray(sim["acc"]), jnp.asarray(sim["gyro"]),
                       jnp.asarray(sim["dt"]), CAL, bg0=jnp.asarray(bg),
                       ba0=jnp.asarray(ba))
    Q = tpre.integrate(T(sim["acc"]), T(sim["gyro"]), T(sim["dt"]), TCAL,
                       bg0=T(bg), ba0=T(ba))
    for name in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        _close(getattr(P, name), getattr(Q, name), 1e-5)
    _close(P.C, Q.C, 1e-4)


def test_preintegration_gates_of_test_imu(rng):
    """test_imu.py's TestPreintegration on the port: the numerical
    integration, the bias Jacobians against finite differences, the
    covariance's growth and the merge."""
    sim = simulate_imu(rng)
    P = tpre.integrate(T(sim["acc"]), T(sim["gyro"]), T(sim["dt"]), TCAL)
    n = len(sim["acc"])
    Tn, g = n * sim["dt"][0], sim["g"]
    R0, v0, p0 = sim["R"][0], sim["v"][0], sim["p"][0]
    np.testing.assert_allclose(R0 @ P.dR.numpy(), sim["R"][-1], atol=1e-4)
    np.testing.assert_allclose(v0 + g * Tn + R0 @ P.dV.numpy(), sim["v"][-1],
                               atol=1e-3)
    np.testing.assert_allclose(p0 + v0 * Tn + 0.5 * g * Tn * Tn
                               + R0 @ P.dP.numpy(), sim["p"][-1], atol=1e-3)
    ev = np.linalg.eigvalsh(P.C.numpy()[0:9, 0:9].astype(np.float64))
    assert ev.min() > -1e-12 and np.trace(P.C.numpy()[0:9, 0:9]) > 0

    s40 = simulate_imu(rng, n=40)
    a, gy, d = T(s40["acc"]), T(s40["gyro"]), T(s40["dt"])
    P0 = tpre.integrate(a, gy, d, TCAL)
    eps = 1e-3
    for k in range(3):
        db = np.zeros(3, np.float32)
        db[k] = eps
        Pg = tpre.integrate(a, gy, d, TCAL, bg0=T(db))
        dphi = so3.log(P0.dR.T @ Pg.dR).numpy()
        np.testing.assert_allclose(dphi / eps, P0.JRg.numpy()[:, k],
                                   atol=2e-2)
        np.testing.assert_allclose((Pg.dV - P0.dV).numpy() / eps,
                                   P0.JVg.numpy()[:, k], atol=2e-2)
        Pa = tpre.integrate(a, gy, d, TCAL, ba0=T(db))
        np.testing.assert_allclose((Pa.dP - P0.dP).numpy() / eps,
                                   P0.JPa.numpy()[:, k], atol=2e-2)


def test_merge_getters_and_prediction_match_jax(rng):
    sim = simulate_imu(rng, n=80)
    Pa, Qa = _windows(sim, 0, 40)
    Pb, Qb = _windows(sim, 40, 80)
    Pm, Qm = jpre.merge(Pa, Pb), tpre.merge(Qa, Qb)
    for name in jpre.Preintegrated._fields:
        _close(getattr(Pm, name), getattr(Qm, name), 1e-5)
    Pf, _ = _windows(sim, 0, 80)
    np.testing.assert_allclose(Qm.dR.numpy(), np.asarray(Pf.dR), atol=1e-4)
    np.testing.assert_allclose(Qm.dP.numpy(), np.asarray(Pf.dP), atol=1e-3)
    bg = np.array([0.01, -0.02, 0.015], np.float32)
    ba = np.array([0.03, 0.01, -0.02], np.float32)
    _close(jpre.delta_rotation(Pf, jnp.asarray(bg)),
           tpre.delta_rotation(_as_torch(Pf), T(bg)), 1e-5)
    _close(jpre.delta_velocity(Pf, jnp.asarray(bg), jnp.asarray(ba)),
           tpre.delta_velocity(_as_torch(Pf), T(bg), T(ba)), 1e-5)
    _close(jpre.delta_position(Pf, jnp.asarray(bg), jnp.asarray(ba)),
           tpre.delta_position(_as_torch(Pf), T(bg), T(ba)), 1e-5)
    args = (sim["R"][0], sim["v"][0], sim["p"][0])
    J = jpre.predict_state(*(jnp.asarray(a, jnp.float32) for a in args), Pf,
                           jnp.asarray(bg), jnp.asarray(ba),
                           gravity=jnp.asarray(sim["g"], jnp.float32))
    Q = tpre.predict_state(*(T(a) for a in args), _as_torch(Pf), T(bg),
                           T(ba), T(sim["g"]))
    for a, b in zip(J, Q):
        _close(a, b, 1e-5)


def test_long_frame_window_is_chunked_as_jax(rng):
    """A frame gap of more than 64 samples is integrated in chunks that are
    merged, in both packages."""
    sim = simulate_imu(rng, n=150)
    bg = np.array([0.002, 0.001, -0.003], np.float32)
    P = jinertial.integrate_frame_window(CAL, sim["gyro"], sim["acc"],
                                         sim["dt"], bg, np.zeros(3))
    Q = inertial.integrate_frame_window(TCAL, sim["gyro"], sim["acc"],
                                        sim["dt"], bg, np.zeros(3), "cpu")
    for name in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JPa"):
        _close(getattr(P, name), getattr(Q, name), 1e-5)


def test_factors_match_jax(rng):
    sim = simulate_imu(rng, n=50)
    P, Q = _windows(sim, 0, 50)
    bg = np.array([0.001, -0.002, 0.0015], np.float32)
    ba = np.array([0.01, 0.02, -0.01], np.float32)
    st = [sim["R"][0], sim["p"][0], sim["v"][0] + 0.01, sim["R"][-1],
          sim["p"][-1] + 0.02, sim["v"][-1], bg, ba]
    r_j = jfac.inertial_residual(*(jnp.asarray(a, jnp.float32) for a in st),
                                 P, gravity=jnp.asarray(sim["g"],
                                                        jnp.float32))
    r_t = tfac.inertial_residual(*(T(a) for a in st), Q, T(sim["g"]))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-5)
    _close(jfac.information_9(P), tfac.information_9(Q), 1e-4)
    _close(jfac.bias_walk_information(P), tfac.bias_walk_information(Q),
           1e-4)
    # the residual at the ground truth (test_imu.py's TestInertialResidual)
    r0 = tfac.inertial_residual(
        T(sim["R"][0]), T(sim["p"][0]), T(sim["v"][0]), T(sim["R"][-1]),
        T(sim["p"][-1]), T(sim["v"][-1]), torch.zeros(3), torch.zeros(3), Q,
        T(sim["g"]))
    np.testing.assert_allclose(r0.numpy(), 0.0, atol=5e-3)


def test_forward_jacobian_equals_torch_func(rng):
    """optim/jac.py's one-pass forward Jacobian equals torch.func.jacfwd on
    the 9-dof residual over a 24-dim pair perturbation."""
    sim = simulate_imu(rng, n=30)
    _, Q = _windows(sim, 0, 30)
    R_i, p_i, v_i = T(sim["R"][0]), T(sim["p"][0]), T(sim["v"][0])
    R_j, p_j, v_j = T(sim["R"][-1]), T(sim["p"][-1]), T(sim["v"][-1])
    g = T(sim["g"])

    def res(x):
        return tfac.inertial_residual(
            R_i @ so3.exp(x[..., 0:3]), p_i + x[..., 3:6], v_i + x[..., 6:9],
            R_j @ so3.exp(x[..., 15:18]), p_j + x[..., 18:21],
            v_j + x[..., 21:24], x[..., 9:12], x[..., 12:15], Q, g)

    # a batch of one: torch.func gives a 0-dim torch.where a float64
    # tangent (the reason the port takes optim/jac.py's route)
    x0 = torch.full((1, 24), 0.01)
    r, J = jac.jacobian_fwd(res, x0)
    np.testing.assert_allclose(r.numpy(), res(x0).numpy(), atol=1e-7)
    np.testing.assert_allclose(
        J.numpy()[0], torch.func.jacfwd(res)(x0).numpy()[0, :, 0], atol=1e-5)


def test_written_out_inertial_jacobian_equals_torch_func(rng):
    """factors.inertial_jacobians, the optimisers' Jacobian of the 9-dof
    residual, equals torch.func.jacfwd of inertial_residual over both
    states' (dphi, dp, dv) and the biases, within 1e-4 (float32, entries
    up to ~10)."""
    sim = simulate_imu(rng, n=30)
    _, Q = _windows(sim, 0, 30)
    st = [T(sim["R"][0]), T(sim["p"][0]), T(sim["v"][0] + 0.05),
          T(sim["R"][-1]), T(sim["p"][-1] - 0.03), T(sim["v"][-1]),
          T([0.01, -0.02, 0.005]), T([0.05, 0.0, -0.02])]
    g = T(sim["g"])

    def res(x):
        return tfac.inertial_residual(
            st[0] @ so3.exp(x[..., 0:3]), st[1] + x[..., 3:6],
            st[2] + x[..., 6:9], st[3] @ so3.exp(x[..., 9:12]),
            st[4] + x[..., 12:15], st[5] + x[..., 15:18],
            st[6] + x[..., 18:21], st[7] + x[..., 21:24], Q, g)

    J_ref = torch.func.jacfwd(res)(torch.zeros((1, 24)))[0, :, 0]
    r, J_i, J_j, J_bg, J_ba = tfac.inertial_jacobians(*st, Q, g)
    np.testing.assert_allclose(r.numpy(), res(torch.zeros(24)).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(torch.cat([J_i, J_j, J_bg, J_ba], -1).numpy(),
                               J_ref.numpy(), atol=1e-4)


def _init_problem(rng, n=500, every=25, s_true=2.5):
    sim = simulate_imu(rng, n=n, dt=0.005)
    kf_idx = np.arange(0, n + 1, every)
    true_bg = np.array([0.004, -0.003, 0.005], np.float32)
    gyro = sim["gyro"] + true_bg
    pj, pt = [], []
    for a, b in zip(kf_idx[:-1], kf_idx[1:]):
        P, Q = _windows(sim, a, b, gyro)
        pj.append(P)
        pt.append(Q)
    pj = jax.tree.map(lambda *xs: jnp.stack(xs), *pj)
    return (sim, kf_idx, true_bg, pj, tpre.stack(pt),
            sim["R"][kf_idx].astype(np.float32),
            (sim["p"][kf_idx] / s_true).astype(np.float32))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_optimization_matches_jax(rng, fix_scale):
    # test_imu.py's 2.5 s chain (21 keyframes); 1.5 s at a fixed scale
    sim, kf_idx, true_bg, pj, pt, R_wb, p_vis = _init_problem(
        rng, n=300 if fix_scale else 500)
    if fix_scale:
        p_vis = sim["p"][kf_idx].astype(np.float32)
    R0j = jinit.initial_gravity_estimate(jnp.asarray(R_wb), pj)
    R0t = tinit.initial_gravity_estimate(T(R_wb), pt)
    np.testing.assert_allclose(R0t.numpy(), np.asarray(R0j), atol=1e-4)
    np.testing.assert_allclose(
        tinit.estimate_gyro_bias(T(R_wb), pt).numpy(),
        np.asarray(jinit.estimate_gyro_bias(jnp.asarray(R_wb), pj)),
        atol=1e-6)
    rj = jinit.inertial_optimization(
        jnp.asarray(R_wb), jnp.asarray(p_vis), pj, R0j, prior_gyro=1e2,
        prior_acc=1e6, iters=25, fix_scale=fix_scale)
    rt = tinit.inertial_optimization(
        T(R_wb), T(p_vis), pt, R0t, prior_gyro=1e2, prior_acc=1e6, iters=25,
        fix_scale=fix_scale)
    assert abs(float(rt.scale) - float(rj.scale)) < 1e-3
    ang = so3.log(T(np.asarray(rj.R_wg)).T @ rt.R_wg)
    assert float(torch.linalg.norm(ang)) < 1e-3
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), atol=1e-4)
    np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), atol=1e-4)
    np.testing.assert_allclose(rt.velocities.numpy(),
                               np.asarray(rj.velocities), atol=1e-3)
    # test_imu.py's gates on the port alone
    s_true = 1.0 if fix_scale else 2.5
    assert abs(float(rt.scale) - s_true) / s_true < 0.05
    g_est = rt.R_wg.numpy() @ np.array([0, 0, -9.81])
    assert g_est @ sim["g"] / (np.linalg.norm(g_est) * 9.81) > np.cos(
        np.radians(2.0))
    np.testing.assert_allclose(rt.bg.numpy(), true_bg, atol=2e-3)


def test_padded_chain_equals_jax(rng):
    """try_initialize_imu pads the chain to a multiple of 8 keyframes with
    masked edges: the padded solve agrees with JAX's padded solve."""
    sim, kf_idx, _, pj, pt, R_wb, p_vis = _init_problem(rng, n=250)
    K = len(kf_idx)
    pad = 16 - K
    ev = np.concatenate([np.ones(K - 1), np.zeros(pad)]).astype(np.float32)
    R_p = np.concatenate([R_wb, np.repeat(R_wb[-1:], pad, 0)])
    p_p = np.concatenate([p_vis, np.repeat(p_vis[-1:], pad, 0)])
    pj_p = jax.tree.map(lambda x: jnp.concatenate(
        [x, jnp.repeat(x[-1:], pad, axis=0)]), pj)
    pt_p = tpre.Preintegrated(*[torch.cat([x, x[-1:].repeat(
        pad, *([1] * (x.dim() - 1)))]) for x in pt])
    R0j = jinit.initial_gravity_estimate(jnp.asarray(R_p), pj_p,
                                         edge_valid=jnp.asarray(ev))
    rj = jinit.inertial_optimization(
        jnp.asarray(R_p), jnp.asarray(p_p), pj_p, R0j, prior_gyro=1e2,
        prior_acc=1e6, iters=25, edge_valid=jnp.asarray(ev))
    R0t = tinit.initial_gravity_estimate(T(R_p), pt_p, edge_valid=T(ev))
    rt = tinit.inertial_optimization(T(R_p), T(p_p), pt_p, R0t,
                                     prior_gyro=1e2, prior_acc=1e6, iters=25,
                                     edge_valid=T(ev))
    assert abs(float(rt.scale) - float(rj.scale)) < 1e-3
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), atol=1e-4)
    np.testing.assert_allclose(rt.velocities.numpy()[:K],
                               np.asarray(rj.velocities)[:K], atol=1e-3)
