"""The port's inertial tracking steps against the JAX package's, on one map.

The map is seeded by the port (ground-truth fixture, 376x240, 512
features, 2048 points, 32 keyframes) and carried into a JAX ``MapStore``
through ``to_numpy``; the frame is extracted once (by JAX) and shared, and
the preintegrated window (integrated by JAX) and the anchor state are the
same numbers in both packages. ``track_step_inertial_anchor`` and then,
under the anchor step's prior, ``track_step_inertial_lf`` must give the
same visual stage (n1, ref_kf, ids2 and match_pt equal), the same refine
inliers, the refined pose within 1e-4 and velocity within 1e-3, and
marginalisation priors whose information agrees within 1e-3 relative to
its largest entry.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.imu import preintegration as jpre
from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu.pipeline import kernels as jk
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.lie import SE3, so3
from orb_slam3_detailed_comments_tpu_torch.optim import pose_opt
from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels

from test_torch_track_step import (CAM, JCAM, LOCAL_CAP, _frame,
                                   _stage1_inputs, world)  # noqa: F401

torch.set_num_threads(2)

I = 13          # the tracked frame, between keyframes 6 (frame 12) and 7
DT = 0.05       # the orbit's frame period


def _imu_inputs(R, t):
    """The anchor (frame 12's camera = body), its velocity, and a 10-sample
    window of constant body rate and specific force that carries it to
    frame 13."""
    R_a, R_j = R[I - 1].T, R[I].T                  # R_wb = R_cw^T
    p_a, p_j = -R_a @ t[I - 1], -R_j @ t[I]
    v_a = ((p_j - p_a) / DT).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    w = so3.log(torch.from_numpy((R_a.T @ R_j).astype(np.float32))).numpy()
    acc = R_a.T @ (2.0 * (p_j - p_a - v_a * DT) / DT ** 2 - g)
    n = 10
    P = jpre.integrate(jnp.asarray(np.tile(acc, (n, 1)), jnp.float32),
                       jnp.asarray(np.tile(w / DT, (n, 1)), jnp.float32),
                       jnp.full((n,), DT / n, jnp.float32),
                       jpre.ImuCalib.default())
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(R_a=f32(R_a), p_a=f32(p_a), v_a=v_a, g=g, P=P,
                Q=tpre.Preintegrated(*[torch.from_numpy(np.array(x))
                                       for x in P]))


def _steps(m, jm, planes, R, t):
    prep_t, prep_j = _frame(planes, R, t, I)
    ids1, ang1 = _stage1_inputs(m, 6)
    rs, inv_s2 = kernels.level_weights()
    T_pred = (R[I - 1], t[I - 1] + np.float32([0.004, -0.003, 0.006]))
    dp, ko = m.device_points(), m.device_kf_obs()
    dpj, koj = jm.device_points(), jm.device_kf_obs()
    f = torch.from_numpy
    common_t = (SE3(f(T_pred[0]), f(T_pred[1])), prep_t, f(ids1), f(ang1),
                dp["xyz"], dp["desc"], dp["normal"], dp["min_dist"],
                dp["max_dist"], dp["valid"], ko["feat_point"], ko["valid"],
                ko["covis"], ko["point_bits"], f(15.0 * rs), f(4.0 * rs),
                f(inv_s2))
    common_j = (JSE3(jnp.asarray(T_pred[0]), jnp.asarray(T_pred[1])),
                prep_j, jnp.asarray(ids1), jnp.asarray(ang1),
                dpj["xyz"], dpj["desc"], dpj["normal"], dpj["min_dist"],
                dpj["max_dist"], dpj["valid"], koj["feat_point"],
                koj["valid"], koj["covis"], koj["point_bits"],
                jnp.asarray(15.0 * rs), jnp.asarray(4.0 * rs),
                jnp.asarray(inv_s2))
    kw_t = dict(cam=CAM, local_cap=LOCAL_CAP, pt_proj8=dp["proj8"])
    kw_j = dict(cam=JCAM, local_cap=LOCAL_CAP, pt_proj8=dpj["proj8"])
    return common_t, common_j, kw_t, kw_j


def _assert_same(res_t, res_j):
    assert int(res_t.n1) == int(res_j.n1) > 100
    assert int(res_t.ref_kf) == int(res_j.ref_kf)
    np.testing.assert_array_equal(res_t.ids2.numpy(), np.asarray(res_j.ids2))
    np.testing.assert_array_equal(res_t.match_pt.numpy(),
                                  np.asarray(res_j.match_pt))
    assert int(res_t.ni) == int(res_j.ni) > 150
    np.testing.assert_array_equal(res_t.inl_i.numpy(),
                                  np.asarray(res_j.inl_i))
    np.testing.assert_allclose(res_t.Ri_cw.numpy(), np.asarray(res_j.Ri_cw),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.ti_cw.numpy(), np.asarray(res_j.ti_cw),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.v_w.numpy(), np.asarray(res_j.v_w),
                               atol=1e-3)
    Hj = np.asarray(res_j.prior.H)
    assert np.abs(res_t.prior.H.numpy() - Hj).max() < 1e-3 * np.abs(Hj).max()


@pytest.mark.parametrize("variant", ["anchor", "lf"])
def test_inertial_track_step_matches_jax(world, variant):
    planes, R, t, m, jm = world
    common_t, common_j, kw_t, kw_j = _steps(m, jm, planes, R, t)
    d = _imu_inputs(R, t)
    f = torch.from_numpy
    z3, jz3 = torch.zeros(3), jnp.zeros(3)
    eye, jeye = torch.eye(3), jnp.eye(3)
    anchor_j = jk.track_step_inertial_anchor(
        *common_j, jnp.asarray(d["v_a"]), jnp.asarray(d["R_a"]),
        jnp.asarray(d["p_a"]), jnp.asarray(d["v_a"]), jz3, jz3, d["P"],
        jnp.asarray(d["g"]), jeye, jz3, **kw_j)
    if variant == "anchor":
        res_t = kernels.track_step_inertial_anchor(
            *common_t, f(d["v_a"]), f(d["R_a"]), f(d["p_a"]), f(d["v_a"]),
            z3, z3, d["Q"], f(d["g"]), eye, z3, **kw_t)
        _assert_same(res_t, anchor_j)
        # the refined camera centre stays on the orbit
        C = -R[I].T @ t[I]
        C_est = -res_t.Ri_cw.numpy().T @ res_t.ti_cw.numpy()
        assert np.linalg.norm(C - C_est) < 0.05
        return
    # the last-frame form under the anchor step's prior, carried over
    prior_j = anchor_j.prior
    prior_t = pose_opt.PriorPoseImu(*[f(np.array(x)) for x in prior_j])
    v0 = np.asarray(anchor_j.v_w)
    res_j = jk.track_step_inertial_lf(
        *common_j, jnp.asarray(v0), prior_j, d["P"], jnp.asarray(d["g"]),
        jeye, jz3, **kw_j)
    res_t = kernels.track_step_inertial_lf(
        *common_t, f(v0), prior_t, d["Q"], f(d["g"]), eye, z3, **kw_t)
    _assert_same(res_t, res_j)
    assert isinstance(res_t.prior, pose_opt.PriorPoseImu)
