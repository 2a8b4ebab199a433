"""The port's inertial bundle adjustments and IMU initialisation against
the JAX package's, on one map carried between the packages
(``MapStore.to_numpy`` / ``from_numpy``, the inertial block with it): the
local and full inertial BAs, the IMU initialisation with its change of
frame, and the merge weld's inertial BA.

Tolerances: keyframe poses, velocities and biases within 1e-3 of JAX's
after a BA (states float32 in both, the port's normal equations float64),
points within 2e-3 (the weld BA's where the windows fix their depth); the
IMU initialisation's scale within 1e-3 and R_wg within 1e-3 rad, the map
it rewrites within 1e-3. The mirror of ``tests/test_full_inertial_ba.py``
holds the port to that file's gates.
"""
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.pipeline import inertial as jin
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import inertial

from synthetic import CAM as JCAM
from test_full_inertial_ba import (build_inertial_map,
                                   chain_preintegration_residuals)
from test_imu import CAL

torch.set_num_threads(2)

CAM = cameras.pinhole(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width,
                      JCAM.height)
TCAL = tpre.ImuCalib.default()
CFG = mapstore.MapConfig(max_kf=32, max_pt=512, n_feat=256)


def _port(jm):
    return mapstore.MapStore.from_numpy(vars(jm), CFG, device="cpu")


def _compare(jm, tm, pose=1e-3, pts=2e-3,
             fields=("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")):
    for f in fields:
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f), atol=pose,
                                   err_msg=f)
    np.testing.assert_allclose(tm.pt_xyz, jm.pt_xyz, atol=pts)


@pytest.mark.parametrize("which", ["full", "local"])
def test_inertial_ba_matches_jax(rng, which):
    jm, truth = build_inertial_map(rng)
    tm = _port(jm)
    if which == "full":
        res0 = chain_preintegration_residuals(jm)
        err0 = max(np.linalg.norm(-jm.kf_R[k].T @ jm.kf_t[k] - truth["p"][i])
                   for i, k in enumerate(truth["kf_ids"]))
        jin.run_full_inertial_ba(jm, JCAM, iters=12, prior_gyro=1.0,
                                 prior_acc=1e4, calib=CAL)
        C = inertial.run_full_inertial_ba(tm, CAM, iters=12, prior_gyro=1.0,
                                          prior_acc=1e4, calib=TCAL)
        assert C == len(truth["kf_ids"])
    else:
        jin.run_local_inertial_ba(jm, JCAM, calib=CAL)
        C = inertial.run_local_inertial_ba(tm, CAM, calib=TCAL)
        assert C == 11
    _compare(jm, tm)
    if which == "full":
        # test_full_inertial_ba.py's gates, on the port's map
        err1 = max(np.linalg.norm(-tm.kf_R[k].T @ tm.kf_t[k] - truth["p"][i])
                   for i, k in enumerate(truth["kf_ids"]))
        assert err1 < 0.25 * err0
        v_err = max(np.linalg.norm(tm.kf_vel[k] - truth["v"][i])
                    for i, k in enumerate(truth["kf_ids"]))
        assert v_err < 0.08
        for f in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba"):
            setattr(jm, f, getattr(tm, f).copy())
        res1 = chain_preintegration_residuals(jm)
        assert res1 < 0.25 * res0 and res1 < 0.05


def test_imu_initialisation_matches_jax(rng):
    """try_initialize_imu on one map in both packages: the same world
    transform, and the same map after ApplyScaledRotation."""
    jm, _ = build_inertial_map(rng)
    jm.imu_initialized = False
    tm = _port(jm)
    out_j = jin.try_initialize_imu(jm, min_kf=8, min_time=1.0,
                                   prior_gyro=1e2, prior_acc=1e6, calib=CAL)
    out_t = inertial.try_initialize_imu(tm, min_kf=8, min_time=1.0,
                                        prior_gyro=1e2, prior_acc=1e6,
                                        calib=TCAL)
    assert out_j is not None and out_t is not None
    assert abs(out_t[1] - float(out_j[1])) < 1e-3
    dR = np.asarray(out_j[0]).T @ out_t[0]
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    assert tm.imu_initialized
    _compare(jm, tm, pose=1e-3, pts=2e-3)
    np.testing.assert_allclose(tm.pt_normal, jm.pt_normal, atol=1e-3)
    # too short a chain: no initialisation in either package
    short = _port(jm)
    short.kf_valid[6:] = False
    assert inertial.try_initialize_imu(short, min_kf=8, calib=TCAL) is None


def test_merge_inertial_ba_matches_jax(rng):
    """The weld's MergeInertialBA on two windows of one chain (a window
    ending at keyframe 10 and one around keyframe 3), in both packages."""
    jm, truth = build_inertial_map(rng)
    tm = _port(jm)
    kf = truth["kf_ids"]
    out_j = jin.run_merge_inertial_ba(jm, JCAM, kf[10], kf[3], CAL, nd=3)
    out_t = inertial.run_merge_inertial_ba(tm, CAM, kf[10], kf[3], TCAL,
                                           nd=3)
    assert out_j is not None and out_t == out_j
    # a point whose rays from the windows' keyframes part by less than a
    # degree has no depth from the weld BA (both packages drift such points
    # tens of metres out, JAX in float32 and the port in float64): the
    # points are held where the windows fix them
    held = _parallax_deg(tm, out_t) >= 1.0
    assert held.sum() > 100
    _compare(jm, tm, pts=np.inf)
    np.testing.assert_allclose(tm.pt_xyz[held], jm.pt_xyz[held], atol=2e-3)


def _parallax_deg(m, kfs):
    """Per point, the widest angle between its rays from the keyframes of
    kfs that observe it (0 with fewer than two)."""
    out = np.zeros(m.cfg.max_pt)
    rays = {}
    for k in kfs:
        c = -m.kf_R[k].T @ m.kf_t[k]
        for p in m.kf_feat_point[k][m.kf_feat_point[k] >= 0]:
            r = m.pt_xyz[p] - c
            rays.setdefault(int(p), []).append(r / np.linalg.norm(r))
    for p, rs in rays.items():
        rs = np.asarray(rs)
        cos = np.clip(rs @ rs.T, -1.0, 1.0)
        out[p] = np.degrees(np.arccos(cos.min()))
    return out


