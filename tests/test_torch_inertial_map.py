"""The port's inertial map bookkeeping against the JAX package's: the
inertial block carried between the packages (``MapStore.to_numpy`` /
``from_numpy``), the preintegration chain merged across a culled keyframe,
the 4DoF essential graph that rotates velocities
(``tests/test_merge_parity.py:109``) and the inertial spacing rule of
keyframe culling (``tests/test_pipeline_mono_inertial.py``'s three cases).

Tolerances: the carried arrays exactly; the merged window within 1e-5
relative; the 4DoF graph within 2e-3 (its float64 normal equations against
JAX's float32), and that file's gates on the port; the culled keyframes
the same in both packages.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import so3 as jso3
from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.pipeline import loop_closing as jlc
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import local_mapping
from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing

from synthetic import CAM as JCAM
from test_full_inertial_ba import build_inertial_map

torch.set_num_threads(2)

CAM = cameras.pinhole(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width,
                      JCAM.height)
CFG = mapstore.MapConfig(max_kf=32, max_pt=512, n_feat=256)


def _port(jm):
    return mapstore.MapStore.from_numpy(vars(jm), CFG, device="cpu")


def _compare(jm, tm, pose=1e-3, pts=2e-3,
             fields=("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")):
    for f in fields:
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f), atol=pose,
                                   err_msg=f)
    np.testing.assert_allclose(tm.pt_xyz, jm.pt_xyz, atol=pts)


def test_inertial_block_round_trips(rng):
    jm, _ = build_inertial_map(rng)
    tm = _port(jm)
    assert tm.imu_initialized and not tm.imu_ba1
    back = tm.to_numpy()
    for name in ("kf_vel", "kf_bg", "kf_prev", "kf_pre_dT", "kf_pre_C",
                 "kf_pre_JRg", "kf_pre_bg0"):
        np.testing.assert_array_equal(back[name], getattr(jm, name))
    pres = tm.get_kf_preintegration([2, 3])
    np.testing.assert_array_equal(pres.dV.numpy(), jm.kf_pre_dV[[2, 3]])
    tm.set_kf_preintegration(5, tpre.index(pres, 0), 1)
    assert tm.kf_prev[5] == 1 and tm.kf_pre_dT[5] == jm.kf_pre_dT[2]


def test_chain_merge_across_a_culled_keyframe_matches_jax(rng):
    jm, truth = build_inertial_map(rng)
    tm = _port(jm)
    k = truth["kf_ids"][4]
    jm.remove_keyframe(k)
    tm.remove_keyframe(k)
    np.testing.assert_array_equal(tm.kf_prev, jm.kf_prev)
    for name in mapstore.PRE_FIELDS:
        a, b = getattr(jm, "kf_pre_" + name), getattr(tm, "kf_pre_" + name)
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(a).max(), 1e-30), \
            name
    np.testing.assert_array_equal(tm.pt_valid, jm.pt_valid)


def test_4dof_graph_rotates_velocities_as_jax(rng):
    """test_merge_parity.py's inertial case: a yaw-only weld error on a
    gravity-aligned map, a window snapped back to truth; the 4DoF graph
    drags the far end back and rotates the velocities with their poses."""
    m, truth = build_inertial_map(rng, n_kf=16, pose_noise=0.0,
                                  vel_noise=0.0)
    kf_ids = [int(k) for k in truth["kf_ids"]]
    R_true = {k: m.kf_R[k].copy() for k in kf_ids}
    t_true = {k: m.kf_t[k].copy() for k in kf_ids}
    v_true = {k: m.kf_vel[k].copy() for k in kf_ids}
    R_d = np.asarray(jso3.exp(jnp.asarray([0.0, 0.0, 0.1], jnp.float32)))
    t_d = np.array([0.2, -0.1, 0.0], np.float32)
    for k in kf_ids:
        m.kf_R[k] = R_true[k] @ R_d.T
        m.kf_t[k] = t_true[k] - m.kf_R[k] @ t_d
        m.kf_vel[k] = R_d @ v_true[k]
    pv = m.pt_valid
    m.pt_xyz[pv] = m.pt_xyz[pv] @ R_d.T + t_d
    snap_R, snap_t = m.kf_R.copy(), m.kf_t.copy()
    window = kf_ids[:5]
    for k in window:
        m.kf_R[k], m.kf_t[k], m.kf_vel[k] = R_true[k], t_true[k], v_true[k]
    tm = mapstore.MapStore.from_numpy(
        vars(m), mapstore.MapConfig(max_kf=32, max_pt=512, n_feat=256),
        device="cpu")
    jlc.run_merge_essential_graph(m, snap_R, snap_t, set(window),
                                  inertial=True, fix_scale=True)
    loop_closing.run_merge_essential_graph(tm, snap_R, snap_t, set(window),
                                           inertial=True, fix_scale=True)
    for f in ("kf_R", "kf_t", "kf_vel"):
        np.testing.assert_allclose(getattr(tm, f), getattr(m, f), atol=2e-3)
    far = kf_ids[-1]
    c_est = -tm.kf_R[far].T @ tm.kf_t[far]
    c_true = -R_true[far].T @ t_true[far]
    assert np.linalg.norm(c_est - c_true) < 0.04
    v_err = np.linalg.norm(tm.kf_vel[far] - v_true[far])
    assert v_err < 0.05 * max(np.linalg.norm(v_true[far]), 1.0)


def _redundant_map(rng, dt, store):
    """test_pipeline_mono_inertial.py's TestInertialKeyFrameCulling map: 7
    keyframes all seeing 30 points, chained with windows of dt seconds."""
    n_kf, n_pt = 7, 30
    m = store(max_kf=16, max_pt=256, n_feat=64)
    m.pt_xyz[:n_pt] = rng.normal(0, 1, (n_pt, 3)) + [0, 0, 5]
    m.pt_valid[:n_pt] = True
    m.pt_ref_kf[:n_pt] = 0
    for k in range(n_kf):
        fp = np.full(64, -1, np.int32)
        fp[:n_pt] = np.arange(n_pt)
        val = np.zeros(64, bool)
        val[:n_pt] = True
        m.add_keyframe(
            np.eye(3, dtype=np.float32), np.array([0.1 * k, 0, 0], np.float32),
            dt * k, k, rng.normal(300, 50, (64, 2)).astype(np.float32),
            np.zeros((64, 2), np.float32), np.zeros(64, np.int32),
            np.zeros(64, np.float32),
            rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32), val, fp)
        if k > 0:
            m.kf_prev[k] = k - 1
            m.kf_pre_dT[k] = dt
    m.update_point_stats(np.arange(n_pt))
    return m


def _port_store(**kw):
    return mapstore.MapStore(mapstore.MapConfig(**kw), device="cpu")


def _cull(m):
    local_mapping.LocalMapper(m, CAM)._keyframe_culling(6)
    return m


@pytest.mark.parametrize("case", ["visual", "wide_gap", "tight_spacing"])
def test_inertial_keyframe_culling(case):
    """The three cases of test_pipeline_mono_inertial.py: a visual map
    culls redundant keyframes; an inertial one keeps them when the merged
    gap would pass 0.5 s, and culls them at a tight spacing with the chain
    merged (the windows' dT summing to 1.2 s back to keyframe 0); the
    JAX package culls the same keyframes."""
    dt = 0.2 if case == "tight_spacing" else 1.0
    tm = _redundant_map(np.random.default_rng(0), dt, _port_store)
    jm = _redundant_map(np.random.default_rng(0), dt,
                        lambda **kw: jms.MapStore(jms.MapConfig(**kw)))
    if case != "visual":
        tm.imu_initialized = jm.imu_initialized = True
    _cull(tm)
    from orb_slam3_detailed_comments_tpu.pipeline.local_mapping import (
        LocalMapper)
    LocalMapper(jm, JCAM)._keyframe_culling(6)
    np.testing.assert_array_equal(tm.kf_valid, jm.kf_valid)
    if case == "wide_gap":
        assert tm.n_kf == 7
        return
    assert tm.n_kf < 7
    if case == "tight_spacing":
        k, total = 6, 0.0
        while tm.kf_prev[k] >= 0:
            total += float(tm.kf_pre_dT[k])
            k = int(tm.kf_prev[k])
        assert k == 0
        np.testing.assert_allclose(total, 1.2, atol=1e-5)
