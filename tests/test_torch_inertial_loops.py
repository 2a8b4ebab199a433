"""Loop closing on inertial maps, the port against the JAX package.

- ``synth_render.inertial_loop_trajectory``: equal to the JAX package's
  to the bit (poses, times, IMU windows, centres) at two parameter sets.
- ``chip_smoke.py``'s copies of ``tests/test_pipeline_stress.py``'s
  stress-case helpers: ``stress_world`` equal, ``degrade`` within 1e-3
  grey levels of the original (``cv2.blur``).
- ``chip_smoke.coo_gba_path`` (phase 11c) on a 52-keyframe visual map on
  the CPU: the visual global BA in ``ba_solve``'s COO tier.
- ``LoopCloser._correct_loop`` replayed in both packages on one inertial
  map (``test_full_inertial_ba.build_inertial_map``'s, its IMU state on,
  given a loop as ``test_torch_loop_closing.py`` gives the visual one):
  a correction inside the gravity gate before and after VIBA2 (the
  yaw-only, unit-scale branch), where the 4DoF essential graph rotates the
  velocities: poses and velocities within 2e-3 of JAX's after the graph
  and the loop fuse (the 4DoF graph's tolerance,
  ``test_torch_inertial_map.py``); one outside the gate: both refuse,
  count it, and leave the map as it was; and the synchronous full
  inertial BA after the graph: states within 1e-3, the same inlier sets.

The JAX package's run of ``chip_smoke.py`` phase 11b's case is the slow
test at the end: the reference for the depth that phase 11b runs.
"""
import copy
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import Sim3 as JSim3
from orb_slam3_detailed_comments_tpu.models import cameras as jcameras
from orb_slam3_detailed_comments_tpu.pipeline import inertial as jin
from orb_slam3_detailed_comments_tpu.pipeline import loop_closing as jlc
from orb_slam3_detailed_comments_tpu.utils import synth_render as jsynth
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import (inertial,
                                                            loop_closing)
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as tsynth

import chip_smoke
import test_pipeline_stress
from synthetic import CAM as JCAM
from test_imu import CAL
from test_torch_loop_closing import CAM as LOOP_CAM, CFG, _make_loop_map

torch.set_num_threads(2)

CAM_KW = dict(fx=400.0, fy=400.0, cx=376.0, cy=240.0, width=752, height=480)
TRUE_BG = np.array([-0.002, 0.003, 0.001], np.float32)
BASELINE = 0.11
TCAM = cameras.pinhole(**CAM_KW)
TCAL = tpre.ImuCalib.default()
STATE = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")


@pytest.mark.parametrize("kw", [
    dict(n_frames=40, imu_per_frame=12,
         true_bg=np.array([-0.002, 0.003, 0.001]),
         true_ba=np.array([0.02, -0.01, 0.03]), yaw_burst=(0.3, 0.5, 2.0)),
    dict(n_frames=25, imu_per_frame=24, radius=2.5, closes=1.0, wobble=0.08,
         true_bg=np.array([0.001, -0.004, 0.002]))],
    ids=["12-a-frame-burst", "24-a-frame"])
def test_inertial_loop_trajectory_equals_jax(kw):
    mine = tsynth.inertial_loop_trajectory(**kw)
    ref = jsynth.inertial_loop_trajectory(**kw)
    for key in ("R_cw", "t_cw", "ts", "centers", "gravity"):
        assert mine[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    assert mine["windows"][0] is None and ref["windows"][0] is None
    assert len(mine["windows"]) == len(ref["windows"]) == kw["n_frames"]
    for a, b in zip(mine["windows"][1:], ref["windows"][1:]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("half", [8.0, 4.0])
def test_stress_world_equals_the_test_helper(half):
    mine = chip_smoke.stress_world(np.random.default_rng(29), half=half)
    ref = test_pipeline_stress.stress_world(np.random.default_rng(29),
                                            half=half)
    assert len(mine) == len(ref) == 4
    for a, b in zip(mine, ref):
        for f in ("origin", "e1", "e2", "texture"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("i", [5, 25, 41, 75, 90, 99],
                         ids=["clean", "dark", "blur", "bright", "occluder",
                              "last"])
def test_degrade_matches_the_test_helper(i):
    """Frame i of 100 of a ray-cast stress-box image through each
    degradation segment; the motion blur without OpenCV."""
    cam = cameras.pinhole(fx=100.0, fy=100.0, cx=94.0, cy=60.0, width=188,
                          height=120)
    walls = chip_smoke.stress_world(np.random.default_rng(3), half=4.0)
    R, t = test_pipeline_stress.stress_trajectory(100)
    img = tsynth.render_frame_raycast(cam, walls, R[i], t[i])[0]
    mine = chip_smoke.degrade(img, i, 100)
    ref = test_pipeline_stress.degrade(img, i, 100)
    assert mine.dtype == ref.dtype == np.float32
    assert np.abs(mine - ref).max() < 1e-3
    if i == 41:
        assert np.abs(mine - img).max() > 10.0     # the blur did blur


def test_box_blur_borders_match_cv2():
    import cv2
    img = np.random.default_rng(5).uniform(0, 255, (7, 13)).astype(np.float32)
    assert np.abs(chip_smoke.box_blur_9x1(img) - cv2.blur(img, (9, 1))).max() \
        < 1e-3


def _wide_visual_map(n_kf=52, n_pts=600, seed=4):
    """A visual map with more keyframes than the table tier takes: a ring
    of n_kf keyframes (noisy poses but the first) facing a cylinder wall of
    points (noisy), each keyframe observing what it sees (0.5 px noise)."""
    rng = np.random.default_rng(seed)
    cam = cameras.pinhole(fx=200.0, fy=200.0, cx=188.0, cy=120.0, width=376,
                          height=240)
    N = 128
    m = mapstore.MapStore(mapstore.MapConfig(max_kf=64, max_pt=1024,
                                             n_feat=N), "cpu")
    a = rng.uniform(0, 2 * np.pi, n_pts)
    pts = np.stack([6.0 * np.sin(a), rng.uniform(-1.5, 1.5, n_pts),
                    6.0 * np.cos(a)], 1)
    m.pt_xyz[:n_pts] = pts + rng.normal(0, 0.02, pts.shape)
    m.pt_valid[:n_pts] = True
    m.pt_desc[:n_pts] = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    for i in range(n_kf):
        yaw = 2 * np.pi * i / n_kf
        R_wc = tsynth._rodrigues(np.array([0.0, yaw, 0.0]))
        c_w = 2.0 * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        R_cw, t_cw = R_wc.T, -R_wc.T @ c_w
        xc = pts @ R_cw.T + t_cw
        uv = cameras.project(cam, torch.as_tensor(xc, dtype=torch.float32))
        ok = (xc[:, 2] > 0.5) & cameras.in_image(cam, uv).numpy()
        sel = np.where(ok)[0][:N]
        fp = np.full(N, -1, np.int32)
        fp[:len(sel)] = sel
        xy = np.zeros((N, 2), np.float32)
        xy[:len(sel)] = uv.numpy()[sel] + rng.normal(0, 0.5, (len(sel), 2))
        val = np.arange(N) < len(sel)
        if i > 0:
            R_cw = R_cw @ tsynth._rodrigues(rng.normal(0, 0.01, 3))
            t_cw = t_cw + rng.normal(0, 0.01, 3)
        m.add_keyframe(R_cw.astype(np.float32), t_cw.astype(np.float32),
                       0.1 * i, i, xy, np.zeros((N, 2), np.float32),
                       np.zeros(N, np.int32), np.zeros(N, np.float32),
                       np.zeros((N, 8), np.uint32), val, fp)
    m.update_point_stats(np.arange(n_pts))
    return m, cam


def test_coo_gba_path_on_a_wide_map():
    """Phase 11c's check on the CPU (its "card" side there too): 52
    keyframes put the visual global BA in the COO tier, the solve lowers
    the robust cost, and the same device gives the same assembly and
    solve."""
    m, cam = _wide_visual_map()
    snap = dict(map=chip_smoke.map_arrays(m), map_cfg=m.cfg, cam=cam)
    rec = chip_smoke.coo_gba_path(torch.device("cpu"), snap)
    assert rec["cpu"]["tier"] == rec["card"]["tier"] == "coo"
    assert rec["cpu"]["C"] == 56
    assert rec["coo_calls"] == ["cpu", "cpu", "cpu"]
    assert rec["cpu"]["cost_after"] < 0.5 * rec["cpu"]["cost_before"]
    assert max(rec["assembly_card_vs_cpu"].values()) == 0.0
    assert max(rec["card_vs_cpu"].values()) == 0.0


# ----------------------------------------------------------- _correct_loop
def _gravity_map():
    """_make_loop_map's map with its IMU state on (gravity along -z), the
    loop measurement and its keyframes."""
    jm, k, c, S, _ = _make_loop_map()
    jm = copy.deepcopy(jm)
    jm.imu_initialized = True
    jm.imu_ba1 = True
    return jm, k, c, S


def _to_port(jm):
    """The JAX map in the port, its IMU flags with it."""
    arrays = {k: v for k, v in vars(jm).items() if isinstance(v, np.ndarray)}
    arrays["tombstones"] = copy.deepcopy(jm.tombstones)
    for f in ("imu_initialized", "imu_ba1", "imu_ba2"):
        arrays[f] = getattr(jm, f)
    m = mapstore.MapStore.from_numpy(arrays, mapstore.MapConfig(**CFG), "cpu")
    assert (m.imu_initialized, m.imu_ba2) == (jm.imu_initialized, jm.imu_ba2)
    return m


def _outside_gate(jm, k, c, tilt):
    """A measurement S_kc whose world correction is a pure roll of tilt
    rad: S_kc = T_k ∘ E ∘ T_c^-1, so S_ww = E."""
    E = loop_closing.host_sim3(
        tsynth._rodrigues(np.array([tilt, 0.0, 0.0])).astype(np.float32),
        np.zeros(3, np.float32), 1.0)
    S = (loop_closing.host_sim3(jm.kf_R[k], jm.kf_t[k]).compose(E)
         .compose(loop_closing.host_sim3(jm.kf_R[c], jm.kf_t[c]).inverse()))
    return loop_closing.sim3_np(S)


def _closers(jm, m, gba):
    jcl = jlc.LoopCloser(jm, JCAM, None, jlc.LoopClosingConfig(
        run_global_ba=gba))
    pcl = loop_closing.LoopCloser(m, LOOP_CAM, None,
                                  loop_closing.LoopClosingConfig(
                                      run_global_ba=gba))
    jcl.imu_calib, pcl.imu_calib = CAL, TCAL
    return jcl, pcl


def _correct_both(jcl, pcl, k, c, S):
    R, t, s = S
    out_j = jcl._correct_loop(k, c, JSim3(jnp.asarray(R), jnp.asarray(t),
                                          jnp.asarray(s)))
    out_p = pcl._correct_loop(k, c, loop_closing.host_sim3(R, t, s))
    return out_j, out_p


@pytest.mark.parametrize("ba2", [False, True], ids=["before-VIBA2",
                                                    "yaw-only"])
def test_correct_loop_inertial_graph_matches_jax(ba2):
    jm, k, c, S = _gravity_map()
    jm.imu_ba2 = ba2
    m = _to_port(jm)
    R0, v0 = m.kf_R.copy(), m.kf_vel.copy()
    jcl, pcl = _closers(jm, m, gba=False)
    assert _correct_both(jcl, pcl, k, c, S) == (True, True)
    assert jcl.n_loops_rejected_gravity == pcl.n_loops_rejected_gravity == 0
    kfs = m.kf_ids()
    for f in ("kf_R", "kf_t", "kf_vel"):
        np.testing.assert_allclose(getattr(m, f)[kfs], getattr(jm, f)[kfs],
                                   atol=2e-3, err_msg=f)
    np.testing.assert_array_equal(m.pt_valid, jm.pt_valid)
    np.testing.assert_allclose(m.pt_xyz[m.pt_valid], jm.pt_xyz[jm.pt_valid],
                               atol=2e-3)
    assert m.check_invariants() == jm.check_invariants()
    # the 4DoF graph turned the velocities with the poses
    assert np.abs(m.kf_vel[kfs] - v0[kfs]).max() > 1e-4
    # each keyframe's change of rotation, R_old^T R_new: the 4DoF graph
    # moves yaw only, so roll and pitch change only as the pre-correction
    # of k's covisible window seeded them (here every keyframe: all see
    # k's points): by the loop's full correction before VIBA2, by its yaw
    # alone after it (the window's update R' = R Rd^T, Rd = R(S_kw_corr)
    # R_k^T, leaves 5e-4 rad of a 2e-3 rad yaw in roll and pitch, in both
    # packages)
    dR = np.einsum("nji,njk->nik", R0[kfs], m.kf_R[kfs])
    tilt = np.abs(dR[:, :2, 2]).max(axis=1)
    if ba2:
        assert tilt.max() < 1e-3
    else:
        assert tilt[list(kfs).index(k)] > 2e-3


def test_correct_loop_outside_the_gravity_gate_refused_by_both():
    jm, k, c, _ = _gravity_map()
    m = _to_port(jm)
    before = {f: getattr(m, f).copy() for f in STATE + ("pt_xyz",)}
    jcl, pcl = _closers(jm, m, gba=True)
    S = _outside_gate(jm, k, c, 0.02)
    assert _correct_both(jcl, pcl, k, c, S) == (False, False)
    assert jcl.n_loops_rejected_gravity == pcl.n_loops_rejected_gravity == 1
    for f, a in before.items():
        np.testing.assert_array_equal(getattr(m, f), a, err_msg=f)
        np.testing.assert_array_equal(getattr(jm, f), a, err_msg=f)
    # the same roll just inside the gate is taken by both
    jm2, k, c, _ = _gravity_map()
    jcl, pcl = _closers(jm2, _to_port(jm2), gba=False)
    assert _correct_both(jcl, pcl, k, c, _outside_gate(jm2, k, c, 0.006)) \
        == (True, True)


def test_correct_loop_full_inertial_ba_matches_jax(monkeypatch):
    jm, k, c, S = _gravity_map()
    m = _to_port(jm)
    inliers = {}
    for name, mod in (("jax", jin), ("port", inertial)):
        real = mod.apply_viba_result

        def keep(m_, meta, res, _real=real, _name=name):
            inliers[_name] = np.asarray(res.obs_inlier).copy()
            return _real(m_, meta, res)
        monkeypatch.setattr(mod, "apply_viba_result", keep)
    jcl, pcl = _closers(jm, m, gba=True)
    assert _correct_both(jcl, pcl, k, c, S) == (True, True)
    assert pcl.last_correction["gba"] == [
        dict(C=len(m.temporal_chain()), tier="inertial")]
    kfs = m.kf_ids()
    for f in STATE:
        np.testing.assert_allclose(getattr(m, f)[kfs], getattr(jm, f)[kfs],
                                   atol=1e-3, err_msg=f)
    # the JAX package pads the observations to its compile bucket
    n_obs = len(inliers["port"])
    np.testing.assert_array_equal(inliers["port"], inliers["jax"][:n_obs])
    assert not inliers["jax"][n_obs:].any() and inliers["port"].any()
    assert m.check_invariants() == jm.check_invariants()


def jax_stereo_inertial_loop(n, imu_per_frame, log=print):
    """The JAX package's ``System(CAM, IMU_STEREO, baseline=0.11,
    enable_loop_closing=True)`` over ``n`` frames of phase 11b's case:
    ``stress_world(default_rng(29), half=4.0)``, ``inertial_loop_trajectory
    (n, imu_per_frame, true_bg=TRUE_BG)``, ray-cast rectified pairs,
    ``degrade`` on both images. Returns the gated quantities."""
    from orb_slam3_detailed_comments_tpu.pipeline.system import (IMU_STEREO,
                                                                 System)
    from orb_slam3_detailed_comments_tpu.utils import evaluate_ate
    from test_pipeline_stress import degrade, stress_world

    cam = jcameras.pinhole(**CAM_KW)
    walls = stress_world(np.random.default_rng(29), half=4.0)
    traj = jsynth.inertial_loop_trajectory(n, imu_per_frame=imu_per_frame,
                                           true_bg=TRUE_BG)
    slam = System(cam, IMU_STEREO, baseline=BASELINE,
                  enable_loop_closing=True)
    from orb_slam3_detailed_comments_tpu.pipeline.loop_closing import (
        LoopCloser)
    corrections = []
    inner = LoopCloser._correct_loop

    def logged(self, k, match_kf, S_kc):
        yaw_only = bool(self.map.imu_initialized and self.map.imu_ba2)
        ok = inner(self, k, match_kf, S_kc)
        corrections.append(dict(k=int(k), match=int(match_kf),
                                yaw_only=yaw_only, applied=bool(ok)))
        log(f"correction {corrections[-1]}")
        return ok

    LoopCloser._correct_loop = logged
    try:
        return _run_loop(slam, cam, walls, traj, n, corrections, log)
    finally:
        LoopCloser._correct_loop = inner


def _run_loop(slam, cam, walls, traj, n, corrections, log):
    from orb_slam3_detailed_comments_tpu.utils import evaluate_ate
    from test_pipeline_stress import degrade
    n_ok = 0
    for i in range(n):
        R, t = traj["R_cw"][i], traj["t_cw"][i]
        left, right = tsynth.render_stereo_pair(TCAM, walls, R, t, BASELINE)
        left, right = degrade(left, i, n), degrade(right, i, n)
        n_ok += slam.track_stereo(left, right, float(traj["ts"][i]),
                                  imu=traj["windows"][i]) is not None
        if i % 20 == 0:
            log(f"frame {i}: tracked {n_ok}, imu "
                f"{slam.map.imu_initialized} ba1 {slam.map.imu_ba1} ba2 "
                f"{slam.map.imu_ba2}, loops "
                f"{slam.loop_closer.n_loops_closed}")
    chain = slam.map.temporal_chain()
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est_xyz = np.array([r[1:4] for r in rows])
    rmse, npair, _ = evaluate_ate.ate_rmse(
        traj["ts"], traj["centers"], est_ts, est_xyz, with_scale=False)
    _, _, scale = evaluate_ate.ate_rmse(
        traj["ts"], traj["centers"], est_ts, est_xyz, with_scale=True)
    return dict(
        n=n, tracked=n_ok, maps=len(slam.atlas.maps),
        imu_initialized=bool(slam.map.imu_initialized),
        imu_ba1=bool(slam.map.imu_ba1), imu_ba2=bool(slam.map.imu_ba2),
        fix_scale=bool(slam.loop_closer.cfg.fix_scale),
        loops=int(slam.loop_closer.n_loops_closed),
        rejected_gravity=int(slam.loop_closer.n_loops_rejected_gravity),
        corrections=corrections,
        bg_err=float(np.abs(slam.map.kf_bg[chain[-1]] - TRUE_BG).max()),
        ate=float(rmse), npair=int(npair), scale=float(scale),
        consistency=slam.check_map_consistency())


@pytest.mark.slow
def test_jax_reference_of_phase_11b():
    """The JAX package on phase 11b's case at its chosen depth: 160 frames
    of 24 IMU samples (the 19.2 s trajectory, VIBA2 15 s after the IMU
    initialisation), the first of the depth settings (160 x 24, 240 x 16,
    320 x 12) on which the JAX package holds every gate of the fisheye
    loop test. Measured on the CPU (about 15 minutes): 160/160 frames
    tracked, 1 map, the IMU initialised, VIBA1 and VIBA2 done, fix_scale,
    4 loops closed (keyframes 5 <- 2 before the IMU initialisation, then
    17 <- 14, 30 <- 27 and 42 <- 38 on the inertial map, all before VIBA2:
    no correction took the yaw-only branch), 0 refused by the gravity
    gate, the gyro bias within 1.48e-4, metric ATE 0.01088 m over 160
    poses, Horn scale 1.00207, a consistent map."""
    r = jax_stereo_inertial_loop(160, 24, log=lambda *a: None)
    assert loop_gates_fail(r) == [], r


@pytest.mark.slow
def test_coo_solve_on_the_phase_11b_map_is_ill_conditioned():
    """Why phase 11c gates the COO tier's normal equations, final cost and
    inlier verdicts, but not the solved states, card against CPU: on phase
    11b's final map (rebuilt here by ``chip_smoke.vi_loop_path`` at
    376x240 with 512 features: 54 keyframes, C = 56) a N(0, 1e-7) m nudge
    of the points moves the port's solve by centimetres, and the JAX
    package's ``_ba_solve_coo`` on the same problem lies as far from it,
    also after a similarity alignment of the camera centres. Measured on
    the CPU (about 3 minutes): the nudge moved a translation by 0.192 m
    and a point by 0.474 m, JAX lies 0.0356 m and 0.845 m away, camera
    centres 0.0907 / 0.0100 m apart after the alignment; final robust
    costs 2457.7 (port), 2458.3 (nudged), 2457.8 (JAX)."""
    from orb_slam3_detailed_comments_tpu.optim import ba as jba
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig)
    from orb_slam3_detailed_comments_tpu_torch.optim import ba, reproj
    from orb_slam3_detailed_comments_tpu_torch.pipeline import local_mapping
    from orb_slam3_detailed_comments_tpu_torch.pipeline.tracking import (
        TrackingConfig)
    kw = dict(fx=200.0, fy=200.0, cx=188.0, cy=120.0, width=376, height=240)
    chip_smoke.vi_loop_path(torch.device("cpu"), cam_kw=kw,
                            map_cfg=MapConfig(max_kf=96, max_pt=8192,
                                              n_feat=512),
                            track_cfg=TrackingConfig(n_features=512))
    snap = chip_smoke.FINAL_MAPS["11b"]
    m = mapstore.MapStore.from_numpy(snap["map"], snap["map_cfg"], "cpu")
    window = [int(k) for k in m.kf_ids()]
    prob, meta = local_mapping.build_ba_problem(
        m, window, fixed=window[:1], max_points=m.cfg.max_pt // 2,
        max_obs=local_mapping.full_obs_cap(m))
    assert ba.tier_of(int(prob.kf_R.shape[0])) == "coo"
    cam = snap["cam"]

    def solve(p):
        r = ba._ba_solve_coo(p, cam, 10, reproj.CHI2_MONO, 1e-4)
        return [np.asarray(x) for x in (r.kf_R, r.kf_t, r.points)], \
            float(r.cost)

    (R0, t0, X0), c0 = solve(prob)
    nudged = prob._replace(points=prob.points + torch.as_tensor(
        np.random.default_rng(0).normal(0, 1e-7, prob.points.shape),
        dtype=torch.float32))
    (R1, t1, X1), c1 = solve(nudged)
    jp = jba.BAProblem(**{f: jnp.asarray(getattr(prob, f).numpy())
                          for f in prob._fields})
    rj = jba._ba_solve_coo(jp, jcameras.pinhole(**kw), 10, reproj.CHI2_MONO,
                           1e-4)
    R2, t2, X2 = (np.asarray(x) for x in (rj.kf_R, rj.kf_t, rj.points))
    n = meta["n_real"]

    def aligned_gap(R, t):
        a = -np.einsum("nji,nj->ni", R[:n], t[:n])
        b = -np.einsum("nji,nj->ni", R0[:n], t0[:n])
        A, B = a - a.mean(0), b - b.mean(0)
        U, S, Vt = np.linalg.svd(B.T @ A / n)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        Rs = U @ D @ Vt
        s = np.trace(np.diag(S) @ D) / (A ** 2).sum(1).mean()
        return np.abs(s * A @ Rs.T - B).max()

    gaps = dict(nudge=(np.abs(t1 - t0).max(), np.abs(X1 - X0).max(),
                       aligned_gap(R1, t1), c1),
                jax=(np.abs(t2 - t0).max(), np.abs(X2 - X0).max(),
                     aligned_gap(R2, t2), float(rj.cost)))
    print(f"port cost {c0}; (translation, point, aligned centre gaps, "
          f"cost): {gaps}")
    for t_gap, x_gap, centre_gap, c in gaps.values():
        assert t_gap > 1e-3 and x_gap > 1e-2 and centre_gap > 1e-3
        assert abs(c / c0 - 1) < 0.03


def loop_gates_fail(r):
    """The gates of ``test_fisheye_stereo_inertial_loop_closure``; returns
    the ones that fail."""
    n = r["n"]
    checks = {
        "tracked > 0.8 n": r["tracked"] > 0.8 * n,
        "one map": r["maps"] == 1,
        "imu initialised": r["imu_initialized"],
        "VIBA1 and VIBA2": r["imu_ba1"] and r["imu_ba2"],
        "fix_scale": r["fix_scale"],
        ">= 1 loop": r["loops"] >= 1,
        "bg within 8e-3": r["bg_err"] < 8e-3,
        "metric ATE < 0.25 m": r["ate"] < 0.25,
        "pairs > 0.7 n": r["npair"] > 0.7 * n,
        "|s - 1| < 0.06": abs(r["scale"] - 1.0) < 0.06,
        "consistent map": r["consistency"] == [],
    }
    return [k for k, ok in checks.items() if not ok]


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    res = jax_stereo_inertial_loop(int(sys.argv[1]), int(sys.argv[2]))
    print(res)
    print("failed gates:", loop_gates_fail(res))
