"""The port's racing global BA against the JAX package's, on the CPU: the
apply with propagation to keyframes and points born during the solve
(visual and inertial), the chunked solve launched on its thread and waited
for, and the abort protocol (``tests/test_loop_closing.py``'s
``TestAsyncGlobalBA`` and ``tests/test_full_inertial_ba.py``'s racing
tests). Maps cross between the packages through ``MapStore.from_numpy``.

Tolerances: the applies within 1e-5 of JAX's on the same snapshot, meta
and result; the racing solves' keyframe states within 1e-3 of JAX's (the
same chunk sequence: LM restarts its damping each chunk) and points within
2e-3, with the JAX tests' gates on the port's map; an aborted run leaves
the map equal to the bit.
"""
import threading

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.optim import ba as jba
from orb_slam3_detailed_comments_tpu.optim import vi_ba as jvi_ba
from orb_slam3_detailed_comments_tpu.pipeline import inertial as jin
from orb_slam3_detailed_comments_tpu.pipeline import local_mapping as jlm
from orb_slam3_detailed_comments_tpu.pipeline import loop_closing as jlc
from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.optim import ba, vi_ba
from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing

import synthetic
from test_full_inertial_ba import (build_inertial_map,
                                   chain_preintegration_residuals)
from test_imu import CAL
import test_loop_closing

torch.set_num_threads(2)

JCAM = synthetic.CAM
CAM = cameras.pinhole(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width,
                      JCAM.height)
TCAL = tpre.ImuCalib.default()
SCENE_CFG = mapstore.MapConfig(max_kf=16, max_pt=512, n_feat=128)
VI_CFG = mapstore.MapConfig(max_kf=32, max_pt=512, n_feat=256)
STATE = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")


def _scene_map(rng):
    """TestAsyncGlobalBA's scene (its class is not imported here, so that
    its tests are not collected twice)."""
    return test_loop_closing.TestAsyncGlobalBA()._scene_map(rng)


def _port(jm, cfg):
    return mapstore.MapStore.from_numpy(vars(jm), cfg, device="cpu")


def _assert_maps(jm, tm, pose, pts, fields=("kf_R", "kf_t")):
    for f in fields:
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f),
                                   atol=pose, err_msg=f)
    np.testing.assert_allclose(tm.pt_xyz, jm.pt_xyz, atol=pts)
    np.testing.assert_array_equal(tm.pt_valid, jm.pt_valid)
    np.testing.assert_array_equal(tm.kf_feat_point, jm.kf_feat_point)


def _closers(jm, tm, calib=False, **cfg):
    jl = jlc.LoopCloser(jm, JCAM, kfdb=None, cfg=jlc.LoopClosingConfig(
        async_gba=True, dist_gba=False, **cfg))
    tl = loop_closing.LoopCloser(tm, CAM, kfdb=None,
                                 cfg=loop_closing.LoopClosingConfig(
                                     async_gba=True, **cfg))
    jl.map_lock, tl.map_lock = threading.RLock(), threading.RLock()
    if calib:
        jl.imu_calib, tl.imu_calib = CAL, TCAL
    return jl, tl


def test_apply_gba_with_propagation_matches_jax():
    """TestAsyncGlobalBA's snapshot, a keyframe and a point born during
    the solve, a result that moves the snapshot rigidly plus noise and
    calls 5 observations outliers: both packages write the same map."""
    from tests import synthetic as tsyn
    rng = np.random.default_rng(3)
    jm, sc = _scene_map(rng)
    prob, meta = jlm.build_ba_problem(jm, [0, 1, 2, 3], fixed=[0])
    R4 = sc["R"][3].copy()
    t4 = sc["t"][3] + np.array([0.2, 0.0, 0.1], np.float32)
    fp = np.full(128, -1, np.int32)
    fp[:4] = np.asarray(meta["pt_ids"])[:4]     # late observations too
    k4 = jm.add_keyframe(R4, t4, 0.4, 4, np.zeros((128, 2), np.float32),
                         np.zeros((128, 2), np.float32),
                         np.zeros(128, np.int32), np.zeros(128, np.float32),
                         np.zeros((128, 8), np.uint32), fp >= 0, fp)
    jm.kf_prev[k4] = 3
    jm.add_points(np.array([[0.5, -0.3, 1.0]], np.float32),
                  np.zeros((1, 8), np.uint32), ref_kf=k4)
    tm = _port(jm, SCENE_CFG)

    Rd = tsyn.rotvec_to_R([0.02, -0.05, 0.03]).astype(np.float32)
    td = np.array([0.3, -0.1, 0.2], np.float32)
    C = np.asarray(prob.kf_R).shape[0]
    pt_ids = np.asarray(meta["pt_ids"])
    res_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    res_t = np.zeros((C, 3), np.float32)
    for i in range(meta["n_real"]):
        c = meta["cams"][i]
        res_R[i] = jm.kf_R[c] @ Rd.T
        res_t[i] = jm.kf_t[c] - res_R[i] @ td + rng.normal(0, 1e-3, 3)
    res_pts = np.zeros_like(np.asarray(prob.points))
    res_pts[: len(pt_ids)] = (jm.pt_xyz[pt_ids] @ Rd.T + td
                              + rng.normal(0, 1e-3, (len(pt_ids), 3)))
    inl = np.ones(np.asarray(prob.obs_cam).shape[0], bool)
    inl[rng.choice(len(meta["keep"]), 5, replace=False)] = False
    jlc.apply_gba_with_propagation(jm, meta, jba.BAResult(
        kf_R=res_R, kf_t=res_t, points=res_pts, obs_inlier=inl,
        cost=np.float32(0.0)))
    loop_closing.apply_gba_with_propagation(tm, meta, ba.BAResult(
        kf_R=torch.from_numpy(res_R), kf_t=torch.from_numpy(res_t),
        points=torch.from_numpy(res_pts), obs_inlier=torch.from_numpy(inl),
        cost=torch.tensor(0.0)))
    _assert_maps(jm, tm, 1e-5, 1e-5)
    assert tm.version > 0 and tm.big_change_idx == jm.big_change_idx
    # the late keyframe carries the snapshot's correction
    np.testing.assert_allclose(tm.kf_R[k4], R4 @ Rd.T, atol=1e-3)


def test_apply_vi_gba_with_propagation_matches_jax(rng):
    """The full-chain inertial snapshot of build_inertial_map, a keyframe
    (chained to the newest) and a point born during the solve, a result of
    perturbed body states: poses, velocities, biases and points equal."""
    jm, _ = build_inertial_map(rng)
    chain = [int(k) for k in jm.temporal_chain()]
    prob, meta = jin.build_full_viba_problem(jm, chain, CAL)
    last = chain[-1]
    k_new = jm.add_keyframe(
        jm.kf_R[last].copy(), jm.kf_t[last] + np.float32([0.05, 0, 0]), 9.0,
        99, np.zeros((256, 2), np.float32), np.zeros((256, 2), np.float32),
        np.zeros(256, np.int32), np.zeros(256, np.float32),
        np.zeros((256, 8), np.uint32), np.zeros(256, bool),
        np.full(256, -1, np.int32))
    jm.kf_prev[k_new] = last
    jm.kf_vel[k_new] = np.float32([0.3, -0.1, 0.2])
    jm.add_points(np.array([[0.4, 0.2, 6.0]], np.float32),
                  np.zeros((1, 8), np.uint32), ref_kf=k_new)
    tm = _port(jm, VI_CFG)
    st = {f: np.array(getattr(prob, f)) for f in
          ("R_wb", "p_w", "v_w", "bg", "ba", "points")}
    st["p_w"] += rng.normal(0, 0.01, st["p_w"].shape).astype(np.float32)
    st["v_w"] += rng.normal(0, 0.05, st["v_w"].shape).astype(np.float32)
    st["bg"] += np.float32(1e-3)
    st["points"] += rng.normal(0, 0.01, st["points"].shape).astype(
        np.float32)
    inl = np.ones(np.asarray(prob.obs_cam).shape[0], bool)
    inl[:3] = False
    jres = jvi_ba.VIBAResult(**st, obs_inlier=inl, cost=np.float32(0.0))
    tres = vi_ba.VIBAResult(**{k: torch.from_numpy(v) for k, v in st.items()},
                            obs_inlier=torch.from_numpy(inl),
                            cost=torch.tensor(0.0))
    tmeta = {k: (np.asarray(v) if k in ("R_bc", "t_bc", "t_cb") else v)
             for k, v in meta.items()}
    jlc.apply_vi_gba_with_propagation(jm, meta, jres)
    loop_closing.apply_vi_gba_with_propagation(tm, tmeta, tres)
    _assert_maps(jm, tm, 1e-5, 1e-5, STATE)
    assert np.abs(tm.kf_vel[k_new] - np.float32([0.3, -0.1, 0.2])).max() > 0


def test_racing_gba_matches_jax():
    """TestAsyncGlobalBA.test_async_solve_applies_and_abort_discards'
    solve (gba_iters=6, gba_chunk=3) in both packages."""
    rng = np.random.default_rng(7)
    jm, sc = _scene_map(rng)
    jm.kf_t[1:4] += rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    jm.pt_xyz[:120] += rng.normal(0, 0.02, (120, 3)).astype(np.float32)
    tm = _port(jm, SCENE_CFG)
    err0 = float(np.abs(tm.kf_t[1:4] - sc["t"][1:4]).max())
    jl, tl = _closers(jm, tm, gba_iters=6, gba_chunk=3)
    for lc in (jl, tl):
        lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
        lc.wait_gba()
        assert lc.n_gba_runs == 1 and lc.n_gba_aborted == 0
    err1 = float(np.abs(tm.kf_t[1:4] - sc["t"][1:4]).max())
    assert err1 < 0.5 * err0, (err0, err1)
    _assert_maps(jm, tm, 1e-3, 2e-3)
    assert tl.gba_log[-1]["kind"] == "visual" and tl.gba_log[-1]["applied"]


def test_racing_inertial_gba_matches_jax(rng):
    """test_post_loop_inertial_gba_reconciles_velocities (gba_iters=10,
    gba_chunk=5) in both packages, with that test's gates on the port."""
    jm, truth = build_inertial_map(rng, vel_noise=0.4)
    tm = _port(jm, VI_CFG)
    v_before = tm.kf_vel.copy()
    res0 = chain_preintegration_residuals(jm)
    jl, tl = _closers(jm, tm, calib=True, gba_iters=10, gba_chunk=5)
    window = [int(k) for k in jm.kf_ids()]
    for lc in (jl, tl):
        lc._launch_global_ba(window, anchor=window[:1])
        lc.wait_gba()
        assert lc.n_gba_runs == 1 and lc.n_gba_aborted == 0
    _assert_maps(jm, tm, 1e-3, 2e-3, STATE)
    assert (tm.kf_vel != v_before).any()
    for f in STATE:
        setattr(jm, f, getattr(tm, f).copy())
    res1 = chain_preintegration_residuals(jm)
    assert res1 < 0.25 * res0, (res0, res1)
    v_err = max(np.linalg.norm(tm.kf_vel[k] - truth["v"][i])
                for i, k in enumerate(truth["kf_ids"]))
    assert v_err < 0.1, v_err
    assert tl.gba_log[-1]["kind"] == "inertial"


@pytest.mark.parametrize("inertial", [False, True])
def test_abort_discards_racing_gba(inertial):
    """A long run (gba_iters=400, gba_chunk=1) aborted at once: counted,
    and the map (poses, points, velocities) equal to the bit."""
    rng = np.random.default_rng(7)
    if inertial:
        jm, _ = build_inertial_map(rng)
        tm = _port(jm, VI_CFG)
    else:
        jm, _ = _scene_map(rng)
        tm = _port(jm, SCENE_CFG)
    before = {f: getattr(tm, f).copy() for f in STATE + ("pt_xyz",)}
    v0 = tm.version
    lc = loop_closing.LoopCloser(tm, CAM, kfdb=None,
                                 cfg=loop_closing.LoopClosingConfig(
                                     async_gba=True, gba_iters=400,
                                     gba_chunk=1))
    lc.map_lock = threading.RLock()
    lc.imu_calib = TCAL if inertial else None
    lc._launch_global_ba([int(k) for k in tm.kf_ids()], anchor=[0])
    lc.abort_gba()
    assert lc.n_gba_aborted >= 1 and lc.n_gba_runs == 0
    assert tm.version == v0
    for f, a in before.items():
        np.testing.assert_array_equal(getattr(tm, f), a, err_msg=f)


def test_abort_waits_out_a_held_map_lock():
    """An aborter that holds the map lock while the finished solve waits
    to apply: the worker's timed acquire sees the abort and gives up (no
    deadlock), and the map is untouched."""
    rng = np.random.default_rng(7)
    jm, _ = _scene_map(rng)
    tm = _port(jm, SCENE_CFG)
    t0 = tm.kf_t.copy()
    lc = loop_closing.LoopCloser(tm, CAM, kfdb=None,
                                 cfg=loop_closing.LoopClosingConfig(
                                     async_gba=True, gba_iters=2,
                                     gba_chunk=1))
    lc.map_lock = threading.RLock()
    at_lock = threading.Event()
    apply = lc._apply_under_lock

    def marked(fn, abort):
        at_lock.set()
        apply(fn, abort)

    lc._apply_under_lock = marked
    with lc.map_lock:
        lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
        assert at_lock.wait(timeout=60)
        lc._gba_thread.join(timeout=0.3)     # a few timed acquires fail
        lc.abort_gba()
    assert lc.n_gba_aborted == 1 and lc.n_gba_runs == 0
    assert lc.gba_log[-1]["aborted"] and not lc.gba_log[-1]["applied"]
    np.testing.assert_array_equal(tm.kf_t, t0)


def test_run_outliving_its_abort_does_not_apply():
    """A run whose abort was set but whose thread outlived abort_gba's join
    (the aborter gave up and dropped the thread) reads its own abort flag,
    not the next launch's: it discards its result, and the next run
    applies."""
    rng = np.random.default_rng(7)
    jm, _ = _scene_map(rng)
    tm = _port(jm, SCENE_CFG)
    lc = loop_closing.LoopCloser(tm, CAM, kfdb=None,
                                 cfg=loop_closing.LoopClosingConfig(
                                     async_gba=True, gba_iters=2,
                                     gba_chunk=1))
    lc.map_lock = threading.RLock()
    at_lock = threading.Semaphore(0)
    apply = lc._apply_under_lock

    def marked(fn, abort):
        at_lock.release()
        apply(fn, abort)

    lc._apply_under_lock = marked
    with lc.map_lock:
        lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
        assert at_lock.acquire(timeout=60)
        stale = lc._gba_thread
        # what abort_gba leaves when its join times out
        lc._gba_abort.set()
        lc._gba_thread = None
        lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
        assert at_lock.acquire(timeout=60)
    lc.wait_gba()
    stale.join(timeout=60)
    assert lc.n_gba_aborted == 1 and lc.n_gba_runs == 1
    assert sorted(r["applied"] for r in lc.gba_log) == [False, True]


def replay_card_map(path: str, iters: int = 10):
    """Replay chip_smoke.py phase 10c's racing inertial global BA on the
    map the card ran it on (``chiprun_out/map_9a.npz``: the map arrays,
    ``imu_flags``, ``map_cfg``, ``cam``), with the port and with the JAX
    package, on the CPU:

        PYTHONPATH=.:tests JAX_PLATFORMS=cpu python \
            tests/test_torch_async.py chiprun_out/map_9a.npz [gba_iters]

    Prints, for each package, the runs applied and the temporal chain's
    largest preintegration residual before and after the solve, then the
    largest difference of each keyframe state between the two."""
    from orb_slam3_detailed_comments_tpu.imu import preintegration as jpre
    from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
    from orb_slam3_detailed_comments_tpu.models import cameras as jcameras

    import chip_smoke
    z = dict(np.load(path))
    max_kf, max_pt, n_feat, n_levels = (int(x) for x in z.pop("map_cfg"))
    fx, fy, cx, cy, w, h = z.pop("cam")
    flags = [bool(x) for x in z.pop("imu_flags")]
    cfg = dict(max_kf=max_kf, max_pt=max_pt, n_feat=n_feat,
               n_levels=n_levels)
    port = mapstore.MapStore.from_numpy(
        dict(z, imu_initialized=flags[0], imu_ba1=flags[1],
             imu_ba2=flags[2]), mapstore.MapConfig(**cfg), device="cpu")
    jm = jms.MapStore(jms.MapConfig(**cfg))
    for k, v in z.items():
        getattr(jm, k)[...] = v
    jm.imu_initialized, jm.imu_ba1, jm.imu_ba2 = flags
    runs = (
        ("port", port, lambda m: chip_smoke.chain_residual(m, TCAL),
         loop_closing.LoopCloser(
             port, cameras.pinhole(fx, fy, cx, cy, int(w), int(h)), None,
             loop_closing.LoopClosingConfig(async_gba=True,
                                            gba_iters=iters)), TCAL),
        ("jax", jm, chain_preintegration_residuals,
         jlc.LoopCloser(jm, jcameras.pinhole(fx, fy, cx, cy, int(w), int(h)),
                        None, jlc.LoopClosingConfig(
                            async_gba=True, dist_gba=False,
                            gba_iters=iters)), jpre.ImuCalib.default()))
    for name, m, residual, lc, calib in runs:
        lc.map_lock, lc.imu_calib = threading.RLock(), calib
        r0 = residual(m)
        window = [int(k) for k in m.kf_ids()]
        lc._launch_global_ba(window, window[:1])
        lc.wait_gba()
        print(f"{name}: {lc.n_gba_runs} run applied; chain residual "
              f"{r0} -> {residual(m)}")
    for f in STATE:
        print(f"{f}: largest port - JAX difference "
              f"{np.abs(getattr(port, f) - getattr(jm, f)).max()}")


if __name__ == "__main__":
    import sys
    replay_card_map(sys.argv[1], *(int(a) for a in sys.argv[2:]))
