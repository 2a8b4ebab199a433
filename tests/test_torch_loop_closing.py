"""The port's loop closing, map merging and multi-map System against the
JAX package.

A synthetic visual map (``test_full_inertial_ba.build_inertial_map`` with
its IMU state switched off: 20 keyframes on a trajectory, 300 points, the
features carrying their points' descriptors) is given a loop: the last
keyframes drift from the truth (4 mrad, 1.5 cm) and observe duplicates of
their points. From the same snapshot each package then:

- runs the guided projection match through a Sim3 (the same point ids and
  features, exactly);
- verifies the pair (both accept, Sim3 within 1e-2: each RANSAC draws its
  own minimal sets);
- replays one loop correction, ``_correct_loop``, with the same Sim3:
  without global BA the corrected poses and points agree within 1e-4 and
  the fused observations exactly; with the synchronous global BA (3 table
  rounds) the poses agree within 1e-3 and both maps stay consistent;
- welds one map into another (``Atlas.merge_map_into_active``): the same
  arrays within 1e-5, the same links.

``TestMergeEssentialGraph`` mirrors the visual class of
``tests/test_merge_parity.py`` (its gates on the port, the port's poses
within 1e-3 of JAX's). ``test_loop_detected_and_trajectory_consistent``
mirrors the 140-frame loop test at 376x240 with 512 features; it takes
about 4 minutes on the CPU and is marked slow. The System's merge runs in
``tests/test_torch_multimap.py``.
"""
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import Sim3 as JSim3, so3 as jso3
from orb_slam3_detailed_comments_tpu.mapping import atlas as jatlas
from orb_slam3_detailed_comments_tpu.pipeline import loop_closing as jlc
from orb_slam3_detailed_comments_tpu_torch.mapping import atlas, mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import (
    loop_closing, system, tracking)
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

from synthetic import CAM as JCAM
from test_full_inertial_ba import build_inertial_map
from test_merge_parity import _pose_err

torch.set_num_threads(2)
CAM = cameras.pinhole(fx=458.0, fy=457.0, cx=367.0, cy=248.0, width=752,
                      height=480)
CFG = dict(max_kf=32, max_pt=512, n_feat=256)


def _to_port(jm):
    arrays = {k: v for k, v in vars(jm).items() if isinstance(v, np.ndarray)}
    arrays["tombstones"] = copy.deepcopy(jm.tombstones)
    return mapstore.MapStore.from_numpy(arrays, mapstore.MapConfig(**CFG),
                                        "cpu")


def _flip_bits(rng, d, bits):
    d = d.copy()
    for row in d:
        for _ in range(bits):
            row[rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(
                rng.integers(0, 32))
    return d


@pytest.fixture(scope="module")
def loop_map():
    return _make_loop_map()


def _make_loop_map():
    """(JAX map, k, c, S_kc as (R, t, s), true poses): keyframe k at the
    loop's end re-observes c's area through duplicate points and has
    drifted."""
    rng = np.random.default_rng(21)
    jm, truth = build_inertial_map(rng, n_kf=19, n_pts=300, pose_noise=0.0,
                                   vel_noise=0.0)
    jm.imu_initialized = False
    kfs = [int(k) for k in truth["kf_ids"]]
    for k in kfs:
        fp = jm.kf_feat_point[k]
        sel = fp >= 0
        jm.kf_feat_desc[k][sel] = _flip_bits(rng, jm.pt_desc[fp[sel]], 2)
        xy = jm.kf_feat_xy[k][sel]
        jm.kf_feat_xyn[k][sel] = np.stack(
            [(xy[:, 0] - JCAM.cx) / JCAM.fx, (xy[:, 1] - JCAM.cy) / JCAM.fy],
            1)
    jm.update_point_stats(np.where(jm.pt_valid)[0])
    k, c = kfs[-1], kfs[0]
    T_true = {x: (jm.kf_R[x].copy(), jm.kf_t[x].copy()) for x in kfs}
    # duplicates: the last 4 keyframes observe copies of their points
    dup_src = np.unique(np.concatenate(
        [jm.kf_feat_point[x][jm.kf_feat_point[x] >= 0] for x in kfs[-4:]]))
    early = np.concatenate([jm.kf_feat_point[x] for x in kfs[:-4]])
    dup_src = np.intersect1d(dup_src, early[early >= 0])[:120]
    new = jm.alloc_points(len(dup_src))
    jm.pt_xyz[new] = jm.pt_xyz[dup_src] + rng.normal(
        0, 0.01, (len(new), 3)).astype(np.float32)
    jm.pt_desc[new] = jm.pt_desc[dup_src]
    jm.pt_valid[new] = True
    jm.pt_ref_kf[new] = k
    lut = dict(zip(dup_src.tolist(), new.tolist()))
    for x in kfs[-4:]:
        row = jm.kf_feat_point[x]
        for i, p in enumerate(row):
            if int(p) in lut:
                row[i] = lut[int(p)]
    jm.update_point_stats(new)
    # drift: the last 6 keyframes and the duplicates they made sit in a
    # world moved by D (R' = R Rd^T, t' = t - R' td; x' = Rd x + td)
    Rd = np.asarray(jso3.exp(jnp.asarray([0.0, 0.004, 0.002], jnp.float32)))
    td = np.array([0.012, -0.004, 0.006], np.float32)
    for x in kfs[-6:]:
        jm.kf_R[x] = jm.kf_R[x] @ Rd.T
        jm.kf_t[x] = jm.kf_t[x] - jm.kf_R[x] @ td
    jm.pt_xyz[new] = jm.pt_xyz[new] @ Rd.T + td
    jm.update_point_stats(new)
    jm.version += 1
    # the loop measurement: the true relative pose k <- c at scale 1.01
    Rk, tk = T_true[k]
    Rc, tc = jm.kf_R[c], jm.kf_t[c]
    R_kc = Rk @ Rc.T
    S = (R_kc.astype(np.float32), ((tk - R_kc @ tc) * 1.0).astype(
        np.float32), 1.01)
    return jm, k, c, S, T_true


def _both(loop_map):
    jm, k, c, S, T_true = loop_map
    jm = copy.deepcopy(jm)
    return jm, _to_port(jm), k, c, S


def test_match_by_projection_pairs_equals_jax(loop_map):
    jm, m, k, c, (R, t, s) = _both(loop_map)
    mine = loop_closing.match_by_projection_pairs(
        m, k, m, c, loop_closing.host_sim3(R, t, s), CAM)
    ref = jlc.match_by_projection_pairs(
        jm, k, jm, c, JSim3(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)),
        JCAM)
    np.testing.assert_array_equal(mine[0], ref[0])
    np.testing.assert_array_equal(mine[1], ref[1])
    assert len(mine[0]) >= 30
    assert loop_closing.count_projection_matches(
        m, k, m, c, loop_closing.host_sim3(R, t, s), CAM) == len(ref[0])


def test_verify_sim3_pair_agrees_with_jax(loop_map):
    jm, m, k, c, _ = _both(loop_map)
    cfg = loop_closing.LoopClosingConfig()
    mine = loop_closing.verify_sim3_pair(m, k, m, c, CAM, cfg)
    ref = jlc.verify_sim3_pair(jm, k, jm, c, JCAM, jlc.LoopClosingConfig())
    assert mine is not None and ref is not None
    assert mine[0] == ref[0] == c
    for a, b in zip(loop_closing.sim3_np(mine[1]),
                    (np.asarray(ref[1].R), np.asarray(ref[1].t),
                     float(ref[1].s))):
        np.testing.assert_allclose(a, b, atol=1e-2)


@pytest.mark.parametrize("gba", [False, True], ids=["graph+fuse", "with-gba"])
def test_correct_loop_replay_matches_jax(loop_map, gba):
    jm, m, k, c, (R, t, s) = _both(loop_map)
    n_pts0 = int(m.pt_valid.sum())
    jcl = jlc.LoopCloser(jm, JCAM, None, jlc.LoopClosingConfig(
        run_global_ba=gba))
    pcl = loop_closing.LoopCloser(m, CAM, None,
                                  loop_closing.LoopClosingConfig(
                                      run_global_ba=gba))
    assert jcl._correct_loop(k, c, JSim3(jnp.asarray(R), jnp.asarray(t),
                                         jnp.asarray(s)))
    assert pcl._correct_loop(k, c, loop_closing.host_sim3(R, t, s))
    kfs = m.kf_ids()
    tol = 1e-3 if gba else 1e-4
    np.testing.assert_allclose(m.kf_R[kfs], jm.kf_R[kfs], atol=tol)
    np.testing.assert_allclose(m.kf_t[kfs], jm.kf_t[kfs], atol=tol)
    np.testing.assert_array_equal(m.pt_valid, jm.pt_valid)
    pv = m.pt_valid
    np.testing.assert_allclose(m.pt_xyz[pv], jm.pt_xyz[pv], atol=10 * tol)
    if not gba:
        np.testing.assert_array_equal(m.kf_feat_point, jm.kf_feat_point)
    # the duplicates were fused away
    assert int(m.pt_valid.sum()) < n_pts0 - 50
    # the same map checks (the JAX fuse can leave a fused-into point with
    # no observer on this map; the port keeps that behaviour)
    assert m.check_invariants() == jm.check_invariants()
    assert m.big_change_idx == jm.big_change_idx == 1
    if gba:
        assert pcl.last_correction["gba"] == [dict(C=24, tier="table")] * 3


def test_merge_map_into_active_equals_jax(loop_map):
    jm, m, k, c, _ = _both(loop_map)
    ja = jatlas.Atlas(jm.cfg)
    pa = atlas.Atlas(mapstore.MapConfig(**CFG), "cpu")
    ja.maps[0], pa.maps[0] = jm, m
    ja.create_new_map()
    pa.create_new_map()
    # a small active map: two keyframes of the stored map's first views
    for a, src in ((ja, jm), (pa, m)):
        for x in (0, 1):
            a.active.add_keyframe(src.kf_R[x], src.kf_t[x], 0.0, 100 + x,
                                  src.kf_feat_xy[x], src.kf_feat_xyn[x],
                                  src.kf_feat_level[x], src.kf_feat_angle[x],
                                  src.kf_feat_desc[x], src.kf_feat_valid[x],
                                  np.full(CFG["n_feat"], -1, np.int32))
    m.remove_keyframe(3)             # rows anchored to it replay after the
    jm.remove_keyframe(3)            # weld through its tombstone
    R = np.asarray(jso3.exp(jnp.asarray([0.1, -0.05, 0.2], jnp.float32)))
    t = np.array([0.3, -0.2, 0.5], np.float32)
    s_mine = pa.merge_map_into_active(0, loop_closing.host_sim3(R, t, 1.2))
    s_ref = ja.merge_map_into_active(0, JSim3(jnp.asarray(R), jnp.asarray(t),
                                              jnp.asarray(1.2)))
    assert s_mine == s_ref and pa.n_merges == ja.n_merges == 1
    A, J = pa.active, ja.active
    for name in ("kf_R", "kf_t", "pt_xyz", "pt_normal", "pt_min_dist"):
        np.testing.assert_allclose(getattr(A, name), getattr(J, name),
                                   atol=1e-5, err_msg=name)
    for name in ("kf_valid", "pt_valid", "kf_feat_point", "pt_ref_kf"):
        np.testing.assert_array_equal(getattr(A, name), getattr(J, name))
    assert pa.maps[0].n_kf == 0
    assert A.check_invariants() == J.check_invariants()
    for key, v in ja.kf_redirect.items():
        assert pa.kf_redirect[key][:3] == v[:3]
    # the culled keyframe's rows resolve through the welded map (the JAX
    # package drops them with the retired store)
    dead = (0, 3, int(m.kf_epoch[3]))
    assert pa.resolve_kf_pose(*dead) is not None
    assert ja.resolve_kf_pose(*dead) is None


class TestMergeEssentialGraph:
    """tests/test_merge_parity.py's visual class, on both packages."""

    def _perturbed(self, rng, n_kf):
        jm, truth = build_inertial_map(rng, n_kf=n_kf, pose_noise=0.0,
                                       vel_noise=0.0)
        jm.imu_initialized = False
        kf_ids = [int(k) for k in truth["kf_ids"]]
        return jm, kf_ids

    def test_weld_refinement_propagates_to_far_end(self, rng):
        jm, kf_ids = self._perturbed(rng, 24)
        R_true = {k: jm.kf_R[k].copy() for k in kf_ids}
        t_true = {k: jm.kf_t[k].copy() for k in kf_ids}
        pt_true = jm.pt_xyz.copy()
        R_d = np.asarray(jso3.exp(jnp.asarray([0.02, -0.03, 0.08],
                                              jnp.float32)))
        t_d = np.array([0.25, -0.15, 0.1], np.float32)
        for k in kf_ids:
            jm.kf_R[k] = R_true[k] @ R_d.T
            jm.kf_t[k] = t_true[k] - jm.kf_R[k] @ t_d
        pv = jm.pt_valid
        jm.pt_xyz[pv] = jm.pt_xyz[pv] @ R_d.T + t_d
        pts = np.where(pv)[0]
        jm.pt_ref_kf[pts] = rng.choice(kf_ids[6:], size=len(pts))
        snap_R, snap_t = jm.kf_R.copy(), jm.kf_t.copy()
        window = kf_ids[:6]
        for k in window:
            jm.kf_R[k] = R_true[k]
            jm.kf_t[k] = t_true[k]
        m = _to_port(jm)
        far = kf_ids[-1]
        err_before, _ = _pose_err(m, far, R_true[far], t_true[far])
        assert err_before > 0.15
        loop_closing.run_merge_essential_graph(m, snap_R, snap_t, set(window))
        jlc.run_merge_essential_graph(jm, snap_R, snap_t, set(window),
                                      inertial=False, fix_scale=False)
        np.testing.assert_allclose(m.kf_R, jm.kf_R, atol=1e-3)
        np.testing.assert_allclose(m.kf_t, jm.kf_t, atol=1e-3)
        np.testing.assert_allclose(m.pt_xyz[pv], jm.pt_xyz[pv], atol=1e-3)
        err_after, ang_after = _pose_err(m, far, R_true[far], t_true[far])
        assert err_after < 0.15 * err_before and ang_after < 0.02
        for k in kf_ids:
            assert _pose_err(m, k, R_true[k], t_true[k])[0] < 0.05
        pt_err = np.linalg.norm(m.pt_xyz[pv] - pt_true[pv], axis=1)
        assert np.median(pt_err) < 0.05

    def test_noop_when_nothing_moved(self, rng):
        jm, kf_ids = self._perturbed(rng, 10)
        m = _to_port(jm)
        snap_R, snap_t = m.kf_R.copy(), m.kf_t.copy()
        loop_closing.run_merge_essential_graph(m, snap_R, snap_t,
                                               set(kf_ids[:4]))
        np.testing.assert_allclose(m.kf_R, snap_R, atol=1e-4)
        np.testing.assert_allclose(m.kf_t, snap_t, atol=1e-4)


@pytest.mark.slow
def test_loop_detected_and_trajectory_consistent():
    """test_loop_detected_and_trajectory_consistent's gates on the port at
    376x240 with 512 features (box world seed 11, 140 frames of
    loop_trajectory(radius=3, closes=1.05), fx = fy = 200)."""
    cam = cameras.pinhole(fx=200.0, fy=200.0, cx=188.0, cy=120.0, width=376,
                          height=240)
    n = 140
    walls = synth_render.box_world(np.random.default_rng(11))
    R, t = synth_render.loop_trajectory(n, radius=3.0, closes=1.05)
    slam = system.System(
        cam, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=64, max_pt=4096, n_feat=512),
        tracking_cfg=tracking.TrackingConfig(n_features=512,
                                             min_init_matches=50),
        device="cpu")
    ts = np.arange(n) * 0.05
    n_ok = sum(slam.track_monocular(
        synth_render.render_image(cam, walls, R[i], t[i], "cpu"),
        float(ts[i])) is not None for i in range(n))
    assert n_ok > 0.7 * n, f"tracked {n_ok}/{n}"
    assert slam.loop_closer is not None
    assert slam.loop_closer.n_loops_closed >= 1
    rows = slam.trajectory_tum()
    rmse, n_ate, scale = evaluate_ate.ate_rmse(
        ts, synth_render.camera_centers(R, t), np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    print(f"loop at 376x240: {n_ok}/{n} tracked, {slam.n_keyframes} KF, "
          f"{slam.loop_closer.n_loops_closed} loops, ATE {rmse:.5f} m over "
          f"{n_ate} poses, global BA {slam.loop_closer.last_correction}")
    assert rmse < 0.20, f"ATE {rmse:.3f} m over {n_ate} poses"
    assert slam.check_map_consistency() == []
