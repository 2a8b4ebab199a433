"""The port's stereo and RGB-D tracker and System, on the CPU at 376x240
(fx 229) with 512 features.

Against the JAX package on shared inputs (the JAX package's prepared
frame and depth, handed to both trackers): ``_stereo_initialization``
creates the same points (within 1e-5 m, in the same slots) and keyframe;
``_create_depth_points`` selects the same features in the same order and
places them within 1e-5 m; ``TestNeedNewKeyFrameC1c`` mirrors
``tests/test_pipeline_stereo_rgbd.py:91-150`` on the port's tracker.

Port only: ``System(STEREO)`` and ``System(RGBD)`` over the first 16
frames of ``test_pipeline_stereo_rgbd.py``'s orbit (world seed 9),
rendered by ray casting at this size, held to the JAX tests' gates as they
stand (> 80 % of the frames tracked, metric ATE over > 0.7 n poses below
0.05 m for stereo and 0.04 m for RGB-D, |scale - 1| < 0.03 for stereo);
``track_stereo_iter`` gives ``track_stereo``'s poses bit for bit; the
inertial sensors and IMU input still raise. And the top-k dispatch of
``ops/topk.py``: cells 16 and 32 on the kernel, 24 on the plain version,
any number of levels.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.pipeline import kernels as jk
from orb_slam3_detailed_comments_tpu.pipeline import tracking as jtracking
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor, topk
from orb_slam3_detailed_comments_tpu_torch.pipeline import (
    kernels, system, tracking)
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM, JCAM = cameras.pinhole(**CAM_KW), jcam.pinhole(**CAM_KW)
BASELINE, N_FEAT, N_FRAMES = 0.11, 512, 16
BF = BASELINE * CAM.fx
MAP_KW = dict(max_kf=32, max_pt=4096, n_feat=N_FEAT)
TS = 0.05 * np.arange(N_FRAMES)


@pytest.fixture(scope="module")
def world():
    planes = synth_render.default_world(np.random.default_rng(9))
    R, t = synth_render.orbit_trajectory(40)
    pairs = [synth_render.render_stereo_pair(CAM, planes, R[i], t[i],
                                             BASELINE)
             for i in range(N_FRAMES)]
    return planes, R, t, pairs


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _shared_frame(pair):
    """(JAX prepared frame and depth, the same as port tensors)."""
    jp, jd, _ = jk.prepare_frame_stereo(jnp.asarray(pair[0]),
                                        jnp.asarray(pair[1]), JCAM, BF,
                                        jext.OrbConfig(n_features=N_FEAT))
    tp = kernels.PreparedFrame(extractor.FrameFeatures(
        *(_t(a) for a in jp.feat)), _t(jp.xy_ud), _t(jp.xyn))
    return jp, jd, tp, _t(jd)


def _trackers():
    jt = jtracking.Tracker(JCAM, jms.MapStore(jms.MapConfig(**MAP_KW)),
                           jtracking.TrackingConfig(n_features=N_FEAT),
                           sensor=jtracking.SENSOR_STEREO, bf=BF)
    tt = tracking.Tracker(CAM, mapstore.MapStore(
        mapstore.MapConfig(**MAP_KW), "cpu"),
        tracking.TrackingConfig(n_features=N_FEAT),
        sensor=tracking.SENSOR_STEREO, bf=BF, device="cpu")
    return jt, tt


def _same_points(jm, tm, atol=1e-5):
    np.testing.assert_array_equal(tm.pt_valid, jm.pt_valid)
    v = jm.pt_valid
    np.testing.assert_allclose(tm.pt_xyz[v], jm.pt_xyz[v], rtol=0, atol=atol)
    np.testing.assert_array_equal(tm.pt_desc[v],
                                  np.asarray(jm.pt_desc[v]).view(np.int32))
    np.testing.assert_array_equal(tm.pt_ref_kf[v], jm.pt_ref_kf[v])
    np.testing.assert_array_equal(tm.kf_feat_point, jm.kf_feat_point)


@pytest.fixture(scope="module")
def initialised(world):
    jp, jd, tp, td = _shared_frame(world[3][0])
    jt, tt = _trackers()
    jt._stereo_initialization(jp, jd, 0.0, 0)
    tt._stereo_initialization(tp, td, 0.0, 0)
    return jt, tt


def test_stereo_initialization_same_points(initialised):
    jt, tt = initialised
    assert jt.state == tt.state == tracking.OK
    assert jt.map.n_points == tt.map.n_points > 300
    assert jt.new_keyframes == tt.new_keyframes == [0]
    _same_points(jt.map, tt.map)
    for name in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(tt.map, name),
                                   getattr(jt.map, name), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(tt.cur_match, jt.cur_match)


def test_create_depth_points_same_selection(initialised, world):
    """A second keyframe (frame 5) whose first 100 features track points
    of the first: both trackers add the same close points, nearest first,
    into the same slots."""
    jt, tt = initialised
    jp, jd, tp, td = _shared_frame(world[3][5])
    R, t = world[1][5].astype(np.float32), world[2][5].astype(np.float32)
    match = np.full(N_FEAT, -1, np.int32)
    match[:100] = np.arange(100)
    n0 = jt.map.n_points
    # the port's tracked frame has its depth on the host by now: the
    # stage that tracked it fetched it
    for tk, prep, depth in ((jt, jp, jd), (tt, tp, td.numpy())):
        tk.cur_prep, tk.cur_depth, tk.cur_match = prep, depth, match.copy()
        tk.cur_T = type(tk.cur_T)(R, t)
    jt._create_new_keyframe(0.25, 5)
    tt._create_new_keyframe(0.25, 5)
    _same_points(jt.map, tt.map)
    # the rule: every free feature closer than th_depth, and at least the
    # 100 nearest
    z = np.array(jd)
    free = (match < 0) & np.array(jp.feat.valid) & (z > 0)
    want = max(100, int((free & (z <= tt.th_depth)).sum()))
    assert tt.map.n_points - n0 == min(want, int(free.sum()))
    made = tt.map.kf_feat_point[1] >= 0
    assert z[made & free].max() <= np.sort(z[free])[want - 1]


class TestNeedNewKeyFrameC1c:
    """The port of test_pipeline_stereo_rgbd.py's close-point condition
    (reference: bNeedToInsertClose + c1c, Tracking.cc:3674-3737)."""

    def _tracker(self):
        rng = np.random.default_rng(0)
        N = 256
        m = mapstore.MapStore(mapstore.MapConfig(max_kf=8, max_pt=512,
                                                 n_feat=N), "cpu")
        m.pt_xyz[:200] = rng.normal(0, 1, (200, 3)) + [0, 0, 5]
        m.pt_valid[:200] = True
        m.pt_ref_kf[:200] = 0
        fp = np.full(N, -1, np.int32)
        fp[:200] = np.arange(200)
        m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       0.0, 0, np.zeros((N, 2), np.float32),
                       np.zeros((N, 2), np.float32), np.zeros(N, np.int32),
                       np.zeros(N, np.float32), np.zeros((N, 8), np.int32),
                       np.ones(N, bool), fp)
        tr = tracking.Tracker(CAM, m, tracking.TrackingConfig(ref_ratio=0.75),
                              sensor=tracking.SENSOR_STEREO, bf=BF,
                              th_depth=35.0, device="cpu")
        tr.state = tracking.OK
        tr.ref_kf = 0
        tr.frame_id = 2                 # well inside min/max frame windows
        tr.last_kf_frame_id = 1
        tr._cur_valid = np.ones(N, bool)
        # the frame still tracks 180 of the anchor's 200 points: c2's decay
        # branch (0.75 * 200 = 150) is not met
        match = np.full(N, -1, np.int32)
        match[:180] = np.arange(180)
        tr.cur_match = match
        return tr

    def test_close_point_pressure_triggers(self):
        tr = self._tracker()
        depth = np.full(256, 100.0, np.float32)
        depth[180:] = 1.0               # 76 close, none of them matched
        tr.cur_depth = depth
        assert tr._need_new_keyframe()

    def test_no_pressure_no_insert(self):
        tr = self._tracker()
        depth = np.full(256, 100.0, np.float32)
        depth[:120] = 1.0               # plenty of close points are tracked
        tr.cur_depth = depth
        assert not tr._need_new_keyframe()


def _system(sensor):
    return system.System(CAM, sensor, map_cfg=mapstore.MapConfig(**MAP_KW),
                         tracking_cfg=None, baseline=BASELINE,
                         orb_cfg=extractor.OrbConfig(n_features=N_FEAT),
                         enable_loop_closing=False, device="cpu")


@pytest.fixture(scope="module")
def runs(world):
    planes, R, t, pairs = world
    out = {}
    slam = _system(system.STEREO)
    out["stereo"] = (slam, [slam.track_stereo(*pairs[i], float(TS[i]))
                            for i in range(N_FRAMES)])
    slam = _system(system.RGBD)
    poses = []
    for i in range(N_FRAMES):
        img, X, hit = synth_render.render_frame_raycast(CAM, planes, R[i],
                                                        t[i])
        depth = synth_render.camera_depth(R[i], t[i], X, hit)
        poses.append(slam.track_rgbd(img, depth, float(TS[i])))
    out["rgbd"] = (slam, poses)
    return out


@pytest.mark.parametrize("which,ate", [("stereo", 0.05), ("rgbd", 0.04)])
def test_end_to_end_gates(runs, world, which, ate):
    slam, poses = runs[which]
    n = N_FRAMES
    assert sum(p is not None for p in poses) > 0.8 * n
    assert slam.check_map_consistency() == []
    assert slam.local_mapper.last_event.get("new_points", 0) >= 0
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    C = synth_render.camera_centers(world[1], world[2])[:n]
    rmse, nn, _ = evaluate_ate.ate_rmse(TS, C, est_ts, est, with_scale=False)
    assert nn > 0.7 * n
    assert rmse < ate, f"{which} metric ATE {rmse:.4f} m"
    if which == "stereo":
        _, _, s = evaluate_ate.ate_rmse(TS, C, est_ts, est, with_scale=True)
        assert abs(s - 1.0) < 0.03, s
        # the stereo defaults of the JAX System
        assert slam.tracker.cfg.ref_ratio == 0.75
        assert slam.local_mapper.cfg.cull_min_obs == 3
        assert slam.local_mapper.cfg.n_covis_triangulate == 10


def test_track_stereo_iter_matches_track_stereo(runs, world):
    pairs = world[3]
    slam, poses_a = runs["stereo"]
    b = _system(system.STEREO)
    poses_b = list(b.track_stereo_iter(
        (pairs[i][0], pairs[i][1], float(TS[i])) for i in range(N_FRAMES)))
    assert len(poses_b) == N_FRAMES
    for pa, pb in zip(poses_a, poses_b):
        if pa is None:
            assert pb is None
        else:
            np.testing.assert_array_equal(pa, pb)
    assert b.n_keyframes == slam.n_keyframes
    assert b.n_map_points == slam.n_map_points


@pytest.mark.parametrize("sensor", [system.IMU_MONOCULAR, system.IMU_STEREO,
                                    system.IMU_RGBD])
def test_inertial_sensors_raise(sensor):
    """Since the inertial slice the inertial sensors construct, each with
    its tracker's IMU state and the local inertial BA hook, and since the
    ninth slice also with the async mapper; since the twelfth (item 1.7)
    their loop closer takes the sharded global BA by default, and without
    a process group its one-process solve."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    slam = system.System(CAM, sensor, enable_loop_closing=False,
                         device="cpu")
    assert slam.inertial and slam.tracker.imu is not None
    assert slam.local_mapper.inertial_ba is not None
    am = system.System(CAM, sensor, enable_loop_closing=False,
                       async_mapping=True, device="cpu")
    assert am.inertial and am._worker.is_alive()
    am.shutdown()
    assert loop_closing.LoopClosingConfig().dist_gba is True
    lc = loop_closing.LoopCloser(slam.map, CAM, None,
                                 loop_closing.LoopClosingConfig())
    assert lc.gba_group(1024) is None


def test_imu_input_raises_on_stereo_and_rgbd(world):
    """IMU input no longer raises: the visual stereo and RGB-D Systems take
    the window and ignore it, as the JAX package does, online and
    pipelined, with the same first pose as without it."""
    pair, imu = world[3][0], (np.zeros((1, 3)),) * 3
    a, b = _system(system.STEREO), _system(system.STEREO)
    pose = a.track_stereo(*pair, 0.0)
    assert pose is not None
    np.testing.assert_array_equal(pose, b.track_stereo(*pair, 0.0, imu=imu))
    assert b.tracker.imu is None
    got = list(_system(system.STEREO).track_stereo_iter([(*pair, 0.0, imu)]))
    np.testing.assert_array_equal(got[0], pose)
    depth = np.ones_like(pair[0])
    np.testing.assert_array_equal(
        _system(system.RGBD).track_rgbd(pair[0], depth, 0.0),
        _system(system.RGBD).track_rgbd(pair[0], depth, 0.0, imu=imu))


def test_two_camera_rig_takes_bf_from_its_baseline():
    T_c1c2 = np.eye(4, dtype=np.float32)
    T_c1c2[0, 3] = BASELINE
    slam = system.System(CAM, system.STEREO, camera2=CAM, T_c1c2=T_c1c2,
                         enable_loop_closing=False, device="cpu")
    tk = slam.tracker
    np.testing.assert_allclose(tk.T_rl[:3, 3], [-BASELINE, 0, 0], atol=1e-7)
    assert abs(tk.bf - BASELINE * CAM.fx) < 1e-4
    assert abs(tk.th_depth - 35.0 * BASELINE) < 1e-5


@pytest.mark.parametrize("cell", [16, 24, 32, 48, 80])
def test_cell_topk_dispatch_rule(cell):
    """The card's rule (ops/fast.py:118-125 of the JAX package): cells of
    area 128 m take the kernel (16, 32, 48, 80), any other the plain
    version (24); k outside [1, area] on a kernel shape is refused. On the
    CPU every cell is the plain version, equal to lax.top_k."""
    assert topk.on_kernel(cell * cell, 8) == (cell != 24)
    if cell != 24:
        for k in (0, cell * cell + 1):
            with pytest.raises(ValueError):
                topk.on_kernel(cell * cell, k)
    rng = np.random.default_rng(cell)
    maps = [torch.from_numpy(np.where(
        rng.uniform(size=s) < 0.1, rng.integers(1, 90, s), 0).astype(
            np.float32)) for s in ((120, 200), (100, 166), (83, 139))]
    contents = [tuple(m.shape) for m in maps]
    v, i = topk.cell_topk_levels(maps, contents, 4, 8, cell)
    cells = torch.cat([topk.level_cells(m, c, 4, cell)
                       for m, c in zip(maps, contents)]).numpy()
    jv, ji = jax.lax.top_k(jnp.asarray(cells), 8)
    np.testing.assert_array_equal(v.numpy(), np.array(jv))
    np.testing.assert_array_equal(i.numpy(), np.array(ji))


@pytest.mark.parametrize("area", [128, 384, 1024, 200])
def test_cell_topk_matrix_rows_rule(area):
    """cell_topk on [C, A]: the kernel for any A of 128 m, square or not,
    as pallas_topk.cell_topk takes it; the plain version for 200. On the
    CPU, equal to lax.top_k, ties to the first index."""
    assert topk.on_kernel(area, 8) == (area % 128 == 0)
    rng = np.random.default_rng(area)
    x = np.where(rng.uniform(size=(21, area)) < 0.1,
                 rng.integers(1, 30, (21, area)), 0).astype(np.float32)
    v, i = topk.cell_topk(torch.from_numpy(x), 8)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    np.testing.assert_array_equal(v.numpy(), np.array(jv))
    np.testing.assert_array_equal(i.numpy(), np.array(ji))


def test_cell_topk_seventeen_levels():
    """17 levels: the rows of one table, level after level."""
    rng = np.random.default_rng(17)
    maps = [torch.from_numpy(rng.integers(0, 50, (40, 70)).astype(
        np.float32)) for _ in range(17)]
    contents = [(40, 70)] * 17
    v, i = topk.cell_topk_levels(maps, contents, 2, 8)
    parts = [topk.cell_topk_levels([m], [c], 2, 8)
             for m, c in zip(maps, contents)]
    np.testing.assert_array_equal(v.numpy(),
                                  torch.cat([p[0] for p in parts]).numpy())
    np.testing.assert_array_equal(i.numpy(),
                                  torch.cat([p[1] for p in parts]).numpy())
    assert v.shape[0] == 17 * 2 * 3
