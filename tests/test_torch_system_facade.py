"""The port's System facade, on the CPU at the small size of
``test_torch_system.py``: the mirrors of ``tests/test_pipeline_mono.py``'s
``test_system_facade_api`` (map_changed, reset_active_map and its purged
frame log, reset, shutdown) and ``test_pipelined_iter_matches_online``
(track_monocular_iter yields the online poses bit for bit); the System at
its defaults (loop closing on, the bundled vocabulary, or one given by
``vocab_path``); and the configurations it refuses: each raises
NotImplementedError naming the ROADMAP item that brings it, none is
quietly ignored, and without a card nothing carries on on the CPU unless
asked.
"""
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu_torch.mapping import atlas, mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM = cameras.pinhole(**CAM_KW)
N_FEAT = 512


def _system(**kw):
    return system.System(
        CAM, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=N_FEAT),
        tracking_cfg=tracking.TrackingConfig(n_features=N_FEAT,
                                             min_init_matches=50),
        enable_loop_closing=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def frames():
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(60)
    return [synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0]
            for i in range(12)]


def test_system_facade_api(frames):
    slam = _system()
    assert slam.get_image_scale() == 1.0
    assert slam.get_time_from_imu_init() == 0.0
    assert not slam.is_shutdown()
    for i, img in enumerate(frames[:8]):
        slam.track_monocular(img, i * 0.05)
    assert slam.n_keyframes > 0
    assert not slam.map_changed()          # no loop / GBA / merge happened
    slam.map.big_change_idx += 1           # as an applied global BA would
    assert slam.map_changed()
    assert not slam.map_changed()          # latched until the next bump

    assert len(slam.trajectory_tum()) > 0
    slam.reset_active_map()
    assert slam.n_keyframes == 0 and slam.map.big_change_idx == 1
    # rows of the reset map are purged, not resolved against the fresh
    # map's reused (slot, epoch) keyframes
    assert len(slam.trajectory_tum()) == 0
    assert slam.tracker.map is slam.map is slam.local_mapper.map
    for i, img in enumerate(frames[:8]):   # re-initialises cleanly
        slam.track_monocular(img, 1.0 + i * 0.05)
    assert slam.n_keyframes > 0
    rows = slam.trajectory_tum()
    assert rows and all(r[0] >= 1.0 for r in rows)

    slam.reset()
    assert len(slam.atlas.maps) == 1 and slam.n_keyframes == 0
    assert slam.tracker.trajectory == [] and slam.tracker.map is slam.map
    slam.shutdown()
    assert slam.is_shutdown() and slam.is_finished()


def test_pipelined_iter_matches_online(frames):
    a = _system()
    poses_a = [a.track_monocular(img, i * 0.05)
               for i, img in enumerate(frames)]
    b = _system()
    poses_b = list(b.track_monocular_iter(
        (img, i * 0.05) for i, img in enumerate(frames)))
    assert len(poses_b) == len(frames)
    assert sum(p is not None for p in poses_a) >= 8
    for pa, pb in zip(poses_a, poses_b):
        if pa is None:
            assert pb is None
        else:
            np.testing.assert_array_equal(pa, pb)
    assert a.n_keyframes == b.n_keyframes and a.n_map_points == b.n_map_points


def test_lost_map_is_reset_or_kept(frames):
    """A lost tracker on a poor map resets it in place; on a rich map
    (> 10 keyframes) the Atlas keeps it and starts a new one."""
    slam = _system()
    for i, img in enumerate(frames[:6]):
        slam.track_monocular(img, i * 0.05)
    assert slam.n_keyframes > 0
    slam.tracker.state = tracking.LOST
    slam._post_track(None)
    assert len(slam.atlas.maps) == 1 and slam.n_keyframes == 0
    assert slam.tracker.state == tracking.NOT_INITIALIZED
    slam.map.kf_valid[:11] = True          # stand-in for a rich map
    slam.tracker.state = tracking.LOST
    slam._post_track(None)
    assert len(slam.atlas.maps) == 2 and slam.atlas.active_id == 1
    assert slam.map.map_id == 1 and slam.map.n_kf == 0
    assert slam.map.device == torch.device("cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(enable_loop_closing=True, async_mapping=True), "item 1.7"),
    (dict(async_mapping=True), "item 1.7"),
])
def test_unported_configurations_raise(kw, item):
    """The async mapping worker constructs since the ninth slice (with
    loop closing on, its loop closer races the global BA), and since the
    twelfth (item 1.7) the sharded global BA too: dist_gba is the default,
    and without a process group the loop closer takes the one-process
    solve."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    args = dict(enable_loop_closing=False, device="cpu")
    args.update(kw)
    sensor = args.pop("sensor", system.MONOCULAR)
    slam = system.System(CAM, sensor, **args)
    try:
        assert slam._worker.is_alive()
        if slam.enable_loop_closing:
            slam._build_recognition()
            assert slam.loop_closer.cfg.async_gba
        assert item == "item 1.7" and loop_closing.LoopClosingConfig().dist_gba
        lc = loop_closing.LoopCloser(slam.map, CAM, None,
                                     loop_closing.LoopClosingConfig(
                                         dist_gba=True))
        assert lc.gba_group(1024) is None
        if slam.enable_loop_closing:
            assert slam.loop_closer.gba_group(1024) is None
    finally:
        slam.shutdown()


@pytest.mark.parametrize("kw", [
    dict(sensor=system.IMU_MONOCULAR),
    dict(sensor=system.IMU_STEREO),
    dict(sensor=system.IMU_RGBD),
    dict(sensor=system.IMU_MONOCULAR, enable_loop_closing=True),
])
def test_inertial_configurations_construct_and_track(frames, kw):
    """The inertial Systems construct on the CPU and take IMU windows: each
    tracks two frames of the orbit with the windows of an
    inertial_trajectory (0.1 s of 200 Hz samples between the frames), the
    tracker preintegrating the second one; the stereo and RGB-D ones
    initialise their map on the first frame, and the IMU schedule stays at
    its first stage (no IMU initialisation on a one-keyframe chain)."""
    args = dict(enable_loop_closing=False, baseline=0.11,
                map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048,
                                           n_feat=N_FEAT),
                tracking_cfg=tracking.TrackingConfig(n_features=N_FEAT,
                                                     min_init_matches=50),
                device="cpu")
    args.update(kw)
    sensor = args.pop("sensor")
    slam = system.System(CAM, sensor, **args)
    assert slam.inertial and slam.tracker.imu is not None
    assert slam.local_mapper.inertial_ba is not None
    windows = synth_render.inertial_trajectory(2)["windows"]
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(60)
    poses = []
    for i in range(2):
        if sensor == system.IMU_MONOCULAR:
            poses.append(slam.track_monocular(frames[i], 0.1 * i,
                                              imu=windows[i]))
        elif sensor == system.IMU_STEREO:
            left, right = synth_render.render_stereo_pair(CAM, planes, R[i],
                                                          t[i], 0.11)
            poses.append(slam.track_stereo(left, right, 0.1 * i,
                                           imu=windows[i]))
        else:
            depth = synth_render.render_depth(CAM, planes, R[i], t[i])
            poses.append(slam.track_rgbd(frames[i], depth, 0.1 * i,
                                         imu=windows[i]))
    pre = slam.tracker.imu.pre_last_frame
    assert pre is not None and abs(float(pre.dT) - 0.1) < 1e-6
    if sensor != system.IMU_MONOCULAR:
        assert poses[0] is not None and slam.n_keyframes >= 1
        assert slam.tracker.imu.pre_since_kf is not None
    assert not slam.map.imu_initialized and slam._viba_stage == 0
    assert slam.get_time_from_imu_init() == 0.0


def test_loop_closing_is_on_by_default_and_refused(frames):
    """Loop closing is on by default, as in the JAX package, and no longer
    refused: System(cam, MONOCULAR) constructs and runs, its place
    recognition built at the first keyframe with the bundled vocabulary;
    an unknown sensor is still refused."""
    from orb_slam3_detailed_comments_tpu_torch.placerec import vocab
    slam = system.System(
        CAM, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=N_FEAT),
        tracking_cfg=tracking.TrackingConfig(n_features=N_FEAT,
                                             min_init_matches=50),
        device="cpu")
    assert slam.enable_loop_closing and slam.loop_closer is None
    poses = [slam.track_monocular(img, i * 0.05)
             for i, img in enumerate(frames)]
    assert sum(p is not None for p in poses) >= 8
    assert slam.loop_closer is not None and slam.kfdb is not None
    assert slam.vocab is vocab.load()           # the bundled file
    assert slam.kfdb.valid[slam.map.kf_ids()].all()
    assert slam.loop_closer.n_processed == slam.n_keyframes
    assert slam.check_map_consistency() == []
    with pytest.raises(ValueError):
        system.System(CAM, 17, enable_loop_closing=False, device="cpu")


def test_vocab_path_is_taken(frames, tmp_path):
    """A vocabulary file given by path is read at construction (here one
    trained on the frames' own descriptors, in the JAX package's file
    format) and used by the keyframe database."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
    from orb_slam3_detailed_comments_tpu_torch.placerec import vocab
    descs = np.concatenate([
        kernels.prepare_frame(torch.from_numpy(f), CAM, extractor.OrbConfig(
            n_features=N_FEAT)).feat.desc.numpy()
        for f in frames[:3]])
    path = tmp_path / "voc.npz"
    vocab.save(vocab.train(descs, k=6, levels=2), str(path))
    slam = system.System(
        CAM, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=N_FEAT),
        tracking_cfg=tracking.TrackingConfig(n_features=N_FEAT,
                                             min_init_matches=50),
        vocab_path=str(path), device="cpu")
    assert slam.vocab.n_words == 36 and slam.kfdb is not None
    for i, img in enumerate(frames[:6]):
        slam.track_monocular(img, i * 0.05)
    assert slam.n_keyframes > 0
    assert slam.kfdb.valid[slam.map.kf_ids()].all()


def test_imu_input_raises(frames):
    """Since the inertial slice nothing raises on IMU input: a visual
    System takes the windows and ignores them, as the JAX package does
    (its tracker has no IMU state), online and pipelined, with the same
    poses as without them."""
    window = tuple(np.zeros((3, 3), np.float32) for _ in range(2)) + (
        np.array([0.01, 0.02, 0.03]),)
    a, b = _system(), _system()
    for i, img in enumerate(frames[:4]):
        pa = a.track_monocular(img, i * 0.05)
        pb = b.track_monocular(img, i * 0.05, imu=window)
        assert (pa is None) == (pb is None)
        if pa is not None:
            np.testing.assert_array_equal(pa, pb)
    assert a.tracker.imu is None and b.tracker.imu is None
    c = _system()
    got = list(c.track_monocular_iter(
        (img, i * 0.05, window) for i, img in enumerate(frames[:2])))
    assert len(got) == 2


def test_system_and_atlas_default_to_the_card():
    cfg = mapstore.MapConfig(max_kf=4, max_pt=64, n_feat=32)
    if torch.cuda.is_available():
        assert atlas.Atlas(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        atlas.Atlas(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        system.System(CAM, system.MONOCULAR, enable_loop_closing=False)
