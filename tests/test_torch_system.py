"""The port's monocular System against the JAX package's on the same 60
frames, on the CPU at the small size of ``test_torch_bootstrap.py``
(376x240, 512 features, 32 keyframes / 2048 points, ``min_init_matches``
50): the orbit of ``tests/test_pipeline_mono.py`` in world seed 3, ts =
0.05 i, ``System(cam, MONOCULAR)`` at its defaults: loop closing on, with
the bundled vocabulary (as ``test_mono_end_to_end`` runs it).

Both are held to the gates of ``test_mono_end_to_end`` (> 70 % of the
frames tracked, >= 3 keyframes, state OK and not lost, > 30 tracked map
points in the last frame, a consistent map, ``trajectory_tum()`` rows for
> 70 % of the frames, scale-aligned ATE < 0.05 m over > 0.6 n poses), with
the point gate scaled to the feature budget: > 100 points at 512 features.
Their keyframe counts agree within 30 %. (In world seed 7 at this size
both packages initialise at frame 18 and track 42 of 60 frames, exactly
70 %: the frame gate needs the earlier start of seed 3.)

The trajectory writers are also fed the JAX run's own frame log and map:
the port's ``trajectory_tum()`` and files then equal the JAX package's.
"""
import copy

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.models import cameras as jcameras
from orb_slam3_detailed_comments_tpu.pipeline import system as jsystem
from orb_slam3_detailed_comments_tpu.pipeline import tracking as jtracking
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM, JCAM = cameras.pinhole(**CAM_KW), jcameras.pinhole(**CAM_KW)
N_FRAMES, N_FEAT, MIN_INIT, WORLD_SEED = 60, 512, 50, 3
MAP_KW = dict(max_kf=32, max_pt=2048, n_feat=N_FEAT)
TS = 0.05 * np.arange(N_FRAMES)


def _jax_system():
    return jsystem.System(
        JCAM, jsystem.MONOCULAR, map_cfg=jms.MapConfig(**MAP_KW),
        tracking_cfg=jtracking.TrackingConfig(n_features=N_FEAT,
                                              min_init_matches=MIN_INIT))


def _port_system():
    return system.System(
        CAM, system.MONOCULAR, map_cfg=mapstore.MapConfig(**MAP_KW),
        tracking_cfg=tracking.TrackingConfig(n_features=N_FEAT,
                                             min_init_matches=MIN_INIT),
        device="cpu")


@pytest.fixture(scope="module")
def runs():
    planes = synth_render.default_world(np.random.default_rng(WORLD_SEED))
    R, t = synth_render.orbit_trajectory(N_FRAMES)
    frames = [synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0]
              for i in range(N_FRAMES)]
    out = dict(C=synth_render.camera_centers(R, t))
    for name, make in (("jax", _jax_system), ("torch", _port_system)):
        slam = make()
        poses = [slam.track_monocular(img, float(TS[i]))
                 for i, img in enumerate(frames)]
        out[name] = dict(slam=slam, poses=poses)
    return out


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_mono_end_to_end_gates(runs, which, tmp_path):
    slam, poses = runs[which]["slam"], runs[which]["poses"]
    n = len(poses)
    tracked = [i for i, p in enumerate(poses) if p is not None]
    assert len(tracked) > 0.7 * n, f"tracked {len(tracked)}/{n}"
    assert slam.n_keyframes >= 3
    assert slam.n_map_points > 100        # > 200 at 1024 features
    assert slam.get_tracking_state() == tracking.OK and not slam.is_lost()
    mp = slam.get_tracked_map_points()
    assert (mp >= 0).sum() > 30
    kp = slam.get_tracked_keypoints()
    assert kp.shape == (mp.shape[0], 2)
    p = tmp_path / "kf_euroc.txt"
    slam.save_keyframe_trajectory_euroc(str(p))
    lines = p.read_text().splitlines()
    assert len(lines) == slam.n_keyframes and len(lines[0].split()) == 8
    assert slam.check_map_consistency() == []
    slam.print_point_distribution()
    p = tmp_path / "sub.txt"
    slam.save_sub_trajectory(str(p), float(TS[10]), float(TS[30]))
    sub = p.read_text().splitlines()
    assert 0 < len(sub) <= 21
    assert all(float(l.split()[0]) >= TS[10] - 1e-9 for l in sub)
    rows = slam.trajectory_tum()
    assert len(rows) > 0.7 * n
    rmse, n_ate, _ = evaluate_ate.ate_rmse(
        TS, runs["C"], np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    assert n_ate > 0.6 * n and rmse < 0.05, (rmse, n_ate)


def test_both_systems_alike(runs):
    j, t = runs["jax"]["slam"], runs["torch"]["slam"]
    assert abs(t.n_keyframes - j.n_keyframes) <= 0.3 * j.n_keyframes
    jt = [i for i, p in enumerate(runs["jax"]["poses"]) if p is not None]
    tt = [i for i, p in enumerate(runs["torch"]["poses"]) if p is not None]
    assert tt[0] == jt[0]                     # the same initialising frame
    assert abs(len(tt) - len(jt)) <= 2
    assert abs(t.n_map_points - j.n_map_points) <= 0.3 * j.n_map_points
    # the port's mapper did every stage: points fused, keyframes culled
    ev = t.local_mapper.last_event
    assert ev["kf"] >= 0 and ev["new_points"] > 0 and ev["fused"] > 0
    assert 0 < ev["ba_cams"] <= 48
    assert len(t.map.tombstones) > 0
    # place recognition ran on every keyframe, in both packages
    assert t.loop_closer.n_processed > 0 and j.loop_closer.n_processed > 0


def _port_from_jax(jslam):
    """A port System holding the JAX run's map and frame log."""
    slam = _port_system()
    jm = jslam.map
    arrays = {k: v for k, v in vars(jm).items() if isinstance(v, np.ndarray)}
    arrays["tombstones"] = copy.deepcopy(jm.tombstones)
    m = mapstore.MapStore.from_numpy(arrays, mapstore.MapConfig(**MAP_KW),
                                     "cpu")
    slam.atlas.maps[0] = slam.map = m
    slam.tracker.map = m
    slam.tracker.trajectory = [
        tuple(copy.deepcopy(r)) for r in jslam.tracker.trajectory]
    return slam


def test_trajectory_writers_match_jax(runs, tmp_path):
    jslam = runs["jax"]["slam"]
    slam = _port_from_jax(jslam)
    rows, jrows = slam.trajectory_tum(), jslam.trajectory_tum()
    assert len(rows) == len(jrows) > 40
    np.testing.assert_allclose(np.array(rows), np.array(jrows), atol=1e-6)
    for name in ("save_trajectory_tum", "save_trajectory_euroc",
                 "save_trajectory_kitti", "save_keyframe_trajectory_tum",
                 "save_keyframe_trajectory_euroc"):
        a, b = tmp_path / f"{name}.port", tmp_path / f"{name}.jax"
        getattr(slam, name)(str(a))
        getattr(jslam, name)(str(b))
        va = np.loadtxt(a, ndmin=2)
        vb = np.loadtxt(b, ndmin=2)
        assert va.shape == vb.shape and len(va) > 0, name
        # timestamps exact; quaternions, positions and matrices to 1e-6
        np.testing.assert_allclose(va, vb, atol=1e-6, rtol=1e-12,
                                   err_msg=name)
    a, b = tmp_path / "stats.port", tmp_path / "stats.jax"
    slam.tracker.track_stats = list(jslam.tracker.track_stats)
    slam.save_track_stats(str(a))
    jslam.save_track_stats(str(b))
    assert a.read_text() == b.read_text()
