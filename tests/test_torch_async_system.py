"""The port's System with the async mapping worker, on the CPU at the
small size of ``test_torch_system.py`` (376x240, 512 features, 32
keyframes / 2048 points, ``min_init_matches`` 50, world seed 3): the cases
of ``tests/test_atlas_multimap.py``'s ``test_async_mapping_mode`` and
``test_async_backpressure_bounds_queue`` (the first 40 and 28 frames of
the 50-frame orbit).

Gates: ``test_async_mapping_mode``'s (> 60 % of 40 frames tracked, >= 3
keyframes, ``trajectory_tum()`` rows for > 60 % of them after
``shutdown()``), with the point gate scaled to the feature budget (> 100
points at 512 features, as the sync System's test scales it);
``test_async_backpressure_bounds_queue``'s exactly (a worker slowed by
0.25 s a keyframe: >= 3 keyframes queued, >= 1 wait, a queue never deeper
than ``max_kf_lag`` + 1). The System constructs, and shuts down, in async
mode for every sensor.
"""
import time

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376,
                      height=240)
N_FEAT, MIN_INIT, WORLD_SEED = 512, 50, 3


def _system(**kw):
    return system.System(
        CAM, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=N_FEAT),
        tracking_cfg=tracking.TrackingConfig(n_features=N_FEAT,
                                             min_init_matches=MIN_INIT),
        device="cpu", async_mapping=True, **kw)


@pytest.fixture(scope="module")
def frames():
    planes = synth_render.default_world(np.random.default_rng(WORLD_SEED))
    R, t = synth_render.orbit_trajectory(50)
    return [synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0]
            for i in range(40)]


def test_async_mapping_mode(frames):
    slam = _system()
    ts = 0.05 * np.arange(40)
    ok = sum(slam.track_monocular(frames[i], float(ts[i])) is not None
             for i in range(40))
    slam.shutdown()
    assert slam._worker is None and slam.is_shutdown()
    assert ok > 0.6 * 40, f"tracked {ok}/40"
    assert slam.map.n_kf >= 3
    assert slam.map.n_points > 100
    assert len(slam.trajectory_tum()) > 0.6 * 40
    assert slam.check_map_consistency() == []


def test_async_backpressure_bounds_queue(frames):
    slam = _system(enable_loop_closing=False, max_kf_lag=1)
    seen_depths = []
    orig = slam._process_keyframe

    def slow(k, ts):
        seen_depths.append(slam._kf_queue.unfinished_tasks)
        time.sleep(0.25)          # the worker lags tracking
        orig(k, ts)

    slam._process_keyframe = slow
    for i in range(28):
        slam.track_monocular(frames[i], 0.05 * i)
    slam.shutdown()
    assert len(seen_depths) >= 3, "too few keyframes to exercise the bound"
    assert slam.n_backpressure_waits >= 1, "bound never engaged"
    assert max(seen_depths) <= slam.max_kf_lag + 1, seen_depths


@pytest.mark.parametrize("sensor", ["MONOCULAR", "STEREO", "RGBD",
                                    "IMU_MONOCULAR", "IMU_STEREO",
                                    "IMU_RGBD"])
def test_async_system_constructs_for_every_sensor(sensor):
    slam = system.System(CAM, getattr(system, sensor), baseline=0.11,
                         device="cpu", async_mapping=True)
    assert slam._worker.is_alive() and slam.tracker.map_lock is slam.map_lock
    slam._build_recognition()
    assert slam.loop_closer.cfg.async_gba
    assert slam.loop_closer.map_lock is slam.map_lock
    slam.shutdown()
    assert slam._worker is None


def test_worker_exception_is_reported_and_shutdown_returns(monkeypatch):
    """A keyframe event that raises ends the worker through
    threading.excepthook (nothing swallows it), and neither the frames
    after it nor shutdown() wait forever."""
    import threading
    seen = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_type))
    slam = _system(enable_loop_closing=False)

    def broken(k, ts):
        raise RuntimeError("keyframe event failed")

    slam._process_keyframe = broken
    for k in range(3):
        slam._kf_queue.put((k, 0.0))
        slam._post_track(None)
    slam.shutdown()
    assert seen == [RuntimeError] and slam._worker is None
