"""Dead reckoning through texture loss on the port's monocular-inertial
System, held to the gates of ``tests/test_pipeline_mono_inertial.py``'s
``test_imu_dead_reckoning_through_texture_loss``.

The JAX test's sequence (world seed 11, ``inertial_trajectory``) at
376x240 with 512 features, cut to 42 frames with its 6 blank frames moved
from 42-47 to 33-38 (3 frames after the IMU initialisation at 3.1 s,
which at this size follows the map's initialisation at frame 10); loop
closing off. Gates as in the JAX test: the IMU initialised; keyframes
inserted during the blackout; every blank frame dead-reckoned to a pose
that lands in the trajectory; the frames after the gap tracked (> 70 %);
scale-aligned ATE < 0.12 m, |s - 1| < 0.12. The pose count is held to
> 80 % of the frames from the map's initialisation on (the JAX test
counts all 60 at 752x480, where the map initialises at frame 2-3); the
JAX package reads 32 poses and ATE 0.0191 m here, the port 32 and
0.0186 m, both on the CPU.
"""
import numpy as np
import torch

from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import (evaluate_ate,
                                                         synth_render)

torch.set_num_threads(2)

CAM = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376,
                      height=240)
TRUE_BG = np.array([0.003, -0.002, 0.004], np.float32)
N, BLANK_AT, N_BLANK = 42, 33, 6


def test_imu_dead_reckoning_through_texture_loss():
    planes = synth_render.default_world(np.random.default_rng(11))
    traj = synth_render.inertial_trajectory(N, true_bg=TRUE_BG)
    slam = system.System(
        CAM, system.IMU_MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=64, max_pt=4096, n_feat=512),
        tracking_cfg=tracking.TrackingConfig(n_features=512,
                                             min_init_matches=50),
        enable_loop_closing=False, device="cpu")
    poses = []
    for i in range(N):
        img = synth_render.render_frame_raycast(
            CAM, planes, traj["R_cw"][i], traj["t_cw"][i])[0]
        if BLANK_AT <= i < BLANK_AT + N_BLANK:
            img = np.zeros_like(img)
        if i == BLANK_AT:
            kf_before = slam.n_keyframes
            assert slam.map.imu_initialized
        poses.append(slam.track_monocular(img, float(traj["ts"][i]),
                                          imu=traj["windows"][i]))
        if i == BLANK_AT + N_BLANK - 1:
            kf_after = slam.n_keyframes
    assert kf_after > kf_before
    dead = poses[BLANK_AT:BLANK_AT + N_BLANK]
    assert all(p is not None for p in dead)
    assert slam.tracker.n_dead_reckoned >= N_BLANK
    after = poses[BLANK_AT + N_BLANK:]
    assert sum(p is not None for p in after) > 0.7 * len(after)
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est_xyz = np.array([r[1:4] for r in rows])
    for j in range(N_BLANK):
        assert np.any(np.abs(est_ts - traj["ts"][BLANK_AT + j]) < 1e-6)
    rmse, n, scale = evaluate_ate.ate_rmse(traj["ts"], traj["centers"],
                                           est_ts, est_xyz)
    init_at = next(i for i, p in enumerate(poses) if p is not None)
    assert n > 0.8 * (N - init_at)
    assert abs(scale - 1.0) < 0.12, scale
    assert rmse < 0.12, rmse
