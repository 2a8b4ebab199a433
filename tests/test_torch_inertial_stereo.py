"""The port's stereo-inertial System on the CPU, held to the gates of
``tests/test_pipeline_stereo_inertial.py``'s
``test_stereo_inertial_end_to_end``.

The JAX test's sequence (world seed 13, ``inertial_trajectory`` with the
gyro bias [-0.002, 0.003, 0.001], rectified pairs at a 0.11 m baseline)
cut to 30 frames at 376x240 with 512 features (pairs ray-cast), loop
closing off. Both packages initialise the map on frame 0 and the IMU at
2.1 s, holding the stereo scale at 1. Gates: > 80 % of the frames
tracked, the IMU initialised, the gyro bias within 8e-3, a metric map
(rigid alignment, no scale), all as in the JAX test; the metric ATE below
0.08 m over > 70 % of the frames where the JAX test asks 0.05 m at
752x480: at 376x240 (half the disparity a metre) the JAX package itself
reads 0.0504 m on this sequence and the port 0.0602 m, both on the CPU. The
full-size gates are held on the card by ``chip_smoke.py`` phase 9b.
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
TRUE_BG = np.array([-0.002, 0.003, 0.001], np.float32)
N = 30


def test_stereo_inertial_end_to_end():
    planes = synth_render.default_world(np.random.default_rng(13))
    traj = synth_render.inertial_trajectory(N, true_bg=TRUE_BG)
    slam = system.System(
        CAM, system.IMU_STEREO, baseline=0.11,
        map_cfg=mapstore.MapConfig(max_kf=64, max_pt=8192, n_feat=512),
        tracking_cfg=tracking.TrackingConfig(n_features=512, ref_ratio=0.75),
        enable_loop_closing=False, device="cpu")
    n_ok = 0
    for i in range(N):
        left, right = synth_render.render_stereo_pair(
            CAM, planes, traj["R_cw"][i], traj["t_cw"][i], 0.11)
        n_ok += slam.track_stereo(left, right, float(traj["ts"][i]),
                                  imu=traj["windows"][i]) is not None
    assert n_ok > 0.8 * N
    assert slam.map.imu_initialized
    assert slam.imu_events[0]["scale"] == 1.0     # the stereo scale held
    chain = slam.map.temporal_chain()
    assert np.abs(slam.map.kf_bg[chain[-1]] - TRUE_BG).max() < 8e-3
    rows = slam.trajectory_tum()
    rmse, n, _ = evaluate_ate.ate_rmse(
        traj["ts"], traj["centers"], np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]), with_scale=False)
    assert n > 0.7 * N
    assert rmse < 0.08, rmse
    assert slam.check_map_consistency() == []
