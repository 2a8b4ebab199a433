"""The port's monocular-inertial System on the CPU, held to the gates of
``tests/test_pipeline_mono_inertial.py``'s ``test_mono_inertial_end_to_end``
and ``test_gravity_alignment``.

The JAX test's sequence (world seed 11, ``inertial_trajectory`` with the
gyro bias [0.003, -0.002, 0.004], 10 fps with 200 Hz IMU windows) cut to
45 frames at 376x240 with 512 features, the way ``test_torch_system.py``
cuts its cases (frames ray-cast; the JAX test warps with cv2); loop
closing off. At that size both packages initialise the map at frame 10 and
the IMU at 3.1 s. Gates: > 70 % of the frames tracked, the IMU
initialised, |s - 1| < 0.12, scale-aligned ATE < 0.06 m over > 60 % of
the frames, the map's gravity within cos > 0.99 of the truth, all as in
the JAX tests; the gyro bias of the newest keyframe within 5e-3 of the
truth where the JAX test asks 3e-3 at 752x480: at 376x240 the JAX package
itself reads 3.71e-3 on this sequence (the port 3.53e-3), both on the CPU.
The full-size gates are held on the card by ``chip_smoke.py`` phase 9a.
"""
import numpy as np
import pytest
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
N = 45


@pytest.fixture(scope="module")
def run():
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
        poses.append(slam.track_monocular(img, float(traj["ts"][i]),
                                          imu=traj["windows"][i]))
    return slam, traj, poses


def test_mono_inertial_end_to_end(run):
    slam, traj, poses = run
    assert sum(p is not None for p in poses) > 0.7 * N
    assert slam.map.imu_initialized
    assert slam.imu_events and slam.imu_events[0]["full_ba_cams"] >= 8
    chain = slam.map.temporal_chain()
    assert np.abs(slam.map.kf_bg[chain[-1]] - TRUE_BG).max() < 5e-3
    rows = slam.trajectory_tum()
    rmse, n, scale = evaluate_ate.ate_rmse(
        traj["ts"], traj["centers"], np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    assert n > 0.6 * N
    assert abs(scale - 1.0) < 0.12, scale
    assert rmse < 0.06, rmse
    # the inertial tracking steps ran, in both forms, and the chain holds
    assert (slam.tracker.n_inertial_steps["anchor"] > 0
            and slam.tracker.n_inertial_steps["lf"] > 0)
    for a, b in zip(chain[:-1], chain[1:]):
        assert slam.map.kf_prev[b] == a and slam.map.kf_pre_dT[b] > 0
    assert slam.check_map_consistency() == []
    assert slam.get_time_from_imu_init() > 0.0


def test_gravity_alignment(run):
    """After the IMU initialisation the map world is gravity-aligned: the
    Horn rotation to the truth takes the map's -z onto the true gravity."""
    slam, traj, _ = run
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est_xyz = np.array([r[1:4] for r in rows])
    pairs = evaluate_ate.associate(est_ts, traj["ts"])
    _, R, _, _ = evaluate_ate.align_horn(est_xyz[pairs[:, 0]],
                                         traj["centers"][pairs[:, 1]])
    g_true = traj["gravity"] / np.linalg.norm(traj["gravity"])
    assert float((R @ np.array([0.0, 0.0, -1.0])) @ g_true) > 0.99
