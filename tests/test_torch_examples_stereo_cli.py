"""The port's stereo and stereo-inertial dataset entry points end to end
on the CPU (``--device cpu``), on tiny synthetic directories in the reference
layouts (``torch_cli_data``: 376x240, 12 frames), with the gates of
``tests/test_examples_cli.py`` where it has a test of the script.

The stereo Systems start from frame 0, on the first 12 frames of world
seed 9's 40-frame orbit (the port's small stereo tests' case). The TUM-VI
stereo entry points run a rectified pinhole pair here (``Camera.bf``): the
KB8 two-camera rig needs 300 features with depth to start, which 512
features at this size do not give (the fisheye tests and the card's phase
7 hold it at full size); what is tested is their wiring (EuRoC layout,
CLAHE, IMU windows, the keyframe file).
"""
import numpy as np
import torch

import torch_cli_data as D
from orb_slam3_detailed_comments_tpu_torch.examples import (
    stereo_euroc, stereo_inertial_euroc, stereo_inertial_tum_vi,
    stereo_kitti, stereo_tum_vi)
from orb_slam3_detailed_comments_tpu_torch.utils import (evaluate_ate,
                                                         synth_render)

torch.set_num_threads(2)


def _run(main, argv):
    with D.small_init():
        assert main([*map(str, argv), "--device", "cpu"]) == 0


def test_stereo_kitti_cli(tmp_path):
    planes, R, t = D.orbit(world_seed=9, n_orbit=40)
    n = len(R)
    baseline = 0.12
    D.write_kitti(tmp_path, planes, R, t, stereo=True, baseline=baseline)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=f"Camera.bf: {D.FX * baseline}\n"))
    out = tmp_path / "traj_kitti.txt"
    _run(stereo_kitti.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.6 * n and rows.shape[1] == 12
    gt = synth_render.camera_centers(R, t)
    est = rows[:, [3, 7, 11]]
    step_gt = np.linalg.norm(np.diff(gt[:len(est)], axis=0), axis=1).mean()
    step_est = np.linalg.norm(np.diff(est, axis=0), axis=1).mean()
    assert abs(step_est - step_gt) < 0.3 * step_gt, (step_est, step_gt)


def test_stereo_euroc_cli_with_rectification(tmp_path):
    """Legacy LEFT./RIGHT. blocks of an identity rig: the pairs go through
    utils/config.rectify and track metric."""
    planes, R, t = D.orbit(world_seed=9, n_orbit=40)
    n = len(R)
    baseline = 0.11
    D.write_euroc(tmp_path, planes, R, t, 1 + np.arange(n) * 0.05,
                  stereo=True, baseline=baseline)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=D.rectification_yaml(baseline)))
    out = tmp_path / "traj.txt"
    _run(stereo_euroc.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.6 * n and rows.shape[1] == 8
    gt = synth_render.camera_centers(R, t)
    rmse, _, scale = evaluate_ate.ate_rmse(1 + np.arange(n) * 0.05, gt,
                                           rows[:, 0], rows[:, 1:4])
    assert rmse < 0.08, f"stereo-euroc CLI ATE {rmse:.3f} m"
    assert abs(scale - 1.0) < 0.05


def test_stereo_tum_vi_cli(tmp_path):
    planes, R, t = D.orbit(world_seed=9, n_orbit=40)
    n = len(R)
    D.write_euroc(tmp_path, planes, R, t, 1 + np.arange(n) * 0.05,
                  stereo=True, baseline=0.11)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=f"Camera.bf: {D.FX * 0.11}\n"))
    out = tmp_path / "traj.txt"
    _run(stereo_tum_vi.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.5 * n and rows.shape[1] == 8
    assert np.loadtxt(str(out).replace(".txt", "_kf.txt")).shape[1] == 8


def _inertial_dir(root, world_seed, stereo, baseline=0.11):
    planes = synth_render.default_world(np.random.default_rng(world_seed))
    tr = synth_render.inertial_trajectory(D.N)
    D.write_euroc(root, planes, tr["R_cw"], tr["t_cw"], 1 + tr["ts"],
                  stereo=stereo, baseline=baseline)
    D.write_imu(root, tr["windows"])
    return tr


def test_stereo_inertial_euroc_cli(tmp_path):
    _inertial_dir(tmp_path, 13, stereo=True)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=f"Camera.bf: {D.FX * 0.11}\n"
                                     + D.IMU_YAML))
    out = tmp_path / "traj.txt"
    _run(stereo_inertial_euroc.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.5 * D.N and rows.shape[1] == 8
    kf_rows = np.loadtxt(str(out).replace(".txt", "_kf.txt"))
    assert kf_rows.ndim == 2 and kf_rows.shape[1] == 8


def test_stereo_inertial_tum_vi_cli(tmp_path):
    _inertial_dir(tmp_path, 13, stereo=True)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=f"Camera.bf: {D.FX * 0.11}\n"
                                     + D.IMU_YAML))
    out = tmp_path / "traj.txt"
    _run(stereo_inertial_tum_vi.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.5 * D.N and rows.shape[1] == 8
