"""The port's six ROS launchers (``examples/ros/ros_*``) replaying tiny
synthetic directories through their nodes and LocalTransport on the CPU
(``--device cpu``; this environment has no rospy). The JAX package has no
test of its launchers; each here must track through the node's topic
path: the same share of frames as the matching entry point's test (the
monocular-inertial one: at least 4 frames, as at this size in
``test_torch_examples_inertial_cli.py``), its poses published and its
trajectory written to ``trajectory_ros_<node>.txt``.
"""
import numpy as np
import pytest
import torch

import torch_cli_data as D
from orb_slam3_detailed_comments_tpu_torch.examples.ros import (
    ros_mono, ros_mono_ar, ros_mono_inertial, ros_rgbd, ros_stereo,
    ros_stereo_inertial)
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)


def _launch(mod, argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    with D.small_init():
        assert mod.main([*map(str, argv), "--device", "cpu"]) == 0


@pytest.mark.parametrize("mod,name", [(ros_mono, "mono"),
                                      (ros_mono_ar, "mono_ar")])
def test_mono_launchers_replay_euroc(tmp_path, monkeypatch, mod, name):
    planes, R, t = D.orbit()
    D.write_euroc(tmp_path, planes, R, t, 1 + np.arange(D.N) * 0.05)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    _launch(mod, [y, tmp_path, "--equalize"] if name == "mono" else
            [y, tmp_path], tmp_path, monkeypatch)
    rows = np.loadtxt(tmp_path / f"trajectory_ros_{name}.txt", ndmin=2)
    assert rows.shape[0] > 0.6 * D.N


def test_stereo_launcher_rectifies(tmp_path, monkeypatch):
    planes, R, t = D.orbit(world_seed=9, n_orbit=40)
    D.write_euroc(tmp_path, planes, R, t, 1 + np.arange(D.N) * 0.05,
                  stereo=True, baseline=0.11)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=D.rectification_yaml(0.11)))
    _launch(ros_stereo, [y, tmp_path, "--rectify"], tmp_path, monkeypatch)
    rows = np.loadtxt(tmp_path / "trajectory_ros_stereo.txt", ndmin=2)
    assert rows.shape[0] > 0.6 * D.N and rows.shape[1] == 8
    gt = synth_render.camera_centers(R, t)
    step = np.linalg.norm(np.diff(rows[:, 1:4], axis=0), axis=1).mean()
    step_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).mean()
    assert abs(step - step_gt) < 0.3 * step_gt          # metric


@pytest.mark.parametrize("mod,name,stereo", [
    (ros_mono_inertial, "mono_inertial", False),
    (ros_stereo_inertial, "stereo_inertial", True)])
def test_inertial_launchers_replay_imu(tmp_path, monkeypatch, mod, name,
                                       stereo):
    planes = synth_render.default_world(np.random.default_rng(
        13 if stereo else 11))
    tr = synth_render.inertial_trajectory(
        D.N, imu_per_frame=20 if stereo else 30)
    D.write_euroc(tmp_path, planes, tr["R_cw"], tr["t_cw"], 1 + tr["ts"],
                  stereo=stereo, baseline=0.11)
    D.write_imu(tmp_path, tr["windows"])
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(
        extra=(f"Camera.bf: {D.FX * 0.11}\n" if stereo else "")
        + D.IMU_YAML))
    _launch(mod, [y, tmp_path], tmp_path, monkeypatch)
    rows = np.loadtxt(tmp_path / f"trajectory_ros_{name}.txt", ndmin=2)
    if stereo:
        assert rows.shape[0] > 0.5 * D.N
    else:
        assert rows.shape[0] >= 4


def test_rgbd_launcher_replays_tum(tmp_path, monkeypatch):
    planes, R, t = D.orbit(world_seed=9, n_orbit=40)
    D.write_tum(tmp_path, planes, R, t)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(
        extra="RGBD.DepthMapFactor: 5000.0\nStereo.ThDepth: 40.0\n"
              "Stereo.b: 0.08\n"))
    _launch(ros_rgbd, [y, tmp_path], tmp_path, monkeypatch)
    rows = np.loadtxt(tmp_path / "trajectory_ros_rgbd.txt", ndmin=2)
    assert rows.shape[0] > 0.8 * D.N
    gt = synth_render.camera_centers(R, t)
    step = np.linalg.norm(np.diff(rows[:, 1:4], axis=0), axis=1).mean()
    step_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).mean()
    assert abs(step - step_gt) < 0.3 * step_gt          # metric


def test_launcher_without_ros_or_dataset_exits_1(tmp_path, monkeypatch):
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    monkeypatch.chdir(tmp_path)
    assert ros_mono.main([str(y), "--device", "cpu"]) == 1
    assert ros_mono.main([]) == 1                               # usage
