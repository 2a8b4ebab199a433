"""The port's monocular and RGB-D dataset entry points end to end on the
CPU (``--device cpu``), on tiny synthetic directories in the reference
layouts (``torch_cli_data``: 376x240, 12 frames), with the gates of
``tests/test_examples_cli.py``. The stereo ones are in
``test_torch_examples_stereo_cli.py``, the monocular-inertial ones and the
synthetic demo in ``test_torch_examples_inertial_cli.py``, the ROS
launchers in ``test_torch_examples_ros.py``.
"""
import numpy as np
import pytest
import torch

import torch_cli_data as D
from orb_slam3_detailed_comments_tpu_torch.examples import (
    mono_euroc, mono_kitti, mono_tum, mono_tum_vi, rgbd_tum, runner)
from orb_slam3_detailed_comments_tpu_torch.utils import (evaluate_ate,
                                                         synth_render)

torch.set_num_threads(2)


def _run(main, argv):
    with D.small_init():
        assert main([*map(str, argv), "--device", "cpu"]) == 0


def test_mono_euroc_cli(tmp_path):
    planes, R, t = D.orbit()
    n = len(R)
    D.write_euroc(tmp_path, planes, R, t, 1 + np.arange(n) * 0.05)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    out = tmp_path / "traj.txt"
    # the sequence twice: the reference's multi-sequence mode
    _run(mono_euroc.main, [y, tmp_path, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 1.2 * n and rows.shape[1] == 8
    wraps = np.flatnonzero(np.diff(rows[:, 0]) < 0)
    rows = rows[:wraps[0] + 1] if wraps.size else rows
    assert rows.shape[0] > 0.6 * n
    gt = synth_render.camera_centers(R, t)
    rmse, _, scale = evaluate_ate.ate_rmse(1 + np.arange(n) * 0.05, gt,
                                           rows[:, 0], rows[:, 1:4])
    assert rmse < 0.05, f"mono CLI ATE {rmse:.3f} m (scale {scale:.2f})"
    assert np.loadtxt(str(out).replace(".txt", "_kf.txt")).shape[1] == 8


def test_mono_tum_vi_cli(tmp_path):
    """EuRoC layout and CLAHE equalisation (the KB8 camera path itself is
    the fisheye tests')."""
    planes, R, t = D.orbit()
    n = len(R)
    D.write_euroc(tmp_path, planes, R, t, 1 + np.arange(n) * 0.05)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    out = tmp_path / "traj.txt"
    _run(mono_tum_vi.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.6 * n and rows.shape[1] == 8


def test_rgbd_tum_cli(tmp_path):
    planes, R, t = D.orbit(world_seed=9, n_orbit=40)
    n = len(R)
    D.write_tum(tmp_path, planes, R, t)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(
        extra="RGBD.DepthMapFactor: 5000.0\nStereo.ThDepth: 40.0\n"
              "Stereo.b: 0.08\n"))
    out = tmp_path / "traj.txt"
    _run(rgbd_tum.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.8 * n
    gt = synth_render.camera_centers(R, t)
    rmse, _, scale = evaluate_ate.ate_rmse(1 + np.arange(n) * 0.05, gt,
                                           rows[:, 0], rows[:, 1:4])
    assert abs(scale - 1.0) < 0.05, scale          # metric without scaling
    assert rmse < 0.05, f"rgbd CLI ATE {rmse:.3f} m"


def test_mono_kitti_cli(tmp_path):
    planes, R, t = D.orbit()
    n = len(R)
    D.write_kitti(tmp_path, planes, R, t)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    out = tmp_path / "traj.txt"
    _run(mono_kitti.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.6 * n and rows.shape[1] == 8
    gt = synth_render.camera_centers(R, t)
    rmse, _, scale = evaluate_ate.ate_rmse(np.arange(n) * 0.05, gt,
                                           rows[:, 0], rows[:, 1:4])
    assert rmse < 0.05, f"mono-kitti CLI ATE {rmse:.3f} m"


def test_mono_tum_cli(tmp_path):
    planes, R, t = D.orbit()
    n = len(R)
    D.write_tum(tmp_path, planes, R, t)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    out = tmp_path / "traj.txt"
    _run(mono_tum.main, [y, tmp_path, out])
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.6 * n and rows.shape[1] == 8
    gt = synth_render.camera_centers(R, t)
    rmse, _, scale = evaluate_ate.ate_rmse(1 + np.arange(n) * 0.05, gt,
                                           rows[:, 0], rows[:, 1:4])
    assert rmse < 0.05, f"mono-tum CLI ATE {rmse:.3f} m"


def test_entry_points_fail_without_the_card(tmp_path, monkeypatch):
    """No card and no --device cpu: the System refuses; with --device the
    flag is taken out of the arguments wherever it stands."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=""))
    (tmp_path / "mav0" / "cam0" / "data").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mono_euroc.main([str(y), str(tmp_path)])
    assert runner.split_device(["a", "--device", "cpu", "b"]) == (
        ["a", "b"], "cpu")
    assert runner.split_device(["--device=cuda:0", "a"]) == (["a"],
                                                             "cuda:0")
    assert mono_euroc.main(["only-settings.yaml"]) == 1      # usage
