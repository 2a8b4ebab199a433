"""The port's monocular-inertial dataset entry points and its synthetic
demo end to end on the CPU (``--device cpu``).

``mono_inertial_euroc`` holds ``tests/test_examples_cli.py``'s gate (more
than half the frames tracked) only at that test's own size: 752x480, 1024
features, 20 frames of world seed 11's ``inertial_trajectory``. At 376x240
the visual-inertial start comes too late in 12 frames (6 of 11 frames
tracked at best over the worlds tried, 10 of 20 on the JAX test's world),
so this one case runs at full size, about 25 s on one worker.
``mono_inertial_tum_vi``, which the JAX package does not test, runs its
wiring at 376x240 (EuRoC layout with imu0, CLAHE, IMU windows, the
keyframe file).
"""
import cv2
import numpy as np
import torch

import torch_cli_data as D
from orb_slam3_detailed_comments_tpu_torch.examples import (
    mono_inertial_euroc, mono_inertial_tum_vi, synthetic_demo)
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.utils import png, synth_render

torch.set_num_threads(2)

FULL = cameras.pinhole(458.0, 457.0, 376.0, 240.0, 752, 480)
FULL_YAML = f"""%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.0
Camera1.fy: 457.0
Camera1.cx: 376.0
Camera1.cy: 240.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20
{D.IMU_YAML}ORBextractor.nFeatures: 1024
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_mono_inertial_euroc_cli(tmp_path):
    planes = synth_render.default_world(np.random.default_rng(11))
    n = 20
    tr = synth_render.inertial_trajectory(n)
    d = tmp_path / "mav0" / "cam0" / "data"
    d.mkdir(parents=True)
    for i in range(n):
        img = synth_render.render_frame_raycast(FULL, planes, tr["R_cw"][i],
                                                tr["t_cw"][i])[0]
        png.write_png(str(d / f"{int(round(1e9 * (1 + tr['ts'][i])))}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
    D.write_imu(tmp_path, tr["windows"])
    y = tmp_path / "s.yaml"
    y.write_text(FULL_YAML)
    out = tmp_path / "traj.txt"
    assert mono_inertial_euroc.main([str(y), str(tmp_path), str(out),
                                     "--device", "cpu"]) == 0
    rows = np.loadtxt(out)
    assert rows.shape[0] > 0.5 * n and rows.shape[1] == 8


def test_mono_inertial_tum_vi_cli(tmp_path):
    planes = synth_render.default_world(np.random.default_rng(11))
    tr = synth_render.inertial_trajectory(D.N, imu_per_frame=30)
    D.write_euroc(tmp_path, planes, tr["R_cw"], tr["t_cw"], 1 + tr["ts"])
    D.write_imu(tmp_path, tr["windows"])
    y = tmp_path / "s.yaml"
    y.write_text(D.YAML.format(extra=D.IMU_YAML))
    out = tmp_path / "traj.txt"
    with D.small_init():
        assert mono_inertial_tum_vi.main([str(y), str(tmp_path), str(out),
                                          "--device", "cpu"]) == 0
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape[0] >= 4 and rows.shape[1] == 8
    assert np.loadtxt(str(out).replace(".txt", "_kf.txt"),
                      ndmin=2).shape[1] == 8


def test_synthetic_demo_writes_its_outputs(tmp_path):
    """The demo's camera is full size (752x480) and its orbit spans the
    frames asked for, so 4 frames are too far apart to track: this runs
    its wiring only (rendering, System, overlays, map render, viewer,
    trajectory and ground truth files), as the JAX package has no test of
    its demo."""
    out = tmp_path / "demo"
    assert synthetic_demo.main(["stereo", "4", str(out), "--device",
                                "cpu"]) == 0
    assert (out / "trajectory_stereo.txt").exists()
    assert np.loadtxt(out / "groundtruth_stereo.txt").shape == (4, 8)
    assert cv2.imread(str(out / "frame_0000.png")).shape == (480, 752, 3)
    assert cv2.imread(str(out / "map_topdown.png")).shape == (640, 640, 3)
    assert "const DATA = " in (out / "map_viewer.html").read_text()
