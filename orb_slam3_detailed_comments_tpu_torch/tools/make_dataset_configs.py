"""Re-emit the dataset settings files in the canonical flat form.

Counterpart of ``scripts/make_dataset_configs.py`` of the JAX package. The
per-dataset calibration constants (intrinsics and distortion, stereo
extrinsics, IMU noise densities, ORB budgets) are public facts of the
EuRoC / TUM-VI / KITTI / TUM RGB-D datasets, distributed with every
ORB-SLAM3 build. This tool reads them through the port's settings loader
(``utils/config.load_settings``: v1.0 and legacy keys, no PyYAML) and
writes them in the canonical flat OpenCV-YAML form of
``examples/config/``.

    python -m orb_slam3_detailed_comments_tpu_torch.tools.make_dataset_configs \\
        [<src_dir>] [<out_dir>] [--device cpu]

``src_dir`` is an ORB-SLAM3 ``Examples/`` tree (``Stereo-Inertial/
EuRoC.yaml``, ...) or a directory of canonical files (``EuRoC.yaml``,
...); the default is the repo's ``examples/config/``. ``out_dir``
defaults to the repo's git-ignored ``build/torch_configs/``. The tool
computes nothing on a device; like every tool of the port it still takes
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from .. import device as device_mod
from ..examples import runner
from ..models import cameras
from ..utils import config

REPO = Path(__file__).resolve().parents[2]
DEFAULT_SRC = REPO / "examples" / "config"
DEFAULT_OUT = REPO / "build" / "torch_configs"

# (path in an ORB-SLAM3 Examples/ tree, canonical name, note)
JOBS = [
    ("Stereo-Inertial/EuRoC.yaml", "EuRoC.yaml",
     "EuRoC MAV rig: pinhole stereo + ADIS16448 IMU (mono/stereo, +/-IMU)"),
    ("Stereo-Inertial/TUM_512.yaml", "TUM-VI_512.yaml",
     "TUM-VI 512x512 rig: KannalaBrandt8 fisheye stereo + BMI160 IMU"),
    ("Monocular/KITTI00-02.yaml", "KITTI00-02.yaml",
     "KITTI odometry grayscale rig, sequences 00-02"),
    ("Monocular/KITTI03.yaml", "KITTI03.yaml",
     "KITTI odometry grayscale rig, sequence 03"),
    ("Monocular/KITTI04-12.yaml", "KITTI04-12.yaml",
     "KITTI odometry grayscale rig, sequences 04-12"),
    ("RGB-D/TUM1.yaml", "TUM1.yaml", "TUM RGB-D freiburg1 Kinect"),
    ("RGB-D/TUM2.yaml", "TUM2.yaml", "TUM RGB-D freiburg2 Kinect"),
    ("RGB-D/TUM3.yaml", "TUM3.yaml", "TUM RGB-D freiburg3 Kinect"),
]


def _fmt_mat(a: np.ndarray) -> str:
    rows = [", ".join(f"{v:.12g}" for v in row) for row in np.asarray(a)]
    inner = ",\n         ".join(rows)
    return f"  data: [{inner}]"


def _cam_block(prefix: str, cam) -> list:
    out = [f"{prefix}.fx: {cam.fx:.9g}", f"{prefix}.fy: {cam.fy:.9g}",
           f"{prefix}.cx: {cam.cx:.9g}", f"{prefix}.cy: {cam.cy:.9g}"]
    d = np.asarray(cam.dist)
    names = (["k1", "k2", "k3", "k4"] if cam.kind == cameras.FISHEYE_KB8
             else ["k1", "k2", "p1", "p2", "k3"])
    for n, v in zip(names, d):
        if float(v) != 0.0 or n in ("k1", "k2"):
            out.append(f"{prefix}.{n}: {float(v):.12g}")
    return out


def emit(src_yaml: str, out_path: str, note: str) -> None:
    """Read one settings file and write it in the canonical form."""
    s = config.load_settings(src_yaml)
    d = s.raw
    L = ["%YAML:1.0", "---",
         f"# {note}",
         "# Generated by orb_slam3_detailed_comments_tpu_torch.tools."
         "make_dataset_configs",
         "# from the dataset's public calibration; readable by",
         "# utils/config.load_settings and by ORB-SLAM3's v1.0 Settings "
         "parser alike.",
         'File.version: "1.0"', ""]
    kind = ("KannalaBrandt8" if s.camera.kind == cameras.FISHEYE_KB8
            else "PinHole")
    L.append(f'Camera.type: "{kind}"')
    L += _cam_block("Camera1", s.camera)
    if s.camera2 is not None:
        L.append("")
        L += _cam_block("Camera2", s.camera2)
    L += ["", f"Camera.width: {int(s.camera.width)}",
          f"Camera.height: {int(s.camera.height)}",
          f"Camera.fps: {s.fps:.9g}",
          f"Camera.RGB: {int(s.rgb)}"]
    nw, nh = d.get("Camera.newWidth"), d.get("Camera.newHeight")
    if nw:
        L += [f"Camera.newWidth: {int(nw)}", f"Camera.newHeight: {int(nh)}"]
    if s.T_c1c2 is not None:
        L += ["", "Stereo.T_c1_c2: !!opencv-matrix", "  rows: 4", "  cols: 4",
              "  dt: f", _fmt_mat(s.T_c1c2)]
    if s.baseline and s.camera2 is None:
        bf = d.get("Camera.bf")
        if bf is not None:
            L += ["", f"Camera.bf: {float(bf):.9g}"]
        else:
            L += ["", f"Stereo.b: {s.baseline:.9g}"]
    if "ThDepth" in repr(d) or s.baseline:
        L.append(f"Stereo.ThDepth: {s.th_depth:.9g}")
    if s.depth_map_factor != 1.0:
        L += ["", f"RGBD.DepthMapFactor: {s.depth_map_factor:.9g}"]
    if s.T_bc is not None:
        L += ["", "IMU.T_b_c1: !!opencv-matrix", "  rows: 4", "  cols: 4",
              "  dt: f", _fmt_mat(s.T_bc),
              f"IMU.NoiseGyro: {s.imu_noise_gyro:.9g}",
              f"IMU.NoiseAcc: {s.imu_noise_acc:.9g}",
              f"IMU.GyroWalk: {s.imu_walk_gyro:.9g}",
              f"IMU.AccWalk: {s.imu_walk_acc:.9g}",
              f"IMU.Frequency: {s.imu_frequency:.9g}",
              f"IMU.InsertKFsWhenLost: {int(s.insert_kfs_when_lost)}"]
    L += ["", f"ORBextractor.nFeatures: {s.n_features}",
          f"ORBextractor.scaleFactor: {s.scale_factor:.9g}",
          f"ORBextractor.nLevels: {s.n_levels}",
          f"ORBextractor.iniThFAST: {int(s.ini_th_fast)}",
          f"ORBextractor.minThFAST: {int(s.min_th_fast)}", ""]
    with open(out_path, "w") as f:
        f.write("\n".join(L))
    print(f"wrote {out_path}")


def main(argv=None) -> int:
    args, device = runner.split_device(sys.argv[1:] if argv is None
                                       else argv)
    device_mod.resolve(device)
    src = Path(args[0]) if len(args) > 0 else DEFAULT_SRC
    out = Path(args[1]) if len(args) > 1 else DEFAULT_OUT
    os.makedirs(out, exist_ok=True)
    for rel, name, note in JOBS:
        found = [p for p in (src / rel, src / name) if p.exists()]
        if found:
            emit(str(found[0]), str(out / name), note)
        else:
            print(f"skip {rel} (not found)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
