"""The port's settings reader and ``System.from_settings`` against the JAX
package's, on the CPU: every shipped file of ``examples/config/`` and the
settings texts of ``tests/test_persistence_config.py`` and
``tests/test_pipeline_mono.py::test_image_scale_from_settings``. The port
reads OpenCV-YAML itself (no PyYAML, no OpenCV); the JAX package reads it
with PyYAML. Also ``resize_image`` against ``cv2.resize`` and ``warmup``.

Tolerances: every ``Settings`` field equal (cameras field by field, T_bc
and T_c1c2 arrays equal with their type), the raw dicts' numbers equal
(their types may differ: YAML 1.1 reads ``1e-5`` as a string); the
configs that ``from_settings`` wires equal field by field; the resize
within 1e-3 of cv2's for float32 images and within 1 grey level for
uint8 (cv2 rounds 8-bit images through 11-bit fixed-point weights).
"""
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.pipeline import system as jsystem
from orb_slam3_detailed_comments_tpu.utils import config as jconfig
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import config

import test_persistence_config as jtests

torch.set_num_threads(2)

CFG_DIR = jtests.TestShippedConfigs.CFG_DIR
SHIPPED = sorted(os.listdir(CFG_DIR))
HEADER = "%YAML:1.0\n"


def _source(fn):
    """The YAML text a JAX test writes (between its triple quotes)."""
    import inspect
    src = inspect.getsource(fn)
    return src[src.index('"""%YAML') + 3:src.rindex('""")')]


TEXTS = {
    "reference_style": _source(
        jtests.TestConfig.test_parses_reference_style_yaml),
    "fisheye": _source(jtests.TestConfig.test_fisheye_camera_type),
    "rig_3x4": _source(
        jtests.TestConfig.test_3x4_extrinsic_and_derived_baseline),
    "legacy_rectification": _source(
        jtests.TestStereoRectification.test_legacy_left_right_blocks),
    "resize": jtests.TestImageResize.YAML,
    "resize_same": jtests.TestImageResize.YAML.replace(
        "newWidth: 376", "newWidth: 752").replace("newHeight: 240",
                                                  "newHeight: 480"),
    "image_scale": """%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.0
Camera1.fy: 457.0
Camera1.cx: 376.0
Camera1.cy: 240.0
Camera.width: 752
Camera.height: 480
Camera.newWidth: 376
Camera.newHeight: 240
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""",
}


def _paths(tmp_path):
    out = {n: os.path.join(CFG_DIR, n) for n in SHIPPED}
    for name, text in TEXTS.items():
        p = tmp_path / f"{name}.yaml"
        p.write_text(text)
        out[name] = str(p)
    return out


def _same_value(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_value(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_value(x, y)
                                        for x, y in zip(a, b))
    if isinstance(b, str) and not isinstance(a, str):
        return float(b) == a          # PyYAML's string for 1e-5
    return a == b


def _assert_settings_equal(s, j):
    for f in dataclasses.fields(s):
        a, b = getattr(s, f.name), getattr(j, f.name)
        if f.name == "raw":
            assert a.keys() == b.keys()
            for k in a:
                assert _same_value(a[k], b[k]), (k, a[k], b[k])
        elif f.name in ("camera", "camera2"):
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert a._fields == b._fields and tuple(a) == tuple(b), (
                    f.name, a, b)
        elif f.name in ("T_bc", "T_c1c2"):
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) == type(b), (f.name, a, b)


@pytest.mark.parametrize("name", SHIPPED + sorted(TEXTS))
def test_load_settings_equals_jax(name, tmp_path):
    p = _paths(tmp_path)[name]
    _assert_settings_equal(config.load_settings(p), jconfig.load_settings(p))


@pytest.mark.parametrize("text", [
    "Camera.fx 458.0\n",                       # no colon
    "Camera.fx: [1.0, 2.0\n",                  # a list not closed
    "Camera.type: \"PinHole\n",                # a string not closed
    "Camera.fx: 1.0\n  rows: 3\n",             # indented outside a node
    "Camera.fx: 1.0\nCamera.fx: 2.0\n",        # a key twice
    "T: !!opencv-matrix\n  rows: 3\n  data: [1, , 2]\n",   # an empty item
    "- 1.0\n",                                 # a sequence entry
])
def test_unreadable_line_raises(text, tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text(HEADER + text)
    with pytest.raises(ValueError, match="line"):
        config.load_settings(str(p))


def test_matrix_node_and_lists_across_lines():
    d = config.parse_opencv_yaml(HEADER + """---
# a comment
M: !!opencv-matrix   # trailing comment
   rows: 2
   cols: 3
   dt: d
   data: [1, 2.5, -3e-2,
          4, 5,
          6,]
L: [1, 2,
    3]
S: bare words
E:
Q: 'a # b'
""")
    assert d["M"] == dict(rows=2, cols=3, dt="d",
                          data=[1, 2.5, -0.03, 4, 5, 6])
    assert d["L"] == [1, 2, 3] and d["S"] == "bare words"
    assert d["E"] is None and d["Q"] == "a # b"


@pytest.mark.parametrize("shape", [((480, 752), (376, 240)),
                                   ((480, 640), (512, 384))])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_resize_image_matches_cv2(shape, dtype):
    (h, w), size = shape
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (h, w)).astype(dtype)
    got = config.resize_image(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-3 if dtype == "float32" else 1
    assert np.abs(got.astype(np.float64) - want).max() <= tol
    assert config.resize_image(img, None) is img


def test_legacy_rectification_raises_naming_its_item():
    """Item 1.8 brought the legacy rectification, so nothing raises: a
    settings file without LEFT.* / RIGHT.* blocks has no maps (None, as in
    the JAX package), and the identity maps give the image back
    (tests/test_torch_datasets.py holds both to cv2)."""
    assert config.stereo_rectify_maps(config.Settings()) is None
    img = np.arange(20, dtype=np.float32).reshape(4, 5)
    u, v = np.meshgrid(np.arange(5, dtype=np.float32),
                       np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(config.rectify(img, (u, v)), img)


def _assert_wired_alike(slam, jslam):
    jt, tt = jslam.tracker, slam.tracker
    for f in dataclasses.fields(jt.cfg):
        assert getattr(tt.cfg, f.name) == getattr(jt.cfg, f.name), f.name
    assert tuple(tt.orb_cfg) == tuple(jt.orb_cfg)
    assert dataclasses.asdict(slam.map.cfg) == dataclasses.asdict(
        jslam.map.cfg)
    assert slam.enable_loop_closing == jslam.enable_loop_closing
    assert abs(tt.bf - float(jt.bf)) < 1e-4
    assert abs(tt.th_depth - float(jt.th_depth)) < 1e-5
    assert (tt.cam2 is None) == (jt.cam2 is None)
    if tt.T_rl is not None:
        np.testing.assert_allclose(tt.T_rl, np.asarray(jt.T_rl), atol=1e-6)
    assert (tt.imu is None) == (jt.imu is None)
    if tt.imu is not None:
        tc, jc = tt.imu.calib, jt.imu.calib
        for k in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc"):
            assert float(getattr(tc, k)) == float(getattr(jc, k)), k
        np.testing.assert_array_equal(tc.R_bc, np.asarray(jc.R_bc))
        np.testing.assert_array_equal(tc.t_bc, np.asarray(jc.t_bc))
    assert slam.get_image_scale() == jslam.get_image_scale()


@pytest.mark.parametrize("name", SHIPPED)
def test_from_settings_all_shipped(name):
    p = os.path.join(CFG_DIR, name)
    s = config.load_settings(p)
    slam = system.System.from_settings(s, system.MONOCULAR, device="cpu")
    assert slam.tracker.orb_cfg.n_features % 128 == 0
    assert slam.tracker.orb_cfg.n_features >= s.n_features
    _assert_wired_alike(slam, jsystem.System.from_settings(
        jconfig.load_settings(p), jsystem.MONOCULAR))


@pytest.mark.parametrize("sensor", ["IMU_STEREO", "IMU_MONOCULAR", "STEREO"])
def test_from_settings_wires_configs(sensor):
    """test_from_settings_wires_configs' checks on EuRoC.yaml, and every
    wired config equal to the JAX package's."""
    p = os.path.join(CFG_DIR, "EuRoC.yaml")
    s = config.load_settings(p)
    slam = system.System.from_settings(s, getattr(system, sensor),
                                       device="cpu")
    n_pad = int(np.ceil(s.n_features / 128.0)) * 128
    assert slam.tracker.orb_cfg.n_features == n_pad
    assert slam.tracker.orb_cfg.n_levels == s.n_levels
    assert abs(slam.tracker.orb_cfg.scale - s.scale_factor) < 1e-9
    assert slam.tracker.cfg.max_frames == int(round(s.fps))
    assert slam.map.cfg.n_feat == n_pad
    assert slam.tracker.cfg.ref_ratio == (0.9 if sensor == "IMU_MONOCULAR"
                                          else 0.75)  # thRefRatio
    if sensor.startswith("IMU"):
        assert abs(slam.tracker.imu.calib.noise_gyro
                   - s.imu_noise_gyro) < 1e-12
    _assert_wired_alike(slam, jsystem.System.from_settings(
        jconfig.load_settings(p), getattr(jsystem, sensor)))


def test_image_scale_from_settings(tmp_path):
    p = _paths(tmp_path)["image_scale"]
    slam = system.System.from_settings(config.load_settings(p),
                                       system.MONOCULAR, device="cpu")
    assert abs(slam.get_image_scale() - 0.5) < 1e-6
    assert slam.cam.width == 376 and abs(slam.cam.fx - 229.0) < 1e-9


def test_warmup_leaves_the_system_untouched():
    cam = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0,
                          width=376, height=240)
    slam = system.System(
        cam, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=512),
        tracking_cfg=tracking.TrackingConfig(n_features=512,
                                             min_init_matches=50),
        device="cpu")
    assert slam.warmup() is slam
    assert slam.map.n_kf == 0 and slam.map.n_points == 0
    assert slam.get_tracking_state() == tracking.NO_IMAGES_YET
    assert slam.tracker.frame_id == 0 and slam.tracker.trajectory == []
