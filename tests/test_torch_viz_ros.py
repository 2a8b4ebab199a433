"""The port's viewers and ROS layer against the JAX package's and cv2.

Mirrors ``tests/test_viz.py`` (3) and ``tests/test_ros_nodes.py`` (9) on
the port, and holds the numpy drawing to OpenCV:

- ``fill_circle`` and ``line`` equal ``cv2.circle`` (filled) and
  ``cv2.line`` (LINE_8) pixel for pixel, and ``draw_map_topdown`` equals
  the JAX package's (cv2-drawn) render of the same map;
- ``draw_frame``'s keypoints equal the JAX package's; its state text (a
  bitmap font of the port's own) stays inside its box;
- the AR cube's corner pixels equal the JAX package's, and its
  anti-aliased wireframe is within a mean of 1.5 grey levels per channel
  of cv2's LINE_AA render, with 85 % of cv2's green pixels shared;
- the CLAHE of the nodes equals ``cv2.createCLAHE(3.0, (8, 8)).apply``
  bit for bit.

The mono AR node runs end to end with a real System on the JAX test's
case (752x480, world seed 5, its 24-frame orbit), fed the first 14 frames
(about 27 s on one worker): at 376x240 no world tried gave the node its
dominant plane within 12 frames.
"""
import json

import cv2
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.viz import drawers as jdrawers
from orb_slam3_detailed_comments_tpu.viz import viewer_ar as jviewer_ar
from orb_slam3_detailed_comments_tpu.viz import webviewer as jwebviewer
from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
    MapConfig, MapStore)
from orb_slam3_detailed_comments_tpu_torch.ros import nodes
from orb_slam3_detailed_comments_tpu_torch.ros.transport import (
    ImageMsg, ImuMsg, LocalTransport, _decode_ros_image)
from orb_slam3_detailed_comments_tpu_torch.utils import clahe
from orb_slam3_detailed_comments_tpu_torch.viz import (drawers, viewer_ar,
                                                        webviewer)

torch.set_num_threads(2)


def _tiny_map(n_kf=4, n_pts=50, store=MapStore, cfg=MapConfig, **kw):
    m = store(cfg(max_kf=16, max_pt=256, n_feat=64), **kw)
    rng = np.random.default_rng(0)
    ids = m.alloc_points(n_pts)
    m.pt_xyz[ids] = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    m.pt_valid[ids] = True
    F = 64
    for i in range(n_kf):
        # every KF observes the same first 32 points -> covisibility >= 15
        fp = np.full(F, -1, np.int64)
        fp[:32] = ids[:32]
        m.add_keyframe(np.eye(3, dtype=np.float32),
                       np.array([0.1 * i, 0, 0], np.float32),
                       float(i), i,
                       np.zeros((F, 2), np.float32),
                       np.zeros((F, 2), np.float32),
                       np.zeros(F, np.int32), np.zeros(F, np.float32),
                       np.zeros((F, 8), np.uint32), fp >= 0, fp)
    return m


def _payload(path):
    return json.loads(
        open(path).read().split("const DATA = ", 1)[1].split(";\n", 1)[0])


def test_export_html_mapstore(tmp_path):
    m = _tiny_map(device="cpu")
    out = str(tmp_path / "viewer.html")
    webviewer.export_html(m, out, trajectory=np.zeros((7, 3)))
    html = open(out).read()
    assert "<canvas" in html
    payload = _payload(out)
    assert len(payload["maps"]) == 1
    mp = payload["maps"][0]
    assert len(mp["points"]) == 50
    assert len(mp["kf_centers"]) == 4
    assert len(mp["kf_axes"][0]) == 9
    assert len(mp["covis"]) == 4 * 3 // 2       # all pairs share 32 points
    assert len(payload["traj"]) == 7
    # the same page as the JAX package's for the same map
    jout = str(tmp_path / "jax.html")
    jwebviewer.export_html(_tiny_map(store=jms.MapStore, cfg=jms.MapConfig),
                           jout, trajectory=np.zeros((7, 3)))
    assert open(jout).read() == html


def test_export_html_point_subsample(tmp_path):
    m = _tiny_map(device="cpu")
    out = str(tmp_path / "viewer.html")
    webviewer.export_html(m, out, max_points=10)
    assert len(_payload(out)["maps"][0]["points"]) == 10


def test_draw_map_topdown_runs():
    img = drawers.draw_map_topdown(_tiny_map(device="cpu"))
    assert img.ndim == 3 and img.shape[2] == 3
    want = jdrawers.draw_map_topdown(
        _tiny_map(store=jms.MapStore, cfg=jms.MapConfig))
    np.testing.assert_array_equal(img, want)


def test_circles_and_lines_equal_cv2():
    rng = np.random.default_rng(0)
    for r in (1, 2, 3, 5, 9):
        for _ in range(20):
            a = np.zeros((40, 50, 3), np.uint8)
            b = a.copy()
            c = (int(rng.integers(-5, 55)), int(rng.integers(-5, 45)))
            cv2.circle(a, c, r, (0, 255, 0), -1)
            drawers.fill_circle(b, c, r, (0, 255, 0))
            np.testing.assert_array_equal(a, b)
    for _ in range(200):
        a = np.zeros((60, 70, 3), np.uint8)
        b = a.copy()
        p = tuple(int(v) for v in rng.integers(0, 60, 2))
        q = tuple(int(v) for v in rng.integers(0, 60, 2))
        cv2.line(a, p, q, (0, 128, 255), 1)
        drawers.line(b, p, q, (0, 128, 255))
        np.testing.assert_array_equal(a, b)


def test_draw_frame_keypoints_equal_jax_and_text_in_its_box(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rng.uniform(-5, 165, (80, 2)).astype(np.float32)
    valid = rng.uniform(size=80) < 0.9
    matched = rng.uniform(size=80) < 0.5
    got = drawers.draw_frame(img, xy, valid, matched)
    np.testing.assert_array_equal(got,
                                  jdrawers.draw_frame(img, xy, valid,
                                                      matched))
    text = "mono f10 kf=3 pts=120"
    with_text = drawers.draw_frame(img, xy, valid, matched, text)
    changed = np.nonzero((with_text != got).any(axis=2))
    x0, y0, x1, y1 = drawers.text_box(text, (10, img.shape[0] - 12))
    assert len(changed[0]) > 5 * len(text.replace(" ", ""))
    assert changed[0].min() >= y0 and changed[0].max() <= y1
    assert changed[1].min() >= x0 and changed[1].max() <= x1
    drawers.save_png(str(tmp_path / "f.png"), with_text)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "f.png")),
                                  with_text)


def test_ar_cube_corners_equal_jax_and_image_near_cv2():
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    cam = cameras.pinhole(229.0, 228.5, 188.0, 120.0, 376, 240)
    rng = np.random.default_rng(2)
    xy = rng.uniform(-1, 1, (120, 2))
    pts = np.stack([xy[:, 0], np.full(120, 0.5), xy[:, 1] + 3.0], 1)
    T_cw = np.eye(4)
    T_cw[:3, :3] = cv2.Rodrigues(np.array([0.4, 0.1, 0.0]))[0]
    pl = viewer_ar.detect_plane(pts, T_cw)
    jpl = jviewer_ar.detect_plane(pts, T_cw)
    np.testing.assert_array_equal(pl.R_wp, jpl.R_wp)
    np.testing.assert_array_equal(pl.origin, jpl.origin)
    np.testing.assert_array_equal(viewer_ar.cube_corners_world(pl, 0.4),
                                  jviewer_ar.cube_corners_world(jpl, 0.4))
    uv = viewer_ar.cube_pixels(cam, T_cw, pl, 0.4)
    pc = jviewer_ar.cube_corners_world(jpl, 0.4) @ T_cw[:3, :3].T \
        + T_cw[:3, 3]
    ju = np.round(cam.fx * pc[:, 0] / pc[:, 2] + cam.cx).astype(int)
    jv = np.round(cam.fy * pc[:, 1] / pc[:, 2] + cam.cy).astype(int)
    np.testing.assert_array_equal(uv, np.stack([ju, jv], 1))
    gray = rng.integers(0, 120, (240, 376)).astype(np.uint8)
    got = viewer_ar.draw_cube(gray, cam, T_cw, pl, 0.4)
    want = jviewer_ar.draw_cube(gray, cam, T_cw, jpl, 0.4)
    assert got.shape == want.shape == (240, 376, 3)
    assert np.abs(got.astype(int) - want).mean() < 1.5
    g_got = got[..., 1].astype(int) - got[..., 0] > 80
    g_want = want[..., 1].astype(int) - want[..., 0] > 80
    assert g_want.sum() > 200
    assert (g_got & g_want).sum() >= 0.85 * g_want.sum()
    assert g_got.sum() <= 1.15 * g_want.sum()


@pytest.mark.parametrize("shape", [(480, 752), (240, 376), (101, 157)])
def test_clahe_equals_cv2(shape):
    rng = np.random.default_rng(shape[0])
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = (np.sin(xx / 40.0) + np.cos(yy / 23.0)) * 60 + 128
    for img in (rng.integers(0, 256, shape).astype(np.uint8),
                (smooth + rng.normal(0, 5, shape)).clip(0, 255)
                .astype(np.uint8),
                rng.integers(90, 110, shape).astype(np.uint8)):
        want = cv2.createCLAHE(3.0, (8, 8)).apply(img)
        np.testing.assert_array_equal(clahe.clahe(img), want)
        np.testing.assert_array_equal(nodes._clahe(img), want)


# ---- the ROS nodes (tests/test_ros_nodes.py on the port) -------------------

class FakeSlam:
    """Records track_* calls; returns identity pose."""

    def __init__(self):
        self.calls = []
        self.cam = None

    def _pose(self):
        return np.eye(4)

    def track_monocular(self, img, ts, imu=None):
        self.calls.append(("mono", img, ts, imu))
        return self._pose()

    def track_stereo(self, l, r, ts, imu=None):
        self.calls.append(("stereo", l, r, ts, imu))
        return self._pose()

    def track_rgbd(self, img, depth, ts, imu=None):
        self.calls.append(("rgbd", img, depth, ts, imu))
        return self._pose()


def _img(stamp, w=8, h=6, val=None):
    data = np.full((h, w), val if val is not None else int(stamp * 10) % 255,
                   np.uint8)
    return ImageMsg(stamp=stamp, image=data)


def test_mono_node_tracks_every_frame():
    slam, tr = FakeSlam(), LocalTransport()
    node = nodes.MonoNode(slam).attach(tr)
    for i in range(5):
        tr.deliver("/camera/image_raw", _img(i * 0.1))
    assert len(slam.calls) == 5
    assert len(tr.published(node.POSE_TOPIC)) == 5
    assert slam.calls[0][1].ndim == 2


def test_mono_node_converts_bgr():
    slam, tr = FakeSlam(), LocalTransport()
    nodes.MonoNode(slam).attach(tr)
    bgr = np.zeros((6, 8, 3), np.uint8)
    bgr[..., 2] = 200
    tr.deliver("/camera/image_raw", ImageMsg(0.0, bgr))
    g = slam.calls[0][1]
    assert g.ndim == 2 and abs(int(g[0, 0]) - int(0.299 * 200)) <= 1


def test_mono_node_equalizes_like_cv2():
    slam, tr = FakeSlam(), LocalTransport()
    nodes.MonoNode(slam, equalize=True).attach(tr)
    img = np.random.default_rng(4).integers(60, 140, (48, 64)).astype(
        np.uint8)
    tr.deliver("/camera/image_raw", ImageMsg(0.0, img))
    np.testing.assert_array_equal(slam.calls[0][1],
                                  cv2.createCLAHE(3.0, (8, 8)).apply(img))


def test_mono_inertial_gates_on_imu_coverage():
    slam, tr = FakeSlam(), LocalTransport()
    node = nodes.MonoInertialNode(slam).attach(tr)
    tr.deliver("/camera/image_raw", _img(0.10))
    assert node.sync_once() is False and not slam.calls
    for k in range(30):
        tr.deliver("/imu", ImuMsg(k * 0.005, np.ones(3) * k, np.ones(3)))
    assert node.sync_once() is True
    tr.deliver("/camera/image_raw", _img(0.145))
    assert node.sync_once() is True
    _, _, ts0, w0 = slam.calls[0]
    _, _, ts1, w1 = slam.calls[1]
    assert w0[2][0] == 0.0 and w0[2][-1] == pytest.approx(0.10)
    assert w1[2][0] == pytest.approx(0.105)
    assert w1[2][-1] == pytest.approx(0.145)
    assert len(w0[2]) + len(w1[2]) == 21 + 9
    assert w1[0].shape == (9, 3) and w1[1][0][0] == 21


def test_stereo_node_pairs_and_drops():
    slam, tr = FakeSlam(), LocalTransport()
    node = nodes.StereoNode(slam).attach(tr)
    tr.deliver("/camera/left/image_raw", _img(0.00))
    tr.deliver("/camera/left/image_raw", _img(0.100))
    tr.deliver("/camera/right/image_raw", _img(0.103))
    assert node.sync_once() is True
    assert node.sync_once() is False
    assert len(slam.calls) == 1
    assert slam.calls[0][3] == pytest.approx(0.100)


def test_stereo_inertial_waits_for_imu():
    slam, tr = FakeSlam(), LocalTransport()
    node = nodes.StereoInertialNode(slam).attach(tr)
    tr.deliver("/camera/left/image_raw", _img(0.05))
    tr.deliver("/camera/right/image_raw", _img(0.05))
    assert node.sync_once() is False
    for k in range(15):
        tr.deliver("/imu", ImuMsg(k * 0.005, np.zeros(3), np.zeros(3)))
    assert node.sync_once() is True
    kind, _, _, ts, w = slam.calls[0]
    assert kind == "stereo" and w is not None and w[2][-1] <= 0.05 + 1e-9


def test_rgbd_node_scales_uint16_depth():
    slam, tr = FakeSlam(), LocalTransport()
    node = nodes.RGBDNode(slam, depth_factor=5000.0).attach(tr)
    tr.deliver("/camera/rgb/image_raw", _img(1.0))
    d = np.full((6, 8), 10000, np.uint16)
    tr.deliver("/camera/depth_registered/image_raw", ImageMsg(1.004, d))
    assert node.sync_once() is True
    depth = slam.calls[0][2]
    assert depth.dtype == np.float32 and depth[0, 0] == pytest.approx(2.0)


def test_decode_ros_image_encodings():
    class Msg:
        pass

    for enc, arr in [("mono8", np.arange(48, dtype=np.uint8).reshape(6, 8)),
                     ("16uc1",
                      (np.arange(48, dtype=np.uint16) * 100).reshape(6, 8)),
                     ("32fc1",
                      np.linspace(0, 1, 48, dtype=np.float32).reshape(6, 8))]:
        m = Msg()
        m.encoding, m.height, m.width = enc, 6, 8
        m.step = arr.strides[0]
        m.data = arr.tobytes()
        out = _decode_ros_image(m)
        assert out.shape == (6, 8) and np.array_equal(out, arr)
    m = Msg()
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[..., 0] = 7
    m.encoding, m.height, m.width, m.step = "rgb8", 2, 2, 6
    m.data = rgb.tobytes()
    out = _decode_ros_image(m)
    assert out.shape == (2, 2, 3) and out[0, 0, 2] == 7


def test_detect_plane_geometry():
    rng = np.random.default_rng(2)
    n_in, n_out = 140, 60
    xy = rng.uniform(-1, 1, (n_in, 2))
    pts_in = np.stack([xy[:, 0], np.full(n_in, 0.5), xy[:, 1]], 1)
    pts_out = rng.uniform(-2, 2, (n_out, 3))
    pts = np.concatenate([pts_in, pts_out])
    T_cw = np.eye(4)
    T_cw[:3, 3] = [0, -2.0, 0]
    pl = viewer_ar.detect_plane(pts, T_cw, n_hyp=100)
    assert pl is not None and pl.n_inliers >= 0.9 * n_in
    assert abs(abs(pl.R_wp[:, 2] @ np.array([0, 1, 0])) - 1) < 1e-3
    assert pl.R_wp[1, 2] > 0


def test_mono_ar_end_to_end():
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline.system import (
        MONOCULAR, System)
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

    cam = cameras.pinhole(fx=458.0, fy=457.0, cx=376.0, cy=240.0,
                          width=752, height=480)
    planes = synth_render.default_world(np.random.default_rng(5))
    n = 14
    R, t = synth_render.orbit_trajectory(24)
    slam = System(cam, MONOCULAR, device="cpu")
    tr = LocalTransport()
    node = nodes.MonoARNode(slam, cube_size=0.4).attach(tr)
    for i in range(n):
        img = synth_render.render_frame_raycast(cam, planes, R[i], t[i])[0]
        tr.deliver("/camera/image_raw",
                   ImageMsg(i * 0.05, np.clip(img, 0, 255).astype(np.uint8)))
    poses = tr.published(node.POSE_TOPIC)
    assert sum(p.T_cw is not None for p in poses) > 0.5 * n
    assert node.plane is not None, "no dominant plane found"
    ar = tr.published(node.AR_TOPIC)
    assert node.n_overlaid > 0 and len(ar) == node.n_overlaid
    out = ar[-1].image
    assert out.ndim == 3
    green = (out[..., 1].astype(int) - out[..., 0].astype(int) > 80).sum()
    assert green > 50, f"cube not visible ({green} green px)"
