"""ROS node logic, transport-independent (counterpart of ``ros/nodes.py`` of
the JAX package).

One class per reference node (Examples/ROS/ORB_SLAM3/src/):
  MonoNode            <- ros_mono.cc
  MonoInertialNode    <- ros_mono_inertial.cc   (ImuGrabber + SyncWithImu)
  StereoNode          <- ros_stereo.cc          (left/right pairing + rectify)
  StereoInertialNode  <- ros_stereo_inertial.cc
  RGBDNode            <- ros_rgbd.cc            (approximate rgb/depth sync)
  MonoARNode          <- AR/ros_mono_ar.cc      (plane detect + cube overlay)

The reference synchronizes with a dedicated SyncWithImu thread polling
mutex-guarded queues. Here the same policy is a re-entrant `sync_once()`
step — `run()` loops it under a live transport; the tests and the replay
CLI drive it directly, deterministically.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, List, Optional, Tuple

import numpy as np

from ..utils import clahe
from .transport import ImageMsg, ImuMsg, PoseMsg, Transport

# Reference pairing tolerance for stereo / rgbd approximate sync
# (ros_stereo_inertial.cc SyncWithImu: |tImLeft - tImRight| <= 0.01).
MAX_PAIR_DT = 0.01


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        # BT.601 luma, same as cv::cvtColor BGR2GRAY used by the reference
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        return (0.114 * b + 0.587 * g + 0.299 * r).astype(img.dtype)
    return img


def _clahe(img: np.ndarray) -> np.ndarray:
    """CLAHE(3.0, 8x8) like the inertial nodes' mClahe
    (ros_stereo_inertial.cc:70), in numpy: cv2.createCLAHE(3.0, (8, 8))
    .apply's result (``utils/clahe``)."""
    return clahe.clahe(img.astype(np.uint8))


class ImuBuffer:
    """Thread-safe IMU queue (reference: ImuGrabber, ros_mono_inertial.cc)."""

    def __init__(self, maxlen: int = 20000):
        self._buf: Deque[ImuMsg] = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def push(self, m: ImuMsg) -> None:
        with self._lock:
            self._buf.append(m)

    def latest_stamp(self) -> Optional[float]:
        with self._lock:
            return self._buf[-1].stamp if self._buf else None

    def window(self, t0: float, t1: float):
        """Pop-and-return samples with t0 < t <= t1 as the (acc, gyro, t)
        arrays System.track_* expects; drops samples at or before t0
        (reference: SyncWithImu's vImuMeas loop)."""
        acc, gyro, ts = [], [], []
        with self._lock:
            while self._buf and self._buf[0].stamp <= t0:
                self._buf.popleft()
            while self._buf and self._buf[0].stamp <= t1:
                m = self._buf.popleft()
                acc.append(m.acc)
                gyro.append(m.gyro)
                ts.append(m.stamp)
        if not ts:
            return None
        return (np.asarray(acc, np.float64), np.asarray(gyro, np.float64),
                np.asarray(ts, np.float64))


class _NodeBase:
    POSE_TOPIC = "/orb_slam3/camera_pose"

    def __init__(self, slam, equalize: bool = False):
        self.slam = slam
        self.equalize = equalize
        self._pose_pub = None
        self.n_tracked = 0

    def _prep_image(self, img: np.ndarray) -> np.ndarray:
        g = _to_gray(img)
        return _clahe(g) if self.equalize else g

    def _publish(self, T_cw, stamp: float) -> None:
        self.n_tracked += 1
        if self._pose_pub is not None:
            self._pose_pub.publish(PoseMsg(stamp=stamp, T_cw=T_cw))

    def attach(self, tr: Transport, **topics) -> "._NodeBase":
        self._pose_pub = tr.advertise(self.POSE_TOPIC)
        self._attach(tr, **topics)
        return self

    def sync_once(self) -> bool:
        """Process at most one pending frame; True if one was consumed."""
        return False

    def run(self, tr: Transport, idle_sleep: float = 0.001) -> None:
        """Reference SyncWithImu-thread equivalent: poll until shutdown."""
        while tr.ok():
            if not self.sync_once():
                tr.sleep(idle_sleep)


class MonoNode(_NodeBase):
    """reference: ros_mono.cc — image callback straight into TrackMonocular."""

    def _attach(self, tr: Transport, image: str = "/camera/image_raw"):
        tr.subscribe(image, self.on_image)

    def on_image(self, m: ImageMsg) -> None:
        T = self.slam.track_monocular(self._prep_image(m.image), m.stamp)
        self._publish(T, m.stamp)


class MonoInertialNode(_NodeBase):
    """reference: ros_mono_inertial.cc — buffer both streams, track a frame
    only once IMU coverage reaches its stamp."""

    def __init__(self, slam, equalize: bool = False):
        super().__init__(slam, equalize)
        self.imu = ImuBuffer()
        self._images: Deque[ImageMsg] = collections.deque(maxlen=100)
        self._lock = threading.Lock()
        self._t_prev: Optional[float] = None

    def _attach(self, tr: Transport, image: str = "/camera/image_raw",
                imu: str = "/imu"):
        tr.subscribe(image, self.on_image)
        tr.subscribe(imu, self.imu.push)

    def on_image(self, m: ImageMsg) -> None:
        with self._lock:
            self._images.append(m)

    def sync_once(self) -> bool:
        with self._lock:
            if not self._images:
                return False
            t_img = self._images[0].stamp
            t_imu = self.imu.latest_stamp()
            if t_imu is None or t_imu < t_img:
                return False  # wait for IMU to catch up (SyncWithImu gate)
            m = self._images.popleft()
        t0 = self._t_prev if self._t_prev is not None else m.stamp - 1.0
        window = self.imu.window(t0, m.stamp)
        self._t_prev = m.stamp
        T = self.slam.track_monocular(self._prep_image(m.image), m.stamp,
                                      imu=window)
        self._publish(T, m.stamp)
        return True


class StereoNode(_NodeBase):
    """reference: ros_stereo.cc — pair left/right within MAX_PAIR_DT,
    optionally rectify with the settings' LEFT./RIGHT. maps."""

    def __init__(self, slam, equalize: bool = False, rectify_maps=None):
        super().__init__(slam, equalize)
        self._left: Deque[ImageMsg] = collections.deque(maxlen=100)
        self._right: Deque[ImageMsg] = collections.deque(maxlen=100)
        self._lock = threading.Lock()
        self._maps = rectify_maps  # (maps_l, maps_r) from config.stereo_rectify_maps

    def _attach(self, tr: Transport, left: str = "/camera/left/image_raw",
                right: str = "/camera/right/image_raw"):
        tr.subscribe(left, lambda m: self._push(self._left, m))
        tr.subscribe(right, lambda m: self._push(self._right, m))

    def _push(self, q: Deque[ImageMsg], m: ImageMsg) -> None:
        with self._lock:
            q.append(m)

    def _pop_pair(self) -> Optional[Tuple[ImageMsg, ImageMsg]]:
        """Drop the older unmatched frames until a pair agrees within
        MAX_PAIR_DT (reference: ros_stereo_inertial.cc:176-199)."""
        with self._lock:
            while self._left and self._right:
                dt = self._left[0].stamp - self._right[0].stamp
                if dt < -MAX_PAIR_DT:
                    self._left.popleft()
                elif dt > MAX_PAIR_DT:
                    self._right.popleft()
                else:
                    return self._left.popleft(), self._right.popleft()
        return None

    def _rectify(self, gl: np.ndarray, gr: np.ndarray):
        if self._maps is None:
            return gl, gr
        from ..utils import config
        return (config.rectify(gl, self._maps[0]),
                config.rectify(gr, self._maps[1]))

    def sync_once(self) -> bool:
        pair = self._pop_pair()
        if pair is None:
            return False
        ml, mr = pair
        gl, gr = self._prep_image(ml.image), self._prep_image(mr.image)
        gl, gr = self._rectify(gl, gr)
        T = self.slam.track_stereo(gl, gr, ml.stamp)
        self._publish(T, ml.stamp)
        return True

    # stereo images arrive via callbacks; nothing to do inline
    def on_ready(self):  # pragma: no cover - symmetry helper
        pass


class StereoInertialNode(StereoNode):
    """reference: ros_stereo_inertial.cc — stereo pairing + IMU gating."""

    def __init__(self, slam, equalize: bool = False, rectify_maps=None):
        super().__init__(slam, equalize, rectify_maps)
        self.imu = ImuBuffer()
        self._t_prev: Optional[float] = None

    def _attach(self, tr: Transport, left: str = "/camera/left/image_raw",
                right: str = "/camera/right/image_raw", imu: str = "/imu"):
        super()._attach(tr, left=left, right=right)
        tr.subscribe(imu, self.imu.push)

    def sync_once(self) -> bool:
        with self._lock:
            if not self._left or not self._right:
                return False
            t_img = max(self._left[0].stamp, self._right[0].stamp)
        t_imu = self.imu.latest_stamp()
        if t_imu is None or t_imu < t_img:
            return False
        pair = self._pop_pair()
        if pair is None:
            return False
        ml, mr = pair
        t0 = self._t_prev if self._t_prev is not None else ml.stamp - 1.0
        window = self.imu.window(t0, ml.stamp)
        self._t_prev = ml.stamp
        gl, gr = self._prep_image(ml.image), self._prep_image(mr.image)
        gl, gr = self._rectify(gl, gr)
        T = self.slam.track_stereo(gl, gr, ml.stamp, imu=window)
        self._publish(T, ml.stamp)
        return True


class RGBDNode(_NodeBase):
    """reference: ros_rgbd.cc — ApproximateTime sync of rgb + registered
    depth, then TrackRGBD."""

    def __init__(self, slam, depth_factor: float = 1.0):
        super().__init__(slam)
        self._rgb: Deque[ImageMsg] = collections.deque(maxlen=100)
        self._depth: Deque[ImageMsg] = collections.deque(maxlen=100)
        self._lock = threading.Lock()
        self.depth_factor = depth_factor  # uint16 -> meters divisor

    def _attach(self, tr: Transport, rgb: str = "/camera/rgb/image_raw",
                depth: str = "/camera/depth_registered/image_raw"):
        tr.subscribe(rgb, lambda m: self._push(self._rgb, m))
        tr.subscribe(depth, lambda m: self._push(self._depth, m))

    def _push(self, q: Deque[ImageMsg], m: ImageMsg) -> None:
        with self._lock:
            q.append(m)

    def sync_once(self) -> bool:
        with self._lock:
            while self._rgb and self._depth:
                dt = self._rgb[0].stamp - self._depth[0].stamp
                if dt < -MAX_PAIR_DT:
                    self._rgb.popleft()
                elif dt > MAX_PAIR_DT:
                    self._depth.popleft()
                else:
                    break
            if not (self._rgb and self._depth):
                return False
            mi, md = self._rgb.popleft(), self._depth.popleft()
        depth = md.image
        if depth.dtype != np.float32:
            depth = depth.astype(np.float32) / float(self.depth_factor)
        T = self.slam.track_rgbd(self._prep_image(mi.image), depth, mi.stamp)
        self._publish(T, mi.stamp)
        return True


class MonoARNode(MonoNode):
    """reference: AR/ros_mono_ar.cc + ViewerAR — track, detect a dominant
    plane from the tracked map points, and render a virtual cube into the
    frame, published on /orb_slam3/ar_image (headless: no Pangolin)."""

    AR_TOPIC = "/orb_slam3/ar_image"

    def __init__(self, slam, cube_size: float = 0.2):
        super().__init__(slam)
        self.cube_size = cube_size
        self.plane = None
        self._ar_pub = None
        self.n_overlaid = 0

    def attach(self, tr: Transport, **topics):
        self._ar_pub = tr.advertise(self.AR_TOPIC)
        return super().attach(tr, **topics)

    def on_image(self, m: ImageMsg) -> None:
        gray = self._prep_image(m.image)
        T = self.slam.track_monocular(gray, m.stamp)
        self._publish(T, m.stamp)
        if T is None:
            return
        from ..viz import viewer_ar
        if self.plane is None:
            ids = self.slam.get_tracked_map_points()
            ids = ids[ids >= 0]
            if len(ids) >= 30:
                pts = np.asarray(self.slam.map.pt_xyz)[ids]
                self.plane = viewer_ar.detect_plane(pts, T)
        if self.plane is not None and self._ar_pub is not None:
            img = viewer_ar.draw_cube(gray, self.slam.cam, T, self.plane,
                                      self.cube_size)
            self.n_overlaid += 1
            self._ar_pub.publish(ImageMsg(stamp=m.stamp, image=img))
