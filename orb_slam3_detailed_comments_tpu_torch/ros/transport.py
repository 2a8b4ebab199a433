"""Transport abstraction for the ROS nodes.

The reference nodes talk to roscpp directly (ros::Subscriber callbacks,
cv_bridge decoding — e.g. Examples/ROS/ORB_SLAM3/src/ros_stereo_inertial.cc).
Here message flow goes through a minimal Transport interface so the same
node classes run under rospy (RospyTransport) or fully in-process
(LocalTransport, used by the tests and by the dataset-replay entry points).
Counterpart of ``ros/transport.py`` of the JAX package; ``make_transport``
chooses between the two as it does.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Messages — the minimal payloads the nodes need, transport-independent.
# ---------------------------------------------------------------------------

@dataclass
class ImageMsg:
    """One camera frame. image: uint8 HxW (gray) or HxWx3 (bgr)."""
    stamp: float
    image: np.ndarray


@dataclass
class ImuMsg:
    """One IMU sample (reference: sensor_msgs/Imu in ros_mono_inertial.cc)."""
    stamp: float
    gyro: np.ndarray  # [3] rad/s
    acc: np.ndarray   # [3] m/s^2


@dataclass
class PoseMsg:
    """Tracking output: 4x4 world->camera transform (None while lost)."""
    stamp: float
    T_cw: Optional[np.ndarray]


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class Publisher:
    def publish(self, msg):  # pragma: no cover - interface
        raise NotImplementedError


class Transport:
    """What a node needs from the middleware: subscribe, advertise, liveness."""

    def subscribe(self, topic: str, cb: Callable) -> None:
        raise NotImplementedError

    def advertise(self, topic: str) -> Publisher:
        raise NotImplementedError

    def ok(self) -> bool:
        return True

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class _LocalPublisher(Publisher):
    def __init__(self, topic: str, hub: "LocalTransport"):
        self.topic = topic
        self._hub = hub
        self.messages: List = []

    def publish(self, msg):
        self.messages.append(msg)
        self._hub.deliver(self.topic, msg)


class LocalTransport(Transport):
    """Synchronous in-process pub/sub: deliver() invokes subscribers inline.

    Used by the tests and by the ROS entry points' dataset replay; also the
    shape a ROS2/rclpy adapter would take (subscribe/advertise map 1:1).
    """

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self._pubs: Dict[str, _LocalPublisher] = {}
        self._ok = True

    def subscribe(self, topic: str, cb: Callable) -> None:
        self._subs.setdefault(topic, []).append(cb)

    def advertise(self, topic: str) -> _LocalPublisher:
        pub = self._pubs.get(topic)
        if pub is None:
            pub = self._pubs[topic] = _LocalPublisher(topic, self)
        return pub

    def deliver(self, topic: str, msg) -> None:
        for cb in self._subs.get(topic, []):
            cb(msg)

    def published(self, topic: str) -> List:
        pub = self._pubs.get(topic)
        return pub.messages if pub else []

    def shutdown(self):
        self._ok = False

    def ok(self) -> bool:
        return self._ok

    def sleep(self, seconds: float) -> None:
        pass  # nothing is asynchronous locally


def _decode_ros_image(msg) -> np.ndarray:
    """sensor_msgs/Image -> numpy without cv_bridge (reference uses
    cv_bridge::toCvShare, ros_mono.cc; cv_bridge is not in this image)."""
    enc = msg.encoding.lower()
    buf = np.frombuffer(msg.data, np.uint8)
    if enc in ("mono8", "8uc1"):
        img = buf.reshape(msg.height, msg.step)[:, : msg.width]
    elif enc in ("bgr8", "rgb8"):
        img = buf.reshape(msg.height, msg.step)[:, : msg.width * 3]
        img = img.reshape(msg.height, msg.width, 3)
        if enc == "rgb8":
            img = img[..., ::-1]
    elif enc in ("mono16", "16uc1"):
        img = buf.view(np.uint16).reshape(msg.height, msg.step // 2)
        img = img[:, : msg.width]
    elif enc == "32fc1":
        img = buf.view(np.float32).reshape(msg.height, msg.step // 4)
        img = img[:, : msg.width]
    else:  # pragma: no cover - exotic encodings
        raise ValueError(f"unsupported image encoding {msg.encoding}")
    return np.ascontiguousarray(img)


class RospyTransport(Transport):  # pragma: no cover - needs a ROS master
    """rospy adapter. Import-gated: only constructed when rospy exists."""

    def __init__(self, node_name: str):
        import rospy  # noqa: F401 - hard requirement for this transport
        from sensor_msgs.msg import Image, Imu
        self._rospy = rospy
        self._Image, self._Imu = Image, Imu
        rospy.init_node(node_name, anonymous=False)

    def subscribe(self, topic: str, cb: Callable) -> None:
        rospy = self._rospy
        if "imu" in topic:
            def on_imu(m):
                cb(ImuMsg(
                    stamp=m.header.stamp.to_sec(),
                    gyro=np.array([m.angular_velocity.x,
                                   m.angular_velocity.y,
                                   m.angular_velocity.z]),
                    acc=np.array([m.linear_acceleration.x,
                                  m.linear_acceleration.y,
                                  m.linear_acceleration.z])))
            rospy.Subscriber(topic, self._Imu, on_imu, queue_size=1000)
        else:
            def on_img(m):
                cb(ImageMsg(stamp=m.header.stamp.to_sec(),
                            image=_decode_ros_image(m)))
            rospy.Subscriber(topic, self._Image, on_img, queue_size=100)

    def advertise(self, topic: str) -> Publisher:
        rospy = self._rospy
        from geometry_msgs.msg import PoseStamped
        pub = rospy.Publisher(topic, PoseStamped, queue_size=10)

        class _P(Publisher):
            def publish(self, msg):
                if getattr(msg, "T_cw", None) is None:
                    return
                # invert: publish camera-in-world like the reference viewers
                T = np.asarray(msg.T_cw)
                R, t = T[:3, :3], T[:3, 3]
                Rwc, twc = R.T, -R.T @ t
                q = _rot_to_quat(Rwc)
                m = PoseStamped()
                m.header.stamp = rospy.Time.from_sec(msg.stamp)
                m.header.frame_id = "world"
                (m.pose.position.x, m.pose.position.y,
                 m.pose.position.z) = twc
                (m.pose.orientation.x, m.pose.orientation.y,
                 m.pose.orientation.z, m.pose.orientation.w) = q
                pub.publish(m)

        return _P()

    def ok(self) -> bool:
        return not self._rospy.is_shutdown()


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def make_transport(node_name: str) -> Transport:
    """RospyTransport when rospy is importable, else LocalTransport.
    The CLIs use this so they run (replaying from disk) without ROS."""
    try:
        import rospy  # noqa: F401
    except ImportError:
        return LocalTransport()
    return RospyTransport(node_name)
