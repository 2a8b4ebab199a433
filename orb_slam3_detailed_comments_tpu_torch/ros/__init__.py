"""ROS integration layer (reference: Examples/ROS/ORB_SLAM3/src/*.cc).

Counterpart of ``ros/`` of the JAX package, without OpenCV: the nodes'
CLAHE is ``utils/clahe`` (numpy, equal to cv2's), and stereo
rectification is ``utils/config.rectify``.

The reference ships five roscpp nodes (ros_mono, ros_mono_inertial,
ros_stereo, ros_stereo_inertial, ros_rgbd) plus an AR demo (src/AR).
Here the node logic (buffering, stereo pairing, image<->IMU
synchronization, CLAHE, rectification) is transport-independent pure
Python in `nodes.py`, bound to rospy only through the thin
`transport.RospyTransport` adapter — so every node is unit-testable
without a ROS install (this environment has none) and runs unchanged
under a real ROS master when one exists.
"""
from . import transport, nodes  # noqa: F401
