"""ROS node: mono inertial (reference:
Examples/ROS/ORB_SLAM3/src/ros_mono_inertial.cc). See ``common`` for the arguments."""
import sys

from . import common


def main(argv=None) -> int:
    return common.main("mono_inertial", sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
