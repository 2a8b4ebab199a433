"""ROS node: mono (reference:
Examples/ROS/ORB_SLAM3/src/ros_mono.cc). See ``common`` for the arguments."""
import sys

from . import common


def main(argv=None) -> int:
    return common.main("mono", sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
