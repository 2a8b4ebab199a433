"""RGB-D TUM (reference: Examples/RGB-D/rgbd_tum.cc).

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.rgbd_tum
        <settings.yaml> <sequence_dir> [<out>] [--device cpu]
"""
import sys

from . import runner


def main(argv=None) -> int:
    return runner.run_tum(
        sys.argv[1:] if argv is None else argv, __doc__,
        rgbd=True, default_out="trajectory_rgbd.txt")


if __name__ == "__main__":
    sys.exit(main())
