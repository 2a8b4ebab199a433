"""Stereo KITTI odometry (reference: Examples/Stereo/stereo_kitti.cc);
writes the KITTI trajectory (3x4 row-major world poses per line).

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.stereo_kitti
        <settings.yaml> <sequence_dir> [<out>] [--device cpu]
"""
import sys

from . import runner


def main(argv=None) -> int:
    return runner.run_kitti(
        sys.argv[1:] if argv is None else argv, __doc__,
        stereo=True, default_out="trajectory_kitti.txt")


if __name__ == "__main__":
    sys.exit(main())
