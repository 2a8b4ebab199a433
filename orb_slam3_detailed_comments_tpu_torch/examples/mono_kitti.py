"""Monocular KITTI odometry (reference: Examples/Monocular/mono_kitti.cc):
the left camera (image_0); writes the TUM trajectory (KITTI's format needs
metric scale, which monocular cannot give).

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.mono_kitti
        <settings.yaml> <sequence_dir> [<out>] [--device cpu]
"""
import sys

from . import runner


def main(argv=None) -> int:
    return runner.run_kitti(
        sys.argv[1:] if argv is None else argv, __doc__,
        stereo=False, default_out="trajectory_mono_kitti.txt")


if __name__ == "__main__":
    sys.exit(main())
