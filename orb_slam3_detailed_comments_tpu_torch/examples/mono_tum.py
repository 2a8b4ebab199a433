"""Monocular TUM RGB-D (reference: Examples/Monocular/mono_tum.cc): the RGB
stream alone, depth ignored; writes the TUM trajectory.

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.mono_tum
        <settings.yaml> <sequence_dir> [<out>] [--device cpu]
"""
import sys

from . import runner


def main(argv=None) -> int:
    return runner.run_tum(
        sys.argv[1:] if argv is None else argv, __doc__,
        rgbd=False, default_out="trajectory_mono_tum.txt")


if __name__ == "__main__":
    sys.exit(main())
