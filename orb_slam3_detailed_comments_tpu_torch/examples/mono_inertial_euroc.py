"""Monocular-inertial EuRoC (reference:
Examples/Monocular-Inertial/mono_inertial_euroc.cc).

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.mono_inertial_euroc
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.IMU_MONOCULAR, default_out="trajectory_tum.txt",
        inertial=True)


if __name__ == "__main__":
    sys.exit(main())
