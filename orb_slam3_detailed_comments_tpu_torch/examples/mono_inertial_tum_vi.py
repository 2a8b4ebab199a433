"""Monocular-inertial TUM-VI, fisheye (reference:
Examples/Monocular-Inertial/mono_inertial_tum_vi.cc). Frames are
CLAHE-equalised like the reference main.

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.mono_inertial_tum_vi
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.IMU_MONOCULAR,
        default_out="trajectory_tum_vi_mono.txt", inertial=True, equalize=True)


if __name__ == "__main__":
    sys.exit(main())
