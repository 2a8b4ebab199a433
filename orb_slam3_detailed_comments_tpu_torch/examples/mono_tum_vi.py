"""Monocular TUM-VI, fisheye without IMU (reference:
Examples/Monocular/mono_tum_vi.cc; the KannalaBrandt8 rig of TUM_512.yaml).
TUM-VI sequences ship in the EuRoC layout; frames are CLAHE-equalised
(clip limit 3.0, 8x8 tiles) like the reference main.

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.mono_tum_vi
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.MONOCULAR,
        default_out="trajectory_tum_vi_mono.txt", equalize=True)


if __name__ == "__main__":
    sys.exit(main())
