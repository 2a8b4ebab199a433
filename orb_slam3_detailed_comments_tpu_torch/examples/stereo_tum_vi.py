"""Stereo TUM-VI, fisheye without IMU (reference:
Examples/Stereo/stereo_tum_vi.cc; Camera1 / Camera2 and Stereo.T_c1_c2 of
TUM_512.yaml). Frames are CLAHE-equalised like the reference main.

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.stereo_tum_vi
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.STEREO,
        default_out="trajectory_tum_vi_stereo.txt", stereo=True, equalize=True)


if __name__ == "__main__":
    sys.exit(main())
