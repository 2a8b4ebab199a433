"""Stereo-inertial TUM-VI, fisheye (reference:
Examples/Stereo-Inertial/stereo_inertial_tum_vi.cc). Frames are
CLAHE-equalised (stereo_inertial_tum_vi.cc:136,169).

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.stereo_inertial_tum_vi
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.IMU_STEREO, default_out="trajectory_tum_vi.txt",
        stereo=True, inertial=True, equalize=True)


if __name__ == "__main__":
    sys.exit(main())
