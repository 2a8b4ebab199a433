"""Stereo EuRoC (reference: Examples/Stereo/stereo_euroc.cc). A settings
file with the legacy LEFT.* / RIGHT.* blocks is rectified here
(``utils/config.stereo_rectify_maps``), then tracked as a pinhole pair.

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.stereo_euroc
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.STEREO, default_out="trajectory_stereo.txt",
        stereo=True, pipelined=True, rectify=True, kf_trajectory=False)


if __name__ == "__main__":
    sys.exit(main())
