"""Monocular EuRoC (reference: Examples/Monocular/mono_euroc.cc).

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.mono_euroc
        <settings.yaml> <sequence_dir>... [<out.txt>] [--device cpu]

Several sequence directories exercise the multi-map Atlas like the
reference's multi-sequence mode (mono_euroc.cc:173-183). Writes the TUM
trajectory and its keyframe sibling (<out>_kf.txt).
"""
import sys

from ..pipeline import system as S
from . import runner


def main(argv=None) -> int:
    return runner.run_euroc(
        sys.argv[1:] if argv is None else argv, __doc__,
        sensor=S.MONOCULAR, default_out="trajectory_tum.txt",
        pipelined=True, save_atlas=True)


if __name__ == "__main__":
    sys.exit(main())
