"""Host-side stage profile of the monocular pipeline on a synthetic world
(no dataset needed).

Counterpart of ``scripts/profile_stages.py`` of the JAX package: world
seed 7, ``orbit_trajectory(n)``, ``System(cam, MONOCULAR)`` after
``warmup()``, frames ray-cast on the device. Prints the frames' wall time
and fps, then the per-stage table (``utils/timing`` spans, the
reference's REGISTER_TIMES taxonomy, Tracking.cc:2059-2068). The table
holds the n profiled frames only: the spans are reset after the warmup.

    python -m orb_slam3_detailed_comments_tpu_torch.tools.profile_stages \\
        [n_frames=80] [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import device as device_mod
from ..examples import runner
from ..models import cameras
from ..pipeline.system import MONOCULAR, System
from ..utils import synth_render, timing
from .eval_vocab import CAM_KW


def profile(n, device):
    """Track n frames after ``warmup()``; print the fps line and the
    stage table of those frames."""
    cam = cameras.pinhole(**CAM_KW)
    planes = synth_render.default_world(np.random.default_rng(7))
    R, t = synth_render.orbit_trajectory(n)
    slam = System(cam, MONOCULAR, device=device)
    slam.warmup()
    sync = ((lambda: torch.cuda.synchronize(slam.device))
            if slam.device.type == "cuda" else (lambda: None))
    sync()
    timing.reset()
    t0 = time.perf_counter()
    for i in range(n):
        img = synth_render.render_image(cam, planes, R[i], t[i], slam.device)
        slam.track_monocular(img, i * 0.05)
    sync()
    dt = time.perf_counter() - t0
    print(f"total {dt:.1f}s, {n / dt:.1f} fps, kf={slam.n_keyframes} "
          f"pts={slam.n_map_points}")
    slam.print_time_stats()


def main(argv=None) -> int:
    args, device = runner.split_device(sys.argv[1:] if argv is None
                                       else argv)
    profile(int(args[0]) if args else 80, device_mod.resolve(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
