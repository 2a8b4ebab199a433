"""Full-size bootstrap on the CPU: the JAX Tracker alone and the port's, on
the same rendered frames (752x480, OrbConfig() and MapConfig() defaults).

    python tests/run_bootstrap_fullsize.py jax   [n_frames] [world_seed]
    python tests/run_bootstrap_fullsize.py torch [n_frames] [world_seed]

Not a test (a run takes minutes): it is the script behind the frame counts
of chip_smoke.py's bootstrap phase. Prints one line per tracked frame
(frame, state, matches, keyframes, points), then the scale-aligned ATE and
the map's invariants. The world and orbit are chip_smoke.py's phase 5
(default world seed 3, the 60-frame orbit); the port runs the fused front
end. Everything runs on the CPU: these are counts, not device timings.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from orb_slam3_detailed_comments_tpu_torch.models import cameras as tcameras
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

CAM_KW = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752, height=480)


def make_tracker(which):
    if which == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from orb_slam3_detailed_comments_tpu.mapping import mapstore
        from orb_slam3_detailed_comments_tpu.models import cameras
        from orb_slam3_detailed_comments_tpu.pipeline import tracking
        m = mapstore.MapStore(mapstore.MapConfig())
        return tracking.Tracker(cameras.pinhole(**CAM_KW), m,
                                tracking.TrackingConfig())
    from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
    from orb_slam3_detailed_comments_tpu_torch.pipeline import tracking
    m = mapstore.MapStore(mapstore.MapConfig(), "cpu")
    return tracking.Tracker(tcameras.pinhole(**CAM_KW), m,
                            tracking.TrackingConfig(frontend="fused"),
                            device="cpu")


def main(which="torch", n_frames=56, world_seed=3):
    cam = tcameras.pinhole(**CAM_KW)
    planes = synth_render.default_world(np.random.default_rng(world_seed))
    R, t = synth_render.orbit_trajectory(60)
    C = synth_render.camera_centers(R, t)
    ts = 0.05 * np.arange(60)
    tk = make_tracker(which)
    est = []
    for i in range(n_frames):
        img = synth_render.render_frame_raycast(cam, planes, R[i], t[i])[0]
        T = tk.track_monocular(img, float(ts[i]))
        if T is None:
            print(f"{which} frame {i}: state {tk.state}, not tracked",
                  flush=True)
            continue
        est.append((ts[i], -T[:3, :3].T @ T[:3, 3]))
        print(f"{which} frame {i}: state {tk.state}, "
              f"{int((tk.cur_match >= 0).sum())} matches, {tk.map.n_kf} "
              f"keyframes, {tk.map.n_points} points", flush=True)
    if len(est) >= 3:
        rmse, n, scale = evaluate_ate.ate_rmse(
            ts, C, np.array([e[0] for e in est]),
            np.array([e[1] for e in est]))
        print(f"{which}: {len(est)} frames tracked, scale-aligned ATE "
              f"{rmse:.5f} m over {n} poses (scale {scale:.4f})")
    print(f"{which}: invariants {tk.map.check_invariants()}")


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0] if a else "torch", int(a[1]) if len(a) > 1 else 56,
         int(a[2]) if len(a) > 2 else 3)
