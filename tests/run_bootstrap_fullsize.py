"""Full-size runs on the CPU: the JAX package against the port, on the same
rendered frames (752x480, OrbConfig() and MapConfig() defaults).

    python tests/run_bootstrap_fullsize.py jax   [n_frames] [world_seed]
    python tests/run_bootstrap_fullsize.py torch [n_frames] [world_seed]
    python tests/run_bootstrap_fullsize.py system-jax   [n_frames] [world_seed]
    python tests/run_bootstrap_fullsize.py system-torch [n_frames] [world_seed]

A fourth argument ``small`` runs the size of the port's CPU tests instead
(376x240, 512 features, 32 keyframes / 2048 points, min_init_matches 50).

Not a test (a run takes minutes). ``jax`` / ``torch`` run a bare Tracker,
which inserts keyframes but has no local mapper: the script behind the
frame counts of chip_smoke.py's bootstrap phase (default world seed 3).
``system-jax`` / ``system-torch`` run System(cam, MONOCULAR,
enable_loop_closing=False): the script behind the expected counts of
chip_smoke.py's System phase (default world seed 7). Prints one line per
frame (frame, state, matches, keyframes, points, and for the System the
keyframe event's counts), then the frames tracked, the scale-aligned ATE
of trajectory_tum() (of the per-frame poses for a bare Tracker) and the
map's invariants. Both orbits are the 60 frames of
tests/test_pipeline_mono.py, ts = 0.05 i; the port runs the fused front
end. Everything runs on the CPU: these are counts, not device timings.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from orb_slam3_detailed_comments_tpu_torch.models import cameras as tcameras
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

CAM_KW = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752, height=480)
SMALL_CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376,
                    height=240)
SMALL = dict(map_kw=dict(max_kf=32, max_pt=2048, n_feat=512),
             track_kw=dict(n_features=512, min_init_matches=50))


def make(which, cam_kw, map_kw, track_kw):
    """A bare Tracker or a System of either package."""
    pkg, sys_ = which.split("-")[-1], which.startswith("system")
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from orb_slam3_detailed_comments_tpu.mapping import mapstore
        from orb_slam3_detailed_comments_tpu.models import cameras
        from orb_slam3_detailed_comments_tpu.pipeline import system, tracking
        cam = cameras.pinhole(**cam_kw)
        if sys_:
            return system.System(
                cam, system.MONOCULAR, map_cfg=mapstore.MapConfig(**map_kw),
                tracking_cfg=tracking.TrackingConfig(**track_kw),
                enable_loop_closing=False)
        return tracking.Tracker(
            cam, mapstore.MapStore(mapstore.MapConfig(**map_kw)),
            tracking.TrackingConfig(**track_kw))
    from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        system, tracking)
    cam = tcameras.pinhole(**cam_kw)
    if sys_:
        return system.System(
            cam, system.MONOCULAR, map_cfg=mapstore.MapConfig(**map_kw),
            tracking_cfg=tracking.TrackingConfig(**track_kw),
            enable_loop_closing=False, device="cpu")
    return tracking.Tracker(
        cam, mapstore.MapStore(mapstore.MapConfig(**map_kw), "cpu"),
        tracking.TrackingConfig(frontend="fused", **track_kw), device="cpu")


def main(which="torch", n_frames=None, world_seed=None, small=False):
    is_sys = which.startswith("system")
    n_frames = n_frames or (60 if is_sys else 56)
    world_seed = (7 if is_sys else 3) if world_seed is None else world_seed
    cam_kw = SMALL_CAM_KW if small else CAM_KW
    cam = tcameras.pinhole(**cam_kw)
    planes = synth_render.default_world(np.random.default_rng(world_seed))
    R, t = synth_render.orbit_trajectory(60)
    C = synth_render.camera_centers(R, t)
    ts = 0.05 * np.arange(60)
    obj = make(which, cam_kw, **(SMALL if small else dict(map_kw={},
                                                             track_kw={})))
    tk = obj.tracker if is_sys else obj
    est = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        img = synth_render.render_frame_raycast(cam, planes, R[i], t[i])[0]
        kf0 = len(tk.map.tombstones) + tk.map.n_kf
        T = (obj.track_monocular(img, float(ts[i])) if is_sys
             else tk.track_monocular(img, float(ts[i])))
        if T is None:
            print(f"{which} frame {i}: state {tk.state}, not tracked",
                  flush=True)
            continue
        est.append((ts[i], -T[:3, :3].T @ T[:3, 3]))
        ev = ""
        if is_sys and len(tk.map.tombstones) + tk.map.n_kf != kf0:
            ev = f", keyframe event {getattr(obj.local_mapper, 'last_event', '')}"
        print(f"{which} frame {i}: state {tk.state}, "
              f"{int((tk.cur_match >= 0).sum())} matches, {tk.map.n_kf} "
              f"keyframes, {tk.map.n_points} points{ev} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if is_sys:
        rows = obj.trajectory_tum()
        est = [(r[0], np.array(r[1:4])) for r in rows]
        print(f"{which}: {len(rows)} trajectory_tum rows")
    if len(est) >= 3:
        rmse, n, scale = evaluate_ate.ate_rmse(
            ts, C, np.array([e[0] for e in est]),
            np.array([e[1] for e in est]))
        print(f"{which}: scale-aligned ATE {rmse:.5f} m over {n} poses "
              f"(scale {scale:.4f})")
    print(f"{which}: {tk.map.n_kf} keyframes, {tk.map.n_points} points, "
          f"invariants {tk.map.check_invariants()}, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0] if a else "torch", int(a[1]) if len(a) > 1 else None,
         int(a[2]) if len(a) > 2 else None, len(a) > 3 and a[3] == "small")
