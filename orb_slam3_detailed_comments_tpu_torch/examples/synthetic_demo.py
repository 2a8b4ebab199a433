"""Self-contained demo on a rendered synthetic world (no dataset needed):
runs mono, stereo or rgbd SLAM over a generated orbit, reports ATE
against exact ground truth, and writes the trajectory, the ground truth,
keypoint overlays every 10 frames, a top-down map and the HTML viewer.

Usage:
    python -m orb_slam3_detailed_comments_tpu_torch.examples.synthetic_demo
        [mono|stereo|rgbd] [n_frames] [outdir] [--device cpu]
"""
import os
import sys
import time

import numpy as np

from ..models import cameras
from ..pipeline.system import MONOCULAR, RGBD, STEREO, System
from ..utils import evaluate_ate, synth_render
from ..viz import drawers, webviewer
from . import runner


def main(argv=None) -> int:
    args, device = runner.split_device(sys.argv[1:] if argv is None
                                       else argv)
    mode = args[0] if len(args) > 0 else "mono"
    n = int(args[1]) if len(args) > 1 else 60
    outdir = args[2] if len(args) > 2 else "synthetic_demo_out"
    os.makedirs(outdir, exist_ok=True)

    cam = cameras.pinhole(fx=458.0, fy=457.0, cx=376.0, cy=240.0,
                          width=752, height=480)
    planes = synth_render.default_world(np.random.default_rng(7))
    R, t = synth_render.orbit_trajectory(n)
    ts = np.arange(n) * 0.05
    baseline = 0.11

    sensor = {"mono": MONOCULAR, "stereo": STEREO, "rgbd": RGBD}[mode]
    slam = System(cam, sensor, baseline=baseline, device=device)
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        if mode == "stereo":
            img, r = synth_render.render_stereo_pair(cam, planes, R[i], t[i],
                                                     baseline)
            slam.track_stereo(img, r, float(ts[i]))
        else:
            img, X, hit = synth_render.render_frame_raycast(cam, planes,
                                                            R[i], t[i])
            if mode == "mono":
                slam.track_monocular(img, float(ts[i]))
            else:
                d = synth_render.camera_depth(R[i], t[i], X, hit)
                slam.track_rgbd(img, d, float(ts[i]))
        times.append(time.perf_counter() - t0)
        fr = slam.tracker.last
        if i % 10 == 0 and fr is not None and fr.prepared is not None:
            feat = fr.prepared.feat
            matched = (np.asarray(fr.match_pt) >= 0
                       if fr.match_pt is not None else None)
            vis = drawers.draw_frame(
                img, feat.xy.cpu().numpy(), feat.valid.cpu().numpy(),
                matched, f"{mode} f{i} kf={slam.n_keyframes} "
                         f"pts={slam.n_map_points}")
            drawers.save_png(os.path.join(outdir, f"frame_{i:04d}.png"), vis)

    drawers.save_png(os.path.join(outdir, "map_topdown.png"),
                     drawers.draw_map_topdown(slam.map))
    webviewer.export_html(slam, os.path.join(outdir, "map_viewer.html"),
                          title=f"synthetic {mode}")
    slam.save_trajectory_tum(os.path.join(outdir, f"trajectory_{mode}.txt"))

    rows = slam.trajectory_tum()
    est_ts = np.array([r_[0] for r_ in rows])
    est_xyz = np.array([r_[1:4] for r_ in rows])
    gt = synth_render.camera_centers(R, t)
    # TUM-format ground truth (identity orientation: the ATE tools read
    # positions only)
    with open(os.path.join(outdir, f"groundtruth_{mode}.txt"), "w") as f:
        for k in range(n):
            f.write(f"{ts[k]:.6f} {gt[k, 0]:.6f} {gt[k, 1]:.6f} "
                    f"{gt[k, 2]:.6f} 0 0 0 1\n")
    rmse, nn, scale = evaluate_ate.ate_rmse(ts, gt, est_ts, est_xyz,
                                            with_scale=(mode == "mono"))
    print(f"[{mode}] frames={n} tracked={len(rows)} kf={slam.n_keyframes} "
          f"points={slam.n_map_points}")
    print(f"[{mode}] ATE RMSE {rmse * 100:.2f} cm over {nn} poses "
          f"(scale {scale:.3f}); median frame time "
          f"{np.median(times) * 1e3:.1f} ms")
    print(f"outputs in {outdir}")
    slam.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
