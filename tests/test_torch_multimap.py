"""The port's multi-map System: a second sequence starts a fresh map
(``change_dataset``) and is welded back into the first through cross-map
place recognition.

Mirrors the gates of ``tests/test_atlas_multimap.py::
test_multimap_spawn_and_merge`` on the CPU at 376x240 with 512 features:
world seed 5, the first 45 frames of a 60-frame orbit, then
``change_dataset()`` and frames 30-44 again at ts + 10 s. (At this size
the JAX test's 50-frame orbit moves too far between frames: its second
sequence stays uninitialised for most of its 30 frames.) The gates: > 70 %
of the first sequence and > 50 % of the second tracked, 2 maps with the
second active, >= 1 merge, trajectory rows for > 70 % of all frames, and
a scale-aligned joint ATE < 0.18 m over > 60 % of them; the merged map
consistent.
"""
import numpy as np
import torch

from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

torch.set_num_threads(2)


SMALL = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)


def _small_system(cam, **kw):
    return system.System(
        cam, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=512),
        tracking_cfg=tracking.TrackingConfig(n_features=512,
                                             min_init_matches=50, **kw),
        device="cpu")


def test_multimap_spawn_and_merge():
    cam = cameras.pinhole(**SMALL)
    planes = synth_render.default_world(np.random.default_rng(5))
    R, t = synth_render.orbit_trajectory(60)
    n, n2 = 45, 15
    frames = [synth_render.render_image(cam, planes, R[i], t[i], "cpu")
              for i in range(n)]
    slam = _small_system(cam)
    ts = np.arange(n) * 0.05
    ok1 = sum(slam.track_monocular(frames[i], float(ts[i])) is not None
              for i in range(n))
    assert ok1 > 0.7 * n
    assert len(slam.atlas.maps) == 1
    slam.change_dataset()
    ts2 = ts[-n2:] + 10.0
    ok2 = sum(slam.track_monocular(frames[i], float(ts2[j])) is not None
              for j, i in enumerate(range(n - n2, n)))
    assert ok2 > 0.5 * n2
    assert len(slam.atlas.maps) == 2 and slam.atlas.active_id == 1
    assert slam.atlas.n_merges >= 1, "maps never merged"
    rows = slam.trajectory_tum()
    assert len(rows) > 0.7 * (n + n2)
    gt = synth_render.camera_centers(R, t)[:n]
    rmse, npairs, _ = evaluate_ate.ate_rmse(
        np.concatenate([ts, ts2]), np.concatenate([gt, gt[-n2:]]),
        np.array([r[0] for r in rows]), np.array([r[1:4] for r in rows]))
    assert npairs > 0.6 * (n + n2)
    assert rmse < 0.18, (rmse, npairs)
    assert slam.check_map_consistency() == []
