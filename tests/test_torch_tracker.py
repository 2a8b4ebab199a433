"""The port's Tracker over a seeded map, on the CPU at a small size.

376x240 pinhole (half EuRoC), 512 features, 2048 points, 32 keyframes
seeded every 2nd frame of a 64-frame orbit; 24 frames tracked from the
first one after seeding. Gates: >= 95% of frames tracked, camera-centre
error median < 2 cm and max < 5 cm (the full-size gates of chip_smoke.py
are 1 cm / 5 cm; a pixel here spans twice the distance).
"""
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu_torch.lie import SE3
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import tracking
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM = cameras.pinhole(229.0, 228.5, 188.0, 120.0, 376, 240)


@pytest.fixture(scope="module")
def seeded():
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(64)
    cfg = mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=512)
    m = synth_render.seed_map(CAM, planes, R, t, 2, cfg, "cpu",
                              extractor.OrbConfig(n_features=512))
    return planes, R, t, m


def test_seeded_map_size(seeded):
    _, _, _, m = seeded
    assert m.n_kf == 32 and m.n_points == 2048
    assert (m.kf_prev[m.kf_ids()[1:]] == m.kf_ids()[:-1]).all()
    assert (m.covisibility_matrix() >= 15).sum() > 32


def test_tracker_follows_ground_truth(seeded):
    planes, R, t, m = seeded
    tk = tracking.Tracker(CAM, m, tracking.TrackingConfig(
        n_features=512, local_pts_cap=1024), device="cpu")
    tk.start_from_map(SE3(R[0], t[0]), 0.0, last_kf_id=0)
    C = synth_render.camera_centers(R, t)
    errs, n_frames = [], 24
    for i in range(1, 1 + n_frames):
        img, _, _ = synth_render.render_frame_raycast(CAM, planes, R[i], t[i])
        T = tk.track_monocular(img, 0.05 * i)
        if T is not None:
            errs.append(np.linalg.norm(-T[:3, :3].T @ T[:3, 3] - C[i]))
            assert tk.n_candidates2 > 0
    assert len(errs) >= 0.95 * n_frames
    assert np.median(errs) < 0.02 and np.max(errs) < 0.05
    assert tk.n_steps == n_frames and tk.state == tracking.OK
    assert m.pt_found.sum() > m.n_points          # found counters advanced


def test_tracker_without_map_prior_returns_none(seeded):
    planes, R, t, m = seeded
    tk = tracking.Tracker(CAM, m, tracking.TrackingConfig(n_features=512),
                          device="cpu")
    img, _, _ = synth_render.render_frame_raycast(CAM, planes, R[1], t[1])
    assert tk.track_monocular(img, 0.0) is None and tk.n_steps == 0
