"""The port's localisation mode with its visual-odometry fallback.

Mirrors the gates of ``tests/test_pipeline_stereo_rgbd.py::
test_localization_mode_vo_fallback`` on the CPU at 376x240 with 512
features: a stereo System (baseline 0.11 m, loop closing off as in that
test) maps the first half of world seed 9's 40-frame orbit; then, with
``activate_localization_mode()``, the second half leaves the mapped area
with the map frozen. The gates: the keyframe count does not change, and >
70 % of the second half's frames still return a pose (frame to frame on
the last frame's depth-backed features, Tracking.cc:2279-2360). Also: a
tracker that starts in localisation mode on a map it did not build
relocalises into it, and ``deactivate_localization_mode()`` lets mapping
resume.
"""
import numpy as np
import torch

from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376,
                      height=240)
BASELINE = 0.11


def _stereo(**kw):
    return system.System(CAM, system.STEREO, baseline=BASELINE,
                         map_cfg=mapstore.MapConfig(max_kf=32, max_pt=4096,
                                                    n_feat=512),
                         orb_cfg=extractor.OrbConfig(n_features=512),
                         device="cpu", **kw)


def test_localization_mode_vo_fallback():
    planes = synth_render.default_world(np.random.default_rng(9))
    n = 40
    R, t = synth_render.orbit_trajectory(n)
    slam = _stereo(enable_loop_closing=False)
    ts = np.arange(n) * 0.05
    half = n // 2
    for i in range(half):
        slam.track_stereo(*synth_render.render_stereo_pair(
            CAM, planes, R[i], t[i], BASELINE), float(ts[i]))
    assert slam.tracker.state == tracking.OK
    kf_frozen = slam.n_keyframes
    slam.activate_localization_mode()
    n_out = sum(slam.track_stereo(*synth_render.render_stereo_pair(
        CAM, planes, R[i], t[i], BASELINE), float(ts[i])) is not None
                for i in range(half, n))
    assert slam.n_keyframes == kf_frozen
    assert n_out > 0.7 * (n - half), f"only {n_out}/{n - half} poses"
    slam.deactivate_localization_mode()
    assert not slam.tracker.localization_only


def test_localization_mode_relocalises_into_a_built_map():
    """A second tracker in localisation mode, on the first System's map:
    it does not initialise a map of its own but relocalises into this one
    (the keyframe database of the map's System) and tracks on, the map
    frozen."""
    planes = synth_render.default_world(np.random.default_rng(9))
    R, t = synth_render.orbit_trajectory(40)
    slam = _stereo()
    for i in range(12):
        slam.track_stereo(*synth_render.render_stereo_pair(
            CAM, planes, R[i], t[i], BASELINE), 0.05 * i)
    assert slam.kfdb is not None and slam.n_keyframes > 0
    n_kf = slam.n_keyframes
    slam.tracker.reset_for_new_map(slam.map)      # a fresh tracker state
    slam.activate_localization_mode()
    poses = [slam.track_stereo(*synth_render.render_stereo_pair(
        CAM, planes, R[i], t[i], BASELINE), 1.0 + 0.05 * i)
             for i in range(4, 10)]
    assert slam.tracker.n_relocalizations >= 1
    assert sum(p is not None for p in poses) >= 4
    assert slam.n_keyframes == n_kf and len(slam.atlas.maps) == 1
