"""System facade: the public API, monocular, stereo (rectified or a
two-camera rig) and RGB-D, with loop closing off.

Counterpart of ``pipeline/system.py`` of the JAX package (reference: the
System class, src/System.cc:60): builds the Atlas, the tracker and the
local mapper on one device (the card unless ``device`` says otherwise),
feeds frames, runs local mapping synchronously on each new keyframe (the
reference's thread handoff at LocalMapping.cc:361 becomes a queue drained
inline), and writes trajectories. Configurations the port does not run
yet raise ``NotImplementedError`` naming the ROADMAP item that brings them:
the inertial sensors and IMU input, loop closing and place recognition,
the async mapping worker.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..lie import so3
from ..mapping.atlas import Atlas
from ..mapping.mapstore import MapConfig
from ..models import cameras
from ..utils import timing
from . import kernels
from .local_mapping import LocalMapper, LocalMappingConfig
from .tracking import (LOST, RECENTLY_LOST, SENSOR_MONO, SENSOR_RGBD,
                       SENSOR_STEREO, Tracker, TrackingConfig)

MONOCULAR = 0
STEREO = 1
RGBD = 2
IMU_MONOCULAR = 3
IMU_STEREO = 4
IMU_RGBD = 5

_TRACKER_SENSOR = {MONOCULAR: SENSOR_MONO, STEREO: SENSOR_STEREO,
                   RGBD: SENSOR_RGBD}
# ROADMAP.md's queue items that bring what is not ported yet
ITEM_PLACE_RECOGNITION = "1.4"   # place recognition, relocalisation, async
ITEM_LOOP_CLOSING = "1.5"        # loops, merges, global BA
ITEM_INERTIAL = "1.6"


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, "
        f"queue item {item})")


class System:
    def __init__(self, cam: cameras.CameraParams, sensor: int = MONOCULAR,
                 map_cfg: Optional[MapConfig] = None,
                 tracking_cfg: Optional[TrackingConfig] = None,
                 mapping_cfg: Optional[LocalMappingConfig] = None,
                 enable_loop_closing: bool = True,
                 vocab_path: Optional[str] = None,
                 baseline: float = 0.0, th_depth: float = 35.0,
                 imu_calib=None, camera2=None, T_c1c2=None,
                 async_mapping: bool = False, orb_cfg=None,
                 max_kf_lag: int = 1, device=None):
        if sensor not in (MONOCULAR, STEREO, RGBD, IMU_MONOCULAR, IMU_STEREO,
                          IMU_RGBD):
            raise ValueError(f"unknown sensor {sensor}")
        if sensor not in _TRACKER_SENSOR:
            _not_ported(f"the inertial sensor {sensor}", ITEM_INERTIAL)
        if enable_loop_closing:
            _not_ported("loop closing (enable_loop_closing=True)",
                        ITEM_LOOP_CLOSING)
        if vocab_path is not None:
            _not_ported("place recognition (vocab_path)",
                        ITEM_PLACE_RECOGNITION)
        if async_mapping:
            _not_ported("the async mapping worker (async_mapping=True)",
                        ITEM_PLACE_RECOGNITION)
        self.device = device_mod.resolve(device)
        self.cam = cam
        self.sensor = sensor
        self.atlas = Atlas(map_cfg or MapConfig(), self.device)
        self.map = self.atlas.active
        tsensor = _TRACKER_SENSOR[sensor]
        T_rl = None
        if T_c1c2 is not None:
            # settings give T_c1_c2 (right in left); the matcher wants
            # left -> right
            T_rl = np.linalg.inv(np.asarray(T_c1c2, np.float64)).astype(
                np.float32)
        if tracking_cfg is None:
            tracking_cfg = TrackingConfig()
            if tsensor != SENSOR_MONO:
                # thRefRatio: 0.9 mono / 0.75 stereo-RGBD (Tracking.cc:3737)
                tracking_cfg.ref_ratio = 0.75
        self.tracker = Tracker(cam, self.map, tracking_cfg, orb_cfg=orb_cfg,
                               sensor=tsensor, bf=baseline * cam.fx,
                               th_depth=th_depth, cam2=camera2, T_rl=T_rl,
                               device=self.device)
        if mapping_cfg is None:
            # cnThObs 2 mono / 3 stereo-RGBD (LocalMapping.cc:461), and 10
            # triangulation neighbours for stereo (LocalMapping.cc:510)
            mapping_cfg = LocalMappingConfig()
            if tsensor != SENSOR_MONO:
                mapping_cfg.cull_min_obs = 3
                mapping_cfg.n_covis_triangulate = 10
        self.local_mapper = LocalMapper(self.map, cam, mapping_cfg)
        self._is_shutdown = False
        self._last_big_change = 0
        self.image_scale = 1.0   # Camera.newWidth/width (System::GetImageScale)

    # ------------------------------------------------------------------
    def track_monocular(self, img, ts: float,
                        imu=None) -> Optional[np.ndarray]:
        """Feed one grayscale frame; returns 4x4 T_cw or None
        (reference: System::TrackMonocular, System.cc:441)."""
        if imu is not None:
            _not_ported("IMU input", ITEM_INERTIAL)
        pose = self.tracker.track_monocular(img, ts)
        return self._post_track(pose, ts)

    def track_stereo(self, img_l, img_r, ts: float,
                     imu=None) -> Optional[np.ndarray]:
        """Feed one stereo pair (rectified, or of the two-camera rig);
        returns 4x4 T_cw or None (reference: System::TrackStereo,
        System.cc:277)."""
        if imu is not None:
            _not_ported("IMU input", ITEM_INERTIAL)
        pose = self.tracker.track_stereo(img_l, img_r, ts)
        return self._post_track(pose, ts)

    def track_rgbd(self, img, depth, ts: float,
                   imu=None) -> Optional[np.ndarray]:
        """Feed one image and its registered depth map [H, W] (metres, 0 =
        none); returns 4x4 T_cw or None (reference: System::TrackRGBD,
        System.cc:361)."""
        if imu is not None:
            _not_ported("IMU input", ITEM_INERTIAL)
        pose = self.tracker.track_rgbd(img, depth, ts)
        return self._post_track(pose, ts)

    def track_stereo_iter(self, items):
        """Pipelined stereo ingestion, the stereo form of
        track_monocular_iter: items yields (img_l, img_r, ts); the next
        pair's extraction and matching is queued on the device before the
        current frame's tracking walks its host stages. Bit-identical to
        track_stereo."""
        tk = self.tracker
        prev = None
        for item in items:
            if len(item) > 3 and item[3] is not None:
                _not_ported("IMU input", ITEM_INERTIAL)
            cur = (*tk.prepare_stereo(item[0], item[1]), float(item[2]))
            if prev is not None:
                yield self._post_track(tk.track_prepared_stereo(*prev),
                                       prev[2])
            prev = cur
        if prev is not None:
            yield self._post_track(tk.track_prepared_stereo(*prev), prev[2])

    def track_monocular_iter(self, items):
        """Pipelined ingestion: the next frame's ORB extraction is queued on
        the device before the current frame's tracking walks its host
        stages. items yields (img, ts); yields the same poses as
        track_monocular, bit for bit (extraction is pure, so the order of
        dispatch changes no result)."""
        tk = self.tracker
        prev = None
        for item in items:
            img, ts = item[0], float(item[1])
            if len(item) > 2 and item[2] is not None:
                _not_ported("IMU input", ITEM_INERTIAL)
            cur = (kernels.prepare_frame(tk.image(img), self.cam, tk.orb_cfg,
                                         tk.cfg.frontend), ts)
            if prev is not None:
                yield self._post_track(tk._track_frame(*prev), prev[1])
            prev = cur
        if prev is not None:
            yield self._post_track(tk._track_frame(*prev), prev[1])

    def _post_track(self, pose, ts: float = 0.0):
        while self.tracker.new_keyframes:
            self._process_keyframe(self.tracker.new_keyframes.pop(0))
        if self.tracker.state == LOST:
            self._spawn_or_reset_map()
        return pose

    def _process_keyframe(self, k: int):
        """One LocalMapping iteration for keyframe k (loop closing off)."""
        if self.map.kf_valid[k] and self.map.n_kf > 2:
            self.local_mapper.process_keyframe(k)

    def _spawn_or_reset_map(self):
        """Unrecoverable loss: keep a rich map and start a new one, or reset
        a poor one in place (reference: Tracking.cc:2248-2262: a new map if
        the active one has > 10 keyframes, else ResetActiveMap)."""
        if self.map.n_kf > 10:
            self._bind(self.atlas.create_new_map())
        else:
            self._reset_active_store()

    def _reset_active_store(self):
        """A fresh store in the active map's slot; its rows leave the frame
        log, since the fresh store reuses (slot, epoch) keys
        (Tracking::ResetActiveMap)."""
        mid = self.atlas.active_id
        old = self.atlas.maps[mid]
        self.atlas.maps[mid] = self.atlas.new_store(mid)
        # keep the change counter monotone across the swap
        self.atlas.maps[mid].big_change_idx = old.big_change_idx
        self.tracker.trajectory = [
            r for r in self.tracker.trajectory if r[1] != mid]
        self._bind(self.atlas.maps[mid])

    def _bind(self, m):
        self.map = m
        self.tracker.reset_for_new_map(m)
        self.local_mapper.map = m
        self.local_mapper.recent_points.clear()

    # ------------------------------------------------------------------
    def shutdown(self):
        """(reference: System::Shutdown, System.cc:563; mapping runs
        inline, so nothing is left to wait for)"""
        self._is_shutdown = True

    def map_changed(self) -> bool:
        """True once after a big map correction (reference:
        System::MapChanged, System.cc:528)."""
        cur = max(m.big_change_idx for m in self.atlas.maps)
        if cur > self._last_big_change:
            self._last_big_change = cur
            return True
        return False

    def reset(self):
        """Clear the whole Atlas and start over (reference: System::Reset ->
        Tracking::Reset, System.cc:537, Tracking.cc:4549)."""
        self.atlas = Atlas(self.atlas.map_cfg, self.device)
        # the frame log goes too: stale rows would resolve against the
        # fresh map's reused (slot, epoch) keyframes
        self.tracker.trajectory.clear()
        self._last_big_change = 0
        self._bind(self.atlas.active)

    def reset_active_map(self):
        """Reset only the active map, keeping stored Atlas maps (reference:
        System::ResetActiveMap -> Tracking::ResetActiveMap, System.cc:545,
        Tracking.cc:4614)."""
        self._reset_active_store()

    def get_time_from_imu_init(self) -> float:
        """Seconds since the IMU initialised: always 0 without an IMU
        (reference: System::GetTimeFromIMUInit, System.cc:1418)."""
        return 0.0

    def is_shutdown(self) -> bool:
        """(reference: System::isShutDown, System.h:141)"""
        return self._is_shutdown

    def is_finished(self) -> bool:
        """(reference: System::isFinished)"""
        return self._is_shutdown

    def get_image_scale(self) -> float:
        """(reference: System::GetImageScale, System.cc:1565)"""
        return self.image_scale

    def print_time_stats(self, file=None):
        """Per-stage timing table (reference: Tracking::PrintTimeStats)."""
        return timing.print_time_stats(file)

    def save_track_stats(self, path: str):
        """Per-frame tracking-stats CSV (reference: Tracking.h:344-351)."""
        with open(path, "w") as f:
            f.write("#timestamp,state,n_features,n_matches\n")
            for ts, st, nf, nm in self.tracker.track_stats:
                f.write(f"{ts:.6f},{st},{nf},{nm}\n")

    # ------------------------------------------------------------------
    def _world_poses(self):
        """(ts, R_wc, t_wc) of every logged frame whose reference keyframe
        still resolves, replayed against the current keyframe poses."""
        for ts, map_id, ref_kf, epoch, R_cr, t_cr, _ in self.tracker.trajectory:
            resolved = self.atlas.resolve_kf_pose(map_id, ref_kf, epoch)
            if resolved is None:
                continue
            R_rw, t_rw = resolved
            R_cw = R_cr @ R_rw
            t_cw = R_cr @ t_rw + t_cr
            R_wc = R_cw.T
            yield ts, R_wc, -R_wc @ t_cw

    def trajectory_tum(self) -> list:
        """Frame trajectory as TUM rows (t tx ty tz qx qy qz qw), replaying
        relative poses against the (possibly BA-corrected) reference
        keyframes (reference: System::SaveTrajectoryEuRoC, System.cc:721)."""
        return [(ts, *t_wc.tolist(), *_quat(R_wc).tolist())
                for ts, R_wc, t_wc in self._world_poses()]

    def save_trajectory_tum(self, path: str):
        """(reference: System::SaveTrajectoryTUM, System.cc:646)"""
        _write_rows(path, self.trajectory_tum())

    def save_sub_trajectory(self, path: str, t_start: float, t_end: float):
        """Only the frames with t_start <= ts <= t_end (reference:
        Tracking::SaveSubTrajectory, Tracking.h:106)."""
        _write_rows(path, [r for r in self.trajectory_tum()
                           if t_start <= r[0] <= t_end])

    def save_trajectory_euroc(self, path: str):
        """Timestamps in ns, TUM fields (reference:
        System::SaveTrajectoryEuRoC, System.cc:721)."""
        with open(path, "w") as f:
            for row in self.trajectory_tum():
                f.write(f"{row[0] * 1e9:.0f} "
                        + " ".join(f"{v:.9f}" for v in row[1:]) + "\n")

    def save_trajectory_kitti(self, path: str):
        """3x4 row-major world poses per line (reference:
        System::SaveTrajectoryKITTI, System.cc:1273)."""
        with open(path, "w") as f:
            for _, R_wc, t_wc in self._world_poses():
                M = np.concatenate([R_wc, t_wc[:, None]], axis=1)
                f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")

    def _keyframe_rows(self):
        m = self.map
        kfs = m.kf_ids()
        for k in kfs[np.argsort(m.kf_ts[kfs])]:
            R_wc = m.kf_R[k].T
            t_wc = -R_wc @ m.kf_t[k]
            yield m.kf_ts[k], [*t_wc, *_quat(R_wc)]

    def save_keyframe_trajectory_tum(self, path: str):
        """(reference: System::SaveKeyFrameTrajectoryTUM, System.cc:680)"""
        with open(path, "w") as f:
            for ts, vals in self._keyframe_rows():
                f.write(f"{ts:.9f} " + " ".join(f"{v:.9f}" for v in vals)
                        + "\n")

    def save_keyframe_trajectory_euroc(self, path: str):
        """Keyframe poses with ns timestamps (reference:
        System::SaveKeyFrameTrajectoryEuRoC, System.cc:940)."""
        with open(path, "w") as f:
            for ts, vals in self._keyframe_rows():
                f.write(f"{ts * 1e9:.0f} " + " ".join(f"{v:.9f}" for v in vals)
                        + "\n")

    def print_point_distribution(self):
        """Per-pyramid-level feature / tracked-point counts of the last
        frame (reference: Frame::PrintPointDistribution, Frame.h:357)."""
        fr = self.tracker.last
        if fr is None:
            print("point distribution: no frame yet")
            return
        lv, ok = device_mod.fetch_packed([fr.prepared.feat.level,
                                          fr.prepared.feat.valid])
        tracked = fr.match_pt >= 0
        print("level |  features | tracked points")
        for l in range(int(lv.max()) + 1 if lv.size else 0):
            m = ok & (lv == l)
            print(f"{l:5d} | {int(m.sum()):9d} | "
                  f"{int((m & tracked).sum()):14d}")

    def check_map_consistency(self) -> list:
        """MapStore.check_invariants over every Atlas map (reference:
        Map::CheckEssentialGraph, Map.h:128)."""
        errs = []
        for i, m in enumerate(self.atlas.maps):
            errs += [f"map {i}: {e}" for e in m.check_invariants()]
        return errs

    # ------------------------------------------------------------ state
    def get_tracking_state(self) -> int:
        """(reference: System::GetTrackingState, System.h:176)"""
        return int(self.tracker.state)

    def is_lost(self) -> bool:
        """(reference: System::isLost, System.h:182)"""
        return self.tracker.state in (LOST, RECENTLY_LOST)

    def get_tracked_map_points(self) -> np.ndarray:
        """Per-feature map-point id of the last frame, -1 where untracked
        (reference: System::GetTrackedMapPoints, System.h:177)."""
        last = self.tracker.last
        if last is None:
            return np.empty(0, np.int64)
        return np.asarray(last.match_pt).copy()

    def get_tracked_keypoints(self) -> np.ndarray:
        """Undistorted keypoints [N, 2] of the last frame (reference:
        System::GetTrackedKeyPointsUn, System.h:178)."""
        last = self.tracker.last
        if last is None:
            return np.empty((0, 2), np.float32)
        return last.prepared.xy_ud.cpu().numpy()

    @property
    def n_keyframes(self):
        return self.map.n_kf

    @property
    def n_map_points(self):
        return self.map.n_points


def _quat(R_wc: np.ndarray) -> np.ndarray:
    return so3.to_quat(torch.from_numpy(
        np.ascontiguousarray(R_wc, np.float32))).numpy()


def _write_rows(path: str, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
