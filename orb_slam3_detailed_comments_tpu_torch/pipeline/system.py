"""System facade: the public API, monocular, stereo (rectified or a
two-camera rig) and RGB-D, with place recognition, relocalisation, loop
closing and map merging.

Counterpart of ``pipeline/system.py`` of the JAX package (reference: the
System class, src/System.cc:60): builds the Atlas, the tracker, the local
mapper and (from the first keyframe, with the vocabulary) the keyframe
database and the loop closer on one device (the card unless ``device``
says otherwise); feeds frames; runs local mapping, loop closing and merge
detection synchronously on each new keyframe (the reference's thread
handoffs become a queue drained inline); relocalises a lost tracker; and
writes trajectories. Configurations the port does not run yet raise
``NotImplementedError`` naming the ROADMAP item that brings them: the
inertial sensors and IMU input, the async mapping worker.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..lie import SE3, so3
from ..mapping.atlas import Atlas
from ..mapping.mapstore import MapConfig
from ..models import cameras
from ..ops import matching
from ..optim import pose_opt
from ..placerec import pnp
from ..placerec import vocab as vocab_mod
from ..placerec.keyframe_db import KeyFrameDatabase
from ..utils import timing
from . import kernels
from .local_mapping import LocalMapper, LocalMappingConfig, run_local_ba
from .loop_closing import (SEARCHES, LoopCloser, LoopClosingConfig,
                           host_sim3, run_merge_essential_graph,
                           verify_sim3_pair)
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
ITEM_ASYNC = "1.4"               # the async mapping worker
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
        if async_mapping:
            _not_ported("the async mapping worker (async_mapping=True)",
                        ITEM_ASYNC)
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
        self.enable_loop_closing = enable_loop_closing
        self.loop_closer = None
        self.kfdb = None
        self.vocab = None
        self.kfdbs: dict = {}          # map_id -> KeyFrameDatabase
        self._vocab_path = vocab_path
        self._kfdb_pending: list = []
        self._change_dataset_pending = False
        self._is_shutdown = False
        self._last_big_change = 0
        self.image_scale = 1.0   # Camera.newWidth/width (System::GetImageScale)
        if vocab_path is not None:
            self._build_recognition(vocab_path=vocab_path)
        self.tracker.relocalizer = self._relocalize

    # ------------------------------------------------------------------
    def _has_bundled_vocab(self) -> bool:
        return (self.vocab is not None or self._vocab_path is not None
                or vocab_mod.DEFAULT_PATH.exists())

    def _build_recognition(self, vocab_path=None):
        """The vocabulary (shared by every map) and the active map's keyframe
        database and loop closer. The vocabulary is the given file, else
        the bundled one, else trained from this map's descriptors (the
        reference ships ORBvoc.txt)."""
        if self.vocab is None:
            if vocab_path is not None:
                self.vocab = vocab_mod.load(vocab_path, self.device)
            elif vocab_mod.DEFAULT_PATH.exists():
                self.vocab = vocab_mod.load(vocab_mod.DEFAULT_PATH,
                                            self.device)
            else:
                kfs = self.map.kf_ids()
                descs = self.map.kf_feat_desc[kfs][self.map.kf_feat_valid[kfs]]
                self.vocab = vocab_mod.train(descs, k=10, levels=3,
                                             device=self.device)
        self.kfdb = KeyFrameDatabase(self.vocab, self.map.cfg.max_kf)
        self.kfdbs[self.map.map_id] = self.kfdb
        # metric-depth sensors solve loops and merges at s = 1 (reference:
        # mbFixScale for STEREO / RGBD)
        self.loop_closer = LoopCloser(
            self.map, self.cam, self.kfdb,
            LoopClosingConfig(fix_scale=self.sensor in (STEREO, RGBD)))

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
        if ((self.tracker.state == LOST
             and not self.tracker.localization_only)
                or self._change_dataset_pending):
            self._spawn_or_reset_map()
            self._change_dataset_pending = False
        return pose

    def _process_keyframe(self, k: int):
        """One LocalMapping + LoopClosing iteration for keyframe k (the
        bodies of the reference's mapping and loop threads)."""
        if self.map.kf_valid[k] and self.map.n_kf > 2:
            self.local_mapper.process_keyframe(k)
        if not self.enable_loop_closing:
            return
        # with a vocabulary file detection runs from the first keyframe
        # (LoopClosing.cc:383); a vocabulary trained from this run's
        # descriptors waits for 3 keyframes
        min_kf = 1 if self._has_bundled_vocab() else 3
        if self.loop_closer is None and self.map.n_kf >= min_kf:
            self._build_recognition()
            for kk in self._kfdb_pending:
                if self.map.kf_valid[kk]:
                    self.kfdb.add(kk, self.map.kf_feat_desc[kk],
                                  self.map.kf_feat_valid[kk])
            self._kfdb_pending.clear()
        if self.loop_closer is None:
            self._kfdb_pending.append(k)
        elif self.map.kf_valid[k]:
            self.loop_closer.process_keyframe(k)
            self._detect_merge(k)

    def change_dataset(self):
        """Start a fresh map with the next frame (reference: the
        multi-sequence mode of the examples, mono_euroc.cc:173-183)."""
        self._change_dataset_pending = True

    def _spawn_or_reset_map(self):
        """Unrecoverable loss: keep a rich map and start a new one, or reset
        a poor one in place (reference: Tracking.cc:2248-2262: a new map if
        the active one has > 10 keyframes, else ResetActiveMap). The new
        map gets a keyframe database of its own; the stored map keeps
        its one for merge detection."""
        if self.map.n_kf > 10 or self._change_dataset_pending:
            self._bind(self.atlas.create_new_map())
        else:
            self._reset_active_store()

    def _detect_merge(self, k: int):
        """Query the stored maps' databases with keyframe k; on a verified
        Sim3 weld that map into the active one, fuse the seam, refine the
        weld window by BA and spread the refinement by the merge essential
        graph (reference: NewDetectCommonRegions' merge branch and
        MergeLocal, LoopClosing.cc:1590, 2234)."""
        if len(self.atlas.maps) < 2:
            return
        act = self.map
        for mid, other in enumerate(self.atlas.maps):
            if mid == self.atlas.active_id or other.n_kf < 3:
                continue
            db = self.kfdbs.get(mid)
            if db is None:
                continue
            cands = db.detect_relocalization_candidates(
                other, act.kf_feat_desc[k], act.kf_feat_valid[k])
            for c in cands[:3]:
                out = verify_sim3_pair(act, k, other, int(c), self.cam,
                                       self.loop_closer.cfg)
                if out is None:
                    continue
                c, S_kc = out
                # other world -> active world: T_k^-1 ∘ S_kc ∘ T_c
                S_ao = (host_sim3(act.kf_R[k], act.kf_t[k]).inverse()
                        .compose(S_kc)
                        .compose(host_sim3(other.kf_R[int(c)],
                                           other.kf_t[int(c)])))
                act_kfs_before = [int(x) for x in act.kf_ids()]
                slot_map = self.atlas.merge_map_into_active(mid, S_ao)
                for new in slot_map.values():
                    self.kfdb.add(new, act.kf_feat_desc[new],
                                  act.kf_feat_valid[new])
                self.kfdbs.pop(mid, None)
                self.loop_closer._fuse_loop_points(k, slot_map[int(c)])
                snap_R, snap_t = act.kf_R.copy(), act.kf_t.copy()
                window = [k] + list(slot_map.values())[:12]
                run_local_ba(act, window, fixed=[k], cam=self.cam, iters=6)
                run_merge_essential_graph(
                    act, snap_R, snap_t,
                    set(act_kfs_before) | set(int(w) for w in window),
                    fix_scale=self.loop_closer.cfg.fix_scale)
                act.update_point_stats(np.where(act.pt_valid)[0])
                return

    # ------------------------------------------------------------------
    def _relocalize(self, prep):
        """The tracker's relocalisation callback: keyframe-database
        candidates -> mutual descriptor matching against each candidate's
        points (``hamming_best2``) -> PnP RANSAC -> pose optimisation, with
        rescue rounds when the inliers are short: a wide (r = 10) then a
        narrow (r = 3) guided projection search over the candidate's local
        map (``hamming_best2_windowed``) re-feeds the optimiser; accepted
        at >= 50 inliers (reference: Tracking::Relocalization,
        Tracking.cc:4324-4540). Returns (R, t, match_pt, kf) or None. The
        PnP minimal sets are drawn on the host, seeded by the candidate."""
        if self.kfdb is None:
            return None
        m = self.map
        tk = self.tracker
        dev = self.device
        reloc_accept = 50   # nGood (Tracking.cc:4536)
        desc, fvalid, xyn = device_mod.fetch_packed(
            [prep.feat.desc, prep.feat.valid, prep.xyn])
        N = desc.shape[0]
        cands = self.kfdb.detect_relocalization_candidates(m, desc, fvalid)
        inv_s2 = tk._inv_sigma2_dev[prep.feat.level.long()]

        def optimize(match_pt, R, t):
            has = match_pt >= 0
            X, has_d, R_d, t_d = device_mod.upload_packed(
                [m.pt_xyz[np.where(has, match_pt, 0)], has,
                 np.asarray(R, np.float32), np.asarray(t, np.float32)], dev)
            res = pose_opt.pose_optimization(
                SE3(R_d, t_d), X, prep.xy_ud, inv_s2,
                has_d & prep.feat.valid, self.cam)
            n, inl, Ro, to = device_mod.fetch_packed(
                [res.n_inliers, res.inlier, res.T_cw.R, res.T_cw.t])
            return (int(n), np.where(inl, match_pt, -1).astype(np.int32),
                    Ro, to)

        def guided_search(local_pts, R, t, radius, match_pt):
            cap = tk.cfg.local_pts_cap
            local_pts = local_pts[:cap]
            ids = np.concatenate([local_pts,
                                  np.full(cap - len(local_pts), -1, np.int64)])
            safe = np.where(ids >= 0, ids, 0)
            (R_d, t_d, xyz, nrm, dmin, dmax, ok, pdesc, r_lv
             ) = device_mod.upload_packed(
                [np.asarray(R, np.float32), np.asarray(t, np.float32),
                 m.pt_xyz[safe], m.pt_normal[safe], m.pt_min_dist[safe],
                 m.pt_max_dist[safe], (ids >= 0) & m.pt_valid[safe],
                 m.pt_desc[safe],
                 (radius * tk.radius_scale).astype(np.float32)], dev)
            proj = kernels.project_points(SE3(R_d, t_d), xyz, nrm, dmin,
                                          dmax, ok, self.cam, m.cfg.scale,
                                          m.cfg.n_levels)
            res = matching.search_by_projection(
                proj.uv, proj.visible, pdesc, proj.level,
                prep.feat._replace(xy=prep.xy_ud), r_lv[proj.level.long()],
                max_dist=matching.TH_HIGH, ratio=0.9)
            SEARCHES["reloc_search"] += 1
            valid, fidx = device_mod.fetch_packed([res.valid, res.idx])
            out = match_pt.copy()
            sel = np.where(valid)[0]
            # the first query to land on a feature takes it
            f, first = np.unique(fidx[sel], return_index=True)
            free = out[f] < 0
            out[f[free]] = ids[sel[first[free]]]
            return out

        for c in cands:
            kd, kv = device_mod.upload_packed(
                [m.kf_feat_desc[c],
                 m.kf_feat_valid[c] & (m.kf_feat_point[c] >= 0)], dev)
            res = matching.match_nn(prep.feat.desc, prep.feat.valid, kd, kv,
                                    max_dist=75, ratio=0.9, mutual=True)
            SEARCHES["reloc_match"] += 1
            valid, ridx = device_mod.fetch_packed([res.valid, res.idx])
            if valid.sum() < 15:
                continue
            fidx = np.where(valid)[0]
            pids = m.kf_feat_point[c][ridx[fidx]]
            ok = (pids >= 0) & m.pt_valid[pids]
            fidx, pids = fidx[ok], pids[ok]
            if len(fidx) < 15:
                continue
            X = np.zeros((N, 3), np.float32)
            xn = np.zeros((N, 2), np.float32)
            mask = np.zeros(N, bool)
            X[fidx] = m.pt_xyz[pids]
            xn[fidx] = xyn[fidx]
            mask[fidx] = True
            sets = pnp.sample_sets(torch.from_numpy(mask), 256, 6,
                               torch.Generator().manual_seed(int(c)))
            X_d, xn_d, mask_d, sets_d = device_mod.upload_packed(
                [X, xn, mask, sets.numpy().astype(np.int32)], dev)
            sol = pnp.solve_pnp_ransac(X_d, xn_d, mask_d,
                                       focal=float(self.cam.fx),
                                       sample_idx=sets_d)
            s_ok, inl, R, t = device_mod.fetch_packed(
                [sol.ok, sol.inliers, sol.R, sol.t])
            if not bool(s_ok):
                continue
            match_pt = np.full(N, -1, np.int32)
            match_pt[fidx] = np.where(inl[fidx], pids, -1)
            n_good, match_pt, R, t = optimize(match_pt, R, t)
            if n_good < 10:
                continue
            if n_good < reloc_accept:
                covis_c, _ = m.covisibility(int(c), min_weight=10)
                local_pts = m.local_point_ids(
                    np.asarray([int(c)] + [int(x) for x in covis_c[:10]]))
                for radius in (10.0, 3.0):
                    if n_good >= reloc_accept:
                        break
                    match_pt = guided_search(local_pts, R, t, radius,
                                             match_pt)
                    if (match_pt >= 0).sum() < reloc_accept:
                        continue
                    n_good, match_pt, R, t = optimize(match_pt, R, t)
            if n_good < reloc_accept:
                continue
            return R, t, match_pt, c
        return None

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
        # a fresh keyframe database for the new map (shared vocabulary)
        self.loop_closer = None
        self.kfdb = None
        self._kfdb_pending.clear()

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Camera tracking only; the map is frozen (reference:
        System::ActivateLocalizationMode, System.cc:510)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        """(reference: System::DeactivateLocalizationMode, System.cc:518)"""
        self.tracker.localization_only = False

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
        self.kfdbs = {}
        self._bind(self.atlas.active)

    def reset_active_map(self):
        """Reset only the active map, keeping stored Atlas maps (reference:
        System::ResetActiveMap -> Tracking::ResetActiveMap, System.cc:545,
        Tracking.cc:4614)."""
        self.kfdbs.pop(self.atlas.active_id, None)
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
