"""System facade: the public API, monocular, stereo (rectified or a
two-camera rig) and RGB-D, each with or without an IMU, with place
recognition, relocalisation, loop closing and map merging.

Counterpart of ``pipeline/system.py`` of the JAX package (reference: the
System class, src/System.cc:60): builds the Atlas, the tracker, the local
mapper and (from the first keyframe, with the vocabulary) the keyframe
database and the loop closer on one device (the card unless ``device``
says otherwise); feeds frames; runs local mapping, loop closing and merge
detection on each new keyframe; relocalises a lost tracker; and writes
trajectories. With an IMU (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD)
the frames take ``imu=`` windows, the local BA becomes the local inertial
BA once the IMU is initialised, and ``_imu_schedule`` runs the staged
initialisation after each keyframe event (the gravity / scale / bias solve
with a full inertial BA, VIBA1 after 5 s, VIBA2 after 15 s, and the
monocular scale refinement).

Keyframe work runs inline after the frame that made the keyframe, or with
``async_mapping`` on a mapping worker thread (the reference's LocalMapping
and LoopClosing threads): tracking runs its extraction unlocked and takes
the map lock (``map_lock``, the reference's per-map update mutex) for the
rest; the worker processes one keyframe at a time under it; a frame that
made a keyframe waits while more than ``max_kf_lag`` keyframes are
unprocessed; the global BA after a loop races both on a thread of its
own. On the card every thread launches on the device's default stream.

``from_settings`` builds a System from an ORB-SLAM3 settings file
(``utils/config.load_settings``); ``save_atlas`` / ``load_atlas`` write
and read every map in the JAX package's checkpoint format
(``utils/serialization``); ``warmup`` builds the CUDA kernels and creates
the libraries' handles on a throwaway System before the first frame.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..imu.preintegration import ImuCalib
from ..lie import SE3, so3
from ..mapping.atlas import Atlas
from ..mapping.mapstore import MapConfig
from ..models import cameras
from ..ops import matching
from ..ops.extractor import OrbConfig
from ..optim import pose_opt
from ..placerec import pnp
from ..placerec import vocab as vocab_mod
from ..placerec.keyframe_db import KeyFrameDatabase
from ..utils import serialization, synth_render, timing
from . import inertial, kernels
from .local_mapping import (LocalMapper, LocalMappingConfig, full_obs_cap,
                            run_local_ba)
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
                   RGBD: SENSOR_RGBD, IMU_MONOCULAR: SENSOR_MONO,
                   IMU_STEREO: SENSOR_STEREO, IMU_RGBD: SENSOR_RGBD}


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
                 max_kf_lag: int = 1, device=None, group=None):
        if sensor not in (MONOCULAR, STEREO, RGBD, IMU_MONOCULAR, IMU_STEREO,
                          IMU_RGBD):
            raise ValueError(f"unknown sensor {sensor}")
        self.device = device_mod.resolve(device)
        # the process group of the sharded global BA and of batched
        # extraction (rank 0 runs the System, the other ranks
        # parallel.dist_ba.serve); None: this process alone
        self.group = group
        self.cam = cam
        self.sensor = sensor
        self.inertial = sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD)
        if self.inertial and imu_calib is None:
            imu_calib = ImuCalib.default()
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
                               device=self.device,
                               imu_calib=imu_calib if self.inertial else None)
        if mapping_cfg is None:
            # cnThObs 2 mono / 3 stereo-RGBD (LocalMapping.cc:461), and 10
            # triangulation neighbours for stereo (LocalMapping.cc:510)
            mapping_cfg = LocalMappingConfig()
            if tsensor != SENSOR_MONO:
                mapping_cfg.cull_min_obs = 3
                mapping_cfg.n_covis_triangulate = 10
        self.local_mapper = LocalMapper(self.map, cam, mapping_cfg)
        # the IMU schedule's stage: 0 not initialised, 1 initialised,
        # 2 after VIBA1, 3 after VIBA2
        self._viba_stage = 0
        self._t_init = 0.0
        self._last_scale_refine = 0.0
        # each IMU initialisation stage that took: its time, stage, keyframe
        # count, scale and the full inertial BA's camera count
        self.imu_events: list = []
        if self.inertial:
            self.local_mapper.inertial_ba = lambda: (
                inertial.run_local_inertial_ba(
                    self.map, self.cam, calib=self.tracker.imu.calib))
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
        # the per-map update lock, shared with the tracker and the loop
        # closer (reference: Map::mMutexMapUpdate)
        self.map_lock = threading.RLock()
        self.tracker.map_lock = self.map_lock
        self._async = async_mapping
        # tracking may run at most max_kf_lag unprocessed keyframes ahead of
        # the worker; past it the frame waits (the producer's side of the
        # reference's AcceptKeyFrames gate, LocalMapping.cc:361-379)
        self.max_kf_lag = max(int(max_kf_lag), 1)
        self.n_backpressure_waits = 0
        self._kf_queue = None
        self._worker = None
        if vocab_path is not None:
            self._build_recognition(vocab_path=vocab_path)
        self.tracker.relocalizer = self._relocalize
        if async_mapping:
            self._kf_queue = queue.Queue()
            self._worker = threading.Thread(target=self._mapping_worker,
                                            daemon=True)
            self._worker.start()

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
        # mbFixScale for STEREO / RGBD / IMU_STEREO / IMU_RGBD)
        self.loop_closer = LoopCloser(
            self.map, self.cam, self.kfdb,
            LoopClosingConfig(async_gba=self._async, fix_scale=self.sensor in (
                STEREO, RGBD, IMU_STEREO, IMU_RGBD)), group=self.group)
        # in async mode the global BA after a loop races tracking on its own
        # thread and applies under the map lock (reference: mpThreadGBA)
        self.loop_closer.map_lock = self.map_lock
        if self.inertial:
            # the global BA after a loop is the full inertial one
            self.loop_closer.imu_calib = self.tracker.imu.calib

    @classmethod
    def from_settings(cls, s, sensor: int = MONOCULAR, **overrides):
        """A System from parsed Settings (``utils/config.load_settings``):
        the reference System constructor's wiring of the settings file
        (System.cc:80-265): the ORB budget, pyramid and FAST thresholds,
        fps as the keyframe cadence, the rig (baseline, or Camera2 and
        T_c1_c2), the IMU's noise and T_bc, the loop-closing switch and
        the input resize. Keyword arguments win (``device="cpu"``, or
        ``camera=`` for a rectified camera)."""
        # the feature budget padded to a multiple of 128, as the JAX
        # package pads it for its kernels' lanes (the port's take any K)
        n_feat = int(int(np.ceil(s.n_features / 128.0)) * 128)
        tcfg = TrackingConfig(n_features=n_feat,
                              max_frames=max(1, int(round(s.fps))),
                              insert_kfs_when_lost=s.insert_kfs_when_lost)
        if sensor not in (MONOCULAR, IMU_MONOCULAR):
            tcfg.ref_ratio = 0.75   # thRefRatio (Tracking.cc:3737)
        orb = OrbConfig(n_features=n_feat, n_levels=s.n_levels,
                        scale=s.scale_factor, ini_th=s.ini_th_fast,
                        min_th=s.min_th_fast)
        mcfg = MapConfig(n_feat=n_feat, n_levels=s.n_levels,
                         scale=s.scale_factor)
        imu_calib = None
        if sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD):
            T = (np.eye(4, dtype=np.float32) if s.T_bc is None
                 else np.asarray(s.T_bc, np.float32))
            imu_calib = ImuCalib(
                noise_gyro=s.imu_noise_gyro, noise_acc=s.imu_noise_acc,
                walk_gyro=s.imu_walk_gyro, walk_acc=s.imu_walk_acc,
                R_bc=T[:3, :3].copy(), t_bc=T[:3, 3].copy())
        kw = dict(map_cfg=mcfg, tracking_cfg=tcfg, orb_cfg=orb,
                  enable_loop_closing=s.loop_closing, baseline=s.baseline,
                  th_depth=s.th_depth, imu_calib=imu_calib,
                  camera2=s.camera2, T_c1c2=s.T_c1c2)
        cam = overrides.pop("camera", s.camera)
        kw.update(overrides)
        slam = cls(cam, sensor, **kw)
        if s.resize_to is not None:
            # the factor callers divide pixel coordinates by
            # (System::GetImageScale, System.cc:285-300)
            slam.image_scale = float(s.resize_to[0]) / float(
                s.orig_width or s.resize_to[0])
        return slam

    # ------------------------------------------------------------------
    def track_monocular(self, img, ts: float,
                        imu=None) -> Optional[np.ndarray]:
        """Feed one grayscale frame; returns 4x4 T_cw or None. imu:
        optional (acc [M, 3], gyro [M, 3], t [M]) samples since the
        previous frame (reference: System::TrackMonocular, System.cc:441)."""
        pose = self.tracker.track_monocular(img, ts, imu)
        return self._post_track(pose, ts)

    def track_stereo(self, img_l, img_r, ts: float,
                     imu=None) -> Optional[np.ndarray]:
        """Feed one stereo pair (rectified, or of the two-camera rig);
        returns 4x4 T_cw or None (reference: System::TrackStereo,
        System.cc:277)."""
        pose = self.tracker.track_stereo(img_l, img_r, ts, imu)
        return self._post_track(pose, ts)

    def track_rgbd(self, img, depth, ts: float,
                   imu=None) -> Optional[np.ndarray]:
        """Feed one image and its registered depth map [H, W] (metres, 0 =
        none); returns 4x4 T_cw or None (reference: System::TrackRGBD,
        System.cc:361)."""
        pose = self.tracker.track_rgbd(img, depth, ts, imu)
        return self._post_track(pose, ts)

    def track_stereo_iter(self, items):
        """Pipelined stereo ingestion, the stereo form of
        track_monocular_iter: items yields (img_l, img_r, ts) or (img_l,
        img_r, ts, imu); the next pair's extraction and matching is queued
        on the device before the current frame's tracking walks its host
        stages. Bit-identical to track_stereo. Each pair's extraction runs
        under its own frame id (``utils/timing``)."""
        tk = self.tracker
        prev = None
        for item in items:
            imu = item[3] if len(item) > 3 else None
            timing.frame(tk.frame_id + (prev is not None))
            cur = (*tk.prepare_stereo(item[0], item[1]), float(item[2]), imu)
            if prev is not None:
                yield self._post_track(tk.track_prepared_stereo(*prev),
                                       prev[2])
            prev = cur
        if prev is not None:
            yield self._post_track(tk.track_prepared_stereo(*prev), prev[2])

    def track_monocular_iter(self, items):
        """Pipelined ingestion: the next frame's ORB extraction is queued on
        the device before the current frame's tracking walks its host
        stages. items yields (img, ts) or (img, ts, imu); yields the same
        poses as track_monocular, bit for bit (extraction is pure, so the
        order of dispatch changes no result). Each frame's extraction runs
        under its own frame id (``utils/timing``)."""
        tk = self.tracker
        prev = None
        for item in items:
            img, ts = item[0], float(item[1])
            imu = item[2] if len(item) > 2 else None
            timing.frame(tk.frame_id + (prev is not None))
            with timing.span("ORB extraction"):
                prep = kernels.prepare_frame(tk.image(img), self.cam,
                                             tk.orb_cfg, tk.cfg.frontend)
            cur = (prep, ts, None, imu)
            if prev is not None:
                yield self._post_track(tk._track_frame(*prev), prev[1])
            prev = cur
        if prev is not None:
            yield self._post_track(tk._track_frame(*prev), prev[1])

    def track_monocular_batch(self, imgs, stamps, imu_seq=None,
                              group=None) -> list:
        """Offline / bulk ingestion: extract the frames [n, H, W] in blocks
        of ``batch_extract.INGEST_BLOCK_MULTIPLE`` frames a rank
        (``parallel.batch_extract.prepare_frames``: a block's frames ride
        one batched extraction, and with a process group of several ranks
        each rank takes its share of a block while rank 0, here, leads the
        others in ``dist_ba.serve``), then run the tracking state machine
        over the prepared frames in order. Returns [T_cw or None] a frame,
        as frame-by-frame ``track_monocular`` does; imu_seq: one window a
        frame, or None. group defaults to the System's.

        (No reference equivalent: the reference is strictly online.)"""
        from ..parallel import batch_extract
        tk = self.tracker
        if tk.cfg.frontend != "fused":
            raise ValueError("track_monocular_batch extracts on the fused "
                             "front end only")
        with timing.span("ORB extraction"):   # the batch's, amortised
            preps = batch_extract.prepare_frames(
                self.cam, tk.orb_cfg, imgs, group or self.group,
                batch_extract.INGEST_BLOCK_MULTIPLE, device=self.device,
                lead=True)
        out = []
        for i, prep in enumerate(preps):
            imu = None if imu_seq is None else imu_seq[i]
            pose = tk.track_prepared(prep, float(stamps[i]), imu_meas=imu)
            out.append(self._post_track(pose, float(stamps[i])))
        return out

    def _post_track(self, pose, ts: float = 0.0):
        while self.tracker.new_keyframes:
            k = self.tracker.new_keyframes.pop(0)
            if not self._async:
                self._process_keyframe(k, ts)
                continue
            self._kf_queue.put((k, ts))
            # bounded staleness: wait, off the map lock, until the worker is
            # within max_kf_lag keyframes of tracking
            if self._kf_queue.unfinished_tasks > self.max_kf_lag:
                self.n_backpressure_waits += 1
                while (self._kf_queue.unfinished_tasks > self.max_kf_lag
                       and self._worker is not None
                       and self._worker.is_alive()):
                    time.sleep(0.002)
        if ((self.tracker.state == LOST
             and not self.tracker.localization_only)
                or self._change_dataset_pending):
            if self._async:
                self.wait_idle()
            with self.map_lock:
                self._spawn_or_reset_map()
            self._change_dataset_pending = False
        return pose

    def _process_keyframe(self, k: int, ts: float = 0.0):
        """One LocalMapping + LoopClosing iteration for keyframe k (the
        bodies of the reference's mapping and loop threads), then the IMU
        schedule, under the keyframe's frame id (``utils/timing``)."""
        timing.frame(int(self.map.kf_frame_id[k]))
        if self.map.kf_valid[k] and self.map.n_kf > 2:
            self.local_mapper.process_keyframe(k)
        if self.enable_loop_closing:
            self._close_loops(k)
        if self.inertial:
            self._imu_schedule(ts)

    def _mapping_worker(self):
        """The worker thread: one keyframe at a time under the map lock. An
        exception ends the thread (``threading.excepthook`` reports it);
        ``task_done`` still runs, so that nothing waits on it forever."""
        while True:
            item = self._kf_queue.get()
            if item is None:
                self._kf_queue.task_done()
                return
            k, ts = item
            try:
                with self.map_lock:
                    self._process_keyframe(k, ts)
            finally:
                self._kf_queue.task_done()

    def wait_idle(self):
        """Block until the mapping worker has drained its queue and a
        racing global BA has applied its result (or the worker has ended
        on an exception, which ``threading.excepthook`` reported)."""
        q = self._kf_queue
        if self._async and q is not None:
            with q.all_tasks_done:
                while q.unfinished_tasks and self._worker.is_alive():
                    q.all_tasks_done.wait(timeout=0.1)
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()

    def _close_loops(self, k: int):
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
                # the weld rewrites the snapshot a racing global BA solves
                # (MergeLocal sets mbStopGBA)
                self.loop_closer.abort_gba()
                c, S_kc = out
                # other world -> active world: T_k^-1 ∘ S_kc ∘ T_c
                S_ao = (host_sim3(act.kf_R[k], act.kf_t[k]).inverse()
                        .compose(S_kc)
                        .compose(host_sim3(other.kf_R[int(c)],
                                           other.kf_t[int(c)])))
                if (self.inertial and act.imu_initialized
                        and other.imu_initialized and act.imu_ba1):
                    # both worlds are gravity-aligned: the weld is yaw-only
                    # at unit scale (LoopClosing.cc:182-189)
                    phi = so3.log(S_ao.R).clone()
                    phi[0:2] = 0.0
                    S_ao = host_sim3(so3.exp(phi), S_ao.t, 1.0)
                act_kfs_before = [int(x) for x in act.kf_ids()]
                other_inertial = bool(other.imu_initialized)
                slot_map = self.atlas.merge_map_into_active(mid, S_ao)
                for new in slot_map.values():
                    self.kfdb.add(new, act.kf_feat_desc[new],
                                  act.kf_feat_valid[new])
                self.kfdbs.pop(mid, None)
                self.loop_closer._fuse_loop_points(k, slot_map[int(c)])
                snap_R, snap_t = act.kf_R.copy(), act.kf_t.copy()
                # the weld window's refinement: visual-inertial when both
                # maps carry initialised IMU state (MergeInertialBA,
                # LoopClosing.cc:2127), else the visual weld BA
                window = None
                if self.inertial and act.imu_initialized and other_inertial:
                    window = inertial.run_merge_inertial_ba(
                        act, self.cam, k, slot_map[int(c)],
                        self.tracker.imu.calib)
                if window is None:
                    window = [k] + list(slot_map.values())[:12]
                    run_local_ba(act, window, fixed=[k], cam=self.cam,
                                 iters=6)
                run_merge_essential_graph(
                    act, snap_R, snap_t,
                    set(act_kfs_before) | set(int(w) for w in window),
                    inertial=act.imu_initialized,
                    fix_scale=self.loop_closer.cfg.fix_scale)
                act.update_point_stats(np.where(act.pt_valid)[0])
                return

    # ------------------------------------------------------------------
    def _imu_stage(self, ts: float, prior_gyro: float, prior_acc: float,
                   fix_scale: bool, full_ba: bool = True) -> bool:
        """One initialisation solve and, where it took, the map's change of
        frame passed on to the tracker and a full inertial BA at the same
        priors (FullInertialBA closes every stage, LocalMapping.cc:1760-1800).
        """
        m = self.map
        calib = self.tracker.imu.calib
        with timing.span("IMU init"):
            out = inertial.try_initialize_imu(
                m, min_kf=8, min_time=1.0, prior_gyro=prior_gyro,
                prior_acc=prior_acc, fix_scale=fix_scale, calib=calib)
            if out is None:
                return False
            R_wg, s = out
            self.tracker.on_map_transformed(np.asarray(R_wg), float(s))
            C = 0
            if full_ba:
                C = inertial.run_full_inertial_ba(
                    m, self.cam, iters=12, prior_gyro=prior_gyro,
                    prior_acc=prior_acc, max_obs=full_obs_cap(m),
                    calib=calib)
        self.imu_events.append(dict(ts=float(ts), stage=self._viba_stage,
                                    n_kf=int(m.n_kf), scale=float(s),
                                    full_ba_cams=int(C)))
        return True

    def _imu_schedule(self, ts: float):
        """The staged IMU initialisation (reference: LocalMapping.cc:236-310:
        InitializeIMU with falling priors, then VIBA1 after 5 s and VIBA2
        after 15 s, and the monocular scale refinement). Stereo and RGB-D
        maps are metric: their scale stays 1 (bFixedScale)."""
        m = self.map
        fix_scale = self.sensor in (IMU_STEREO, IMU_RGBD)
        if self._viba_stage == 0:
            if self._imu_stage(ts, 1e2, 1e6, fix_scale):
                self._viba_stage = 1
                self._t_init = ts
            return
        t_since = ts - self._t_init
        if self._viba_stage == 1 and t_since > 5.0:
            self._imu_stage(ts, 1.0, 1e5, fix_scale)
            self._viba_stage = 2
            m.imu_ba1 = True
        elif self._viba_stage == 2 and t_since > 15.0:
            self._imu_stage(ts, 0.0, 0.0, fix_scale)
            self._viba_stage = 3
            m.imu_ba2 = True
        elif (self._viba_stage >= 3 and self.sensor == IMU_MONOCULAR
              and m.n_kf <= 200 and 25.0 <= t_since <= 75.0
              and t_since - self._last_scale_refine >= 10.0):
            # scale / gravity re-solve while the map is young, the biases
            # pinned by huge priors (ScaleRefinement, LocalMapping.cc:295-310)
            self._last_scale_refine = t_since
            self._imu_stage(ts, 1e6, 1e8, False, full_ba=False)

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
            with timing.span("pose GN"):
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
            SEARCHES.bump("reloc_search")
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
            SEARCHES.bump("reloc_match")
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
        if self.loop_closer is not None:
            self.loop_closer.abort_gba()   # its snapshot is of the old map
        self.map = m
        self.tracker.reset_for_new_map(m)
        self.local_mapper.map = m
        self.local_mapper.recent_points.clear()
        self._viba_stage = 0
        self._last_scale_refine = 0.0
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
        """Drain the mapping worker, stop it and wait for a racing global
        BA (reference: System::Shutdown, System.cc:563)."""
        if self._async and self._worker is not None:
            self.wait_idle()
            self._kf_queue.put(None)
            self._worker.join(timeout=30)
            self._worker = None
            self._async = False
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
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
        with self.map_lock:
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
        with self.map_lock:
            self.kfdbs.pop(self.atlas.active_id, None)
            self._reset_active_store()

    def get_time_from_imu_init(self) -> float:
        """Seconds from the IMU's initialisation to the last frame; 0 until
        then and without an IMU (reference: System::GetTimeFromIMUInit,
        System.cc:1418)."""
        if not self.inertial or self._viba_stage == 0:
            return 0.0
        return float(self.tracker.cur_ts - self._t_init)

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

    # ------------------------------------------------------------------
    def save_atlas(self, path: str):
        """Checkpoint every map (reference: System::SaveAtlas,
        System.cc:1466), in the JAX package's format."""
        with self.map_lock:
            serialization.save_atlas(self.atlas, path)

    def load_atlas(self, path: str):
        """Resume from a checkpoint: the tracker, the mapper and the loop
        closer take its active map, and a tracker on a map with keyframes
        relocalises into it (reference: LoadAtlas's session resume,
        System.cc:180). The device mirrors of the maps are built at first
        use."""
        if self._async:
            self.wait_idle()
        with self.map_lock:
            if self.loop_closer is not None:
                self.loop_closer.abort_gba()
            self.atlas = serialization.load_atlas(path, self.device)
            self.map = self.atlas.active
            self.tracker.map = self.map
            self.local_mapper.map = self.map
            if self.loop_closer is not None:
                self.loop_closer.map = self.map
            if self.map.n_kf > 0:
                self.tracker.state = LOST
                self.tracker.lost_count = 0

    def warmup(self, n_frames: int = 14):
        """Pay the cold start before real data arrives: build (or load) the
        CUDA kernels and run a throwaway System of the same static
        configuration (camera, rig, ORB, map and tracking configs, sensor)
        over a short ray-cast sequence, 40 frames with exact IMU windows
        for an inertial sensor so that its IMU initialises, which creates
        the cuBLAS and cuSOLVER handles and fills the caching allocator's
        pools. This System's own map and state are left as they were. (No
        reference counterpart: in the JAX package it compiles the XLA
        programs.)"""
        from .. import native
        if self.device.type == "cuda":
            native.lib()
        planes = synth_render.default_world(np.random.default_rng(0),
                                            tex_size=600)
        windows = None
        if self.inertial:
            n_frames = max(n_frames, 40)
            traj = synth_render.inertial_trajectory(n_frames)
            R, t = traj["R_cw"], traj["t_cw"]
            ts_all = np.asarray(traj["ts"], np.float64)
            windows = traj["windows"]
        else:
            R, t = synth_render.orbit_trajectory(n_frames)
            ts_all = np.arange(n_frames) / 10.0
        tk = self.tracker
        warm_calib = None
        if tk.imu is not None:
            # an identity extrinsic: the IMU of the throwaway sequence is
            # exact in the camera's frame
            warm_calib = tk.imu.calib._replace(
                R_bc=np.eye(3, dtype=np.float32),
                t_bc=np.zeros(3, np.float32))
        T_c1c2 = (None if tk.T_rl is None else np.linalg.inv(
            np.asarray(tk.T_rl, np.float64)).astype(np.float32))
        shadow = System(self.cam, self.sensor, imu_calib=warm_calib,
                        map_cfg=self.atlas.map_cfg, tracking_cfg=tk.cfg,
                        mapping_cfg=self.local_mapper.cfg,
                        orb_cfg=tk.orb_cfg,
                        baseline=tk.bf / self.cam.fx if tk.bf else 0.0,
                        th_depth=(tk.th_depth * self.cam.fx / tk.bf
                                  if tk.bf else 35.0),
                        camera2=tk.cam2, T_c1c2=T_c1c2,
                        enable_loop_closing=False, device=self.device)

        def render(cam, R_cw, t_cw):
            if cam.kind == cameras.PINHOLE and not any(cam.dist):
                return synth_render.render_image(cam, planes, R_cw, t_cw,
                                                 self.device)
            return synth_render.render_frame_raycast(cam, planes, R_cw,
                                                     t_cw)[0]

        for i in range(n_frames):
            imu = windows[i] if windows is not None else None
            ts_i = float(ts_all[i])
            if self.sensor in (STEREO, IMU_STEREO) and tk.bf > 0:
                if tk.cam2 is not None:
                    left = render(self.cam, R[i], t[i])
                    T_rl = np.asarray(tk.T_rl, np.float64)
                    right = render(tk.cam2,
                                   (T_rl[:3, :3] @ R[i]).astype(np.float32),
                                   (T_rl[:3, :3] @ t[i]
                                    + T_rl[:3, 3]).astype(np.float32))
                else:
                    left, right = synth_render.render_stereo_pair(
                        self.cam, planes, R[i], t[i], tk.bf / self.cam.fx)
                shadow.track_stereo(left, right, ts_i, imu=imu)
            elif self.sensor in (RGBD, IMU_RGBD):
                depth = synth_render.render_depth(self.cam, planes, R[i],
                                                  t[i])
                shadow.track_rgbd(render(self.cam, R[i], t[i]), depth, ts_i,
                                  imu=imu)
            else:
                shadow.track_monocular(render(self.cam, R[i], t[i]), ts_i,
                                       imu=imu)
        shadow.shutdown()
        return self

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
