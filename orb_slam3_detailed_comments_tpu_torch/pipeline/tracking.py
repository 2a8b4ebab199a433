"""Tracking: the visual front-end state machine (monocular, stereo, RGB-D).

Counterpart of ``pipeline/tracking.py`` of the JAX package (reference:
Tracking::Track, src/Tracking.cc:1971). States as in the reference
(include/Tracking.h:121-129): NO_IMAGES_YET, NOT_INITIALIZED, OK,
RECENTLY_LOST, LOST. From its first image a tracker builds its own map:

  two frames with enough matches -> two-view reconstruction
  (``models/twoview.py``) -> two keyframes + points -> bundle adjustment
  (``local_mapping.run_local_ba``) -> the next frame is tracked against
  the reference keyframe and the local map -> from then on each frame takes
  the fused motion-model + local-map step (``kernels.track_step_visual``)
  -> a tracked frame becomes a keyframe when ``_need_new_keyframe`` says so
  (``_create_new_keyframe``), and its id joins ``new_keyframes``, the queue
  that ``System`` drains into the ``LocalMapper``.

A stereo or RGB-D tracker (``sensor``, ``bf``) starts from one frame
instead: its depth-backed features become the first keyframe's points
(``_stereo_initialization``), and every keyframe adds close points from
the frame's depth (``_create_depth_points``). The frame's depth stays on
the device until the fused step's or the local-map stage's packed fetch
brings it down with the rest.

A tracker can also start from a map built elsewhere (``start_from_map``).
A lost tracker relocalises through ``relocalizer`` (the System's
place-recognition callback, reference Tracking::Relocalization,
Tracking.cc:4324), also into a map it did not build; the local-map search
stays widened for 2 frames after a relocalisation. In localisation mode
(``localization_only``) the map is frozen: no keyframes, and when the map
gives too few matches the frame is tracked on the last frame's
depth-backed features (visual odometry, Tracking.cc:2279-2360).

With an IMU (``imu_calib``) every frame's window of samples is
preintegrated on the device (``_preintegrate``) and accumulated since the
last keyframe; keyframes come on a time cadence and carry their window,
velocity and biases into the map. Once the map's IMU is initialised the
motion model becomes the IMU's dead-reckoned prediction, and the fused step
appends the visual-inertial refine of the frame's nav state
(``kernels.track_step_inertial_anchor`` after a map change,
``track_step_inertial_lf`` under the running marginalisation prior, which
stays on the device, otherwise). While RECENTLY_LOST the tracker keeps
emitting dead-reckoned poses and inserting keyframes on the cadence, and
re-acquires by matching the recent keyframes' points at the predicted pose.
``on_map_transformed`` re-expresses its state after the IMU
initialisation rotates and rescales the world.

Per steady frame the host makes three copies: the image up, the small
inputs (predicted pose, stage-1 candidate ids and angles) up as one packed
buffer, and every result down as one packed buffer. Constant tables live on
the device from their first use, and the pose optimizer runs without a host
sync (``optim/pose_opt.py``).
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..lie import SE3
from . import inertial
from ..mapping.mapstore import MapStore, NO_POINT
from ..models import cameras, twoview
from ..ops import extractor, matching
from ..optim import pose_opt
from ..utils import timing
from . import kernels
from .local_mapping import run_local_ba

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


@dataclass
class TrackingConfig:
    n_features: int = 1024
    max_frames: int = 20          # keyframe policy c1a: fps (mMaxFrames)
    min_frames: int = 0
    ref_ratio: float = 0.9        # mono thRefRatio (reference: Tracking.cc:3737)
    min_init_matches: int = 100   # reference: Tracking.cc:2825,2859
    motion_radius: float = 15.0   # px search radius, motion model (mono)
    local_radius: float = 4.0     # px search radius, local map
    local_pts_cap: int = 4096     # padded local point set size
    min_inliers_mm: int = 20
    min_inliers_local: int = 30
    recently_lost_frames: int = 100
    periodic_kf: bool = True      # a keyframe every max_frames regardless
                                  # of c2 (see _need_new_keyframe)
    insert_kfs_when_lost: bool = True  # IMU: keep the keyframe cadence while
                                  # RECENTLY_LOST (IMU.InsertKFsWhenLost,
                                  # Tracking.cc:2569)
    frontend: str = "fused"       # extractor front end: "fused" or "xla"


@dataclass
class FrameRecord:
    """Host-side record of the last processed frame."""
    T_cw: SE3               # numpy R [3, 3], t [3]
    match_pt: Optional[np.ndarray]    # [N] map point per feature (-1 = none)
    ts: float
    frame_id: int
    angles: Optional[np.ndarray] = None   # [N] keypoint angles, if fetched
    prepared: Optional[kernels.PreparedFrame] = None
    depth: Optional[np.ndarray] = None    # [N] per-feature depth (stereo/RGBD)


def _compose_np(A: SE3, B: SE3) -> SE3:
    """A ∘ B on the host."""
    Ra, ta = np.asarray(A.R), np.asarray(A.t)
    Rb, tb = np.asarray(B.R), np.asarray(B.t)
    return SE3((Ra @ Rb).astype(np.float32), (Ra @ tb + ta).astype(np.float32))


def _inverse_np(A: SE3) -> SE3:
    Rt = np.asarray(A.R).T
    return SE3(Rt.astype(np.float32),
               (-Rt @ np.asarray(A.t)).astype(np.float32))


def _identity_np() -> SE3:
    return SE3(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


SENSOR_MONO = 0
SENSOR_STEREO = 1
SENSOR_RGBD = 2


class Tracker:
    def __init__(self, cam: cameras.CameraParams, mapstore: MapStore,
                 cfg: TrackingConfig = TrackingConfig(),
                 orb_cfg: Optional[extractor.OrbConfig] = None,
                 sensor: int = SENSOR_MONO, bf: float = 0.0,
                 th_depth: float = 35.0, cam2=None, T_rl=None,
                 device=None, imu_calib=None):
        self.device = device_mod.resolve(device)
        if mapstore.device != self.device:
            raise ValueError(f"map lives on {mapstore.device}, tracker on "
                             f"{self.device}")
        self.cam = cam
        # second (non-rectified, fisheye) stereo camera and the right <- left
        # extrinsic 4x4 (reference: the two-GeometricCamera stereo mode)
        self.cam2 = cam2
        self.T_rl = None if T_rl is None else np.asarray(T_rl, np.float32)
        if cam2 is not None and T_rl is not None and bf <= 0.0:
            bf = float(np.linalg.norm(self.T_rl[:3, 3])) * cam.fx
        self.sensor = sensor
        self.bf = bf                      # baseline * fx (stereo / RGB-D)
        # close-point threshold = th_depth * baseline (reference ThDepth)
        self.th_depth = th_depth * (bf / cam.fx) if bf > 0 else 0.0
        # [N] per-feature depth of the current frame: a device tensor until
        # a packed fetch brings it down, then numpy; None for monocular
        self.cur_depth = None
        self._rl_dev = None               # (R_rl, t_rl) on the device
        self.map = mapstore
        self.cfg = cfg
        self.orb_cfg = orb_cfg or extractor.OrbConfig(n_features=cfg.n_features)
        self.state = NO_IMAGES_YET
        self.velocity: Optional[SE3] = None
        self.last: Optional[FrameRecord] = None
        self.init_ref: Optional[FrameRecord] = None
        self.ref_kf = -1
        self.last_kf_id = -1
        self.last_kf_frame_id = -999
        self.frame_id = 0
        self.lost_count = 0
        self.localization_only = False   # frozen map (localisation mode)
        # place-recognition callback: prep -> (R, t, match_pt, ref_kf) or
        # None (System._relocalize)
        self.relocalizer = None
        self.n_relocalizations = 0
        self.last_reloc_fid = -999
        self.n_vo_searches = 0           # visual-odometry match_nn calls
        self.n_steps = 0                 # fused steps dispatched
        self.n_ref_kf_searches = 0       # reference-keyframe searches
        self.n_local_map_searches = 0    # local-map stages outside the step
        self.n_candidates2 = 0           # stage-2 candidates of the last step
        self.n_init_matches = 0          # matches given to the two-view solve
        self.n_init_good = 0             # of them triangulated, before BA
        self._seed_from_kfs = False
        # trajectory rows: (ts, map_id, ref_kf, epoch, R_cr, t_cr, state)
        self.trajectory: list = []
        # per-frame stats rows: (ts, state, n_features, n_matches)
        self.track_stats: list = []
        self.new_keyframes: list = []    # queue to local mapping
        self.radius_scale, self.inv_sigma2 = kernels.level_weights(
            self.orb_cfg.n_levels, self.orb_cfg.scale)
        self._inv_sigma2_dev = torch.from_numpy(self.inv_sigma2).to(self.device)
        # stage-1 / stage-2 search radii per level at (stage-1, stage-2)
        # widenings: normal, the first frame after seeding (both 3x) and the
        # frames just after a relocalisation (the local map's 3x), uploaded
        # once
        self._radii_dev = {
            widen: tuple(torch.from_numpy(
                (w * r * self.radius_scale).astype(np.float32)).to(
                    self.device)
                for w, r in zip(widen, (cfg.motion_radius, cfg.local_radius)))
            for widen in ((1.0, 1.0), (3.0, 3.0), (1.0, 3.0))}
        # inertial state (None for the visual sensors)
        self.imu = (None if imu_calib is None
                    else inertial.ImuFrameState(calib=imu_calib))
        self.last_ts: Optional[float] = None
        self.cur_ts = 0.0
        self.last_kf_ts = -1e9
        self.min_kf_dt = 0.25    # IMU keyframe cadence (Tracking.cc:3700)
        self._imu_prior = None   # marginalisation prior, on the device
        self._imu_prior_key = None
        self._v_pred = None      # this frame's predicted velocity (device)
        self._v_pred_fid = -1
        self.n_inertial_steps = {"anchor": 0, "lf": 0}
        self.n_dead_reckoned = 0
        # the per-map update lock (reference: mMutexMapUpdate, taken in
        # Track(), Tracking.cc:2078); the System gives its own in async mode
        self.map_lock = threading.RLock()

    def start_from_map(self, T_cw: SE3, ts: float, last_kf_id: int,
                       velocity: Optional[SE3] = None) -> None:
        """Track on from a map built elsewhere: T_cw (numpy) is the pose of
        the frame before the next one, ``last_kf_id`` the newest keyframe.
        The next frame seeds its motion-model candidates from the keyframe
        chain at widened radii (the JAX tracker's seed_from_kfs branch);
        later frames seed from the last frame's matches."""
        N = self.map.cfg.n_feat
        self.last = FrameRecord(SE3(np.asarray(T_cw.R, np.float32),
                                    np.asarray(T_cw.t, np.float32)),
                                np.full(N, -1, np.int32), ts, -1)
        self.velocity = velocity or _identity_np()
        self.last_kf_id = self.ref_kf = int(last_kf_id)
        self.last_kf_frame_id = self.frame_id - 1
        self.state = OK
        self._seed_from_kfs = True

    # ------------------------------------------------------------------
    def track_monocular(self, img, ts: float,
                        imu_meas=None) -> Optional[np.ndarray]:
        """Process one grayscale frame [H, W] (numpy or tensor, 0..255);
        returns T_cw 4x4 or None if the frame was not tracked (reference:
        Tracking::GrabImageMonocular + Track(), Tracking.cc:1668,1971).
        imu_meas: optional (acc [M, 3], gyro [M, 3], t [M]) samples since
        the previous frame."""
        timing.frame(self.frame_id)
        with timing.span("ORB extraction"):
            prep = kernels.prepare_frame(self.image(img), self.cam,
                                         self.orb_cfg, self.cfg.frontend)
        return self.track_prepared(prep, ts, imu_meas)

    def track_prepared(self, prep: kernels.PreparedFrame, ts: float,
                       imu_meas=None) -> Optional[np.ndarray]:
        """Track a monocular frame extracted ahead (bulk ingestion:
        ``parallel.batch_extract.prepare_frames`` extracts the frames in
        blocks, and the state machine takes them in order)."""
        return self._track_frame(prep, ts, None, imu_meas)

    def image(self, img) -> torch.Tensor:
        """An image [H, W] (numpy or tensor) as float32 on the device."""
        return device_mod.to_device(torch.as_tensor(
            np.asarray(img, np.float32) if isinstance(img, np.ndarray)
            else img).to(torch.float32), self.device)

    def prepare_stereo(self, img_l, img_r):
        """(PreparedFrame, depth [N] on the device) of a stereo pair: row
        matching for a rectified pair, epipolar matching and triangulation
        for a two-camera rig (``cam2``)."""
        with timing.span("ORB extraction"):
            img_l, img_r = self.image(img_l), self.image(img_r)
            if self.cam2 is not None:
                if self._rl_dev is None:
                    rl = device_mod.to_device(np.concatenate(
                        [self.T_rl[:3, :3].reshape(-1), self.T_rl[:3, 3]]),
                        self.device)
                    self._rl_dev = (rl[:9].reshape(3, 3), rl[9:])
                prep, depth, _ = kernels.prepare_frame_stereo_fisheye(
                    img_l, img_r, self.cam, self.cam2, *self._rl_dev,
                    self.orb_cfg, self.cfg.frontend)
            else:
                prep, depth, _ = kernels.prepare_frame_stereo(
                    img_l, img_r, self.cam, self.bf, self.orb_cfg,
                    self.orb_cfg.n_levels, self.orb_cfg.scale,
                    self.cfg.frontend)
        return prep, depth

    def track_stereo(self, img_l, img_r, ts: float,
                     imu_meas=None) -> Optional[np.ndarray]:
        """(reference: Tracking::GrabImageStereo, Tracking.cc:1523)"""
        timing.frame(self.frame_id)
        prep, depth = self.prepare_stereo(img_l, img_r)
        return self._track_frame(prep, ts, depth, imu_meas)

    def track_rgbd(self, img, depth_img, ts: float,
                   imu_meas=None) -> Optional[np.ndarray]:
        """(reference: Tracking::GrabImageRGBD, Tracking.cc:1613)"""
        timing.frame(self.frame_id)
        with timing.span("ORB extraction"):
            prep, depth, _ = kernels.prepare_frame_rgbd(
                self.image(img), self.image(depth_img), self.cam, self.bf,
                self.orb_cfg, self.cfg.frontend)
        return self._track_frame(prep, ts, depth, imu_meas)

    def track_prepared_stereo(self, prep: kernels.PreparedFrame, depth,
                              ts: float,
                              imu_meas=None) -> Optional[np.ndarray]:
        """Track a stereo / RGB-D frame prepared ahead (pipelined ingestion:
        System.track_stereo_iter)."""
        return self._track_frame(prep, ts, depth, imu_meas)

    def _preintegrate(self, ts: float, imu_meas):
        """Preintegrate the frame gap's samples on the device and extend
        the since-keyframe window (reference: Tracking::PreintegrateIMU,
        Tracking.cc:1739). The last sample's interval reaches the frame
        time."""
        acc, gyro, t = imu_meas
        acc = np.asarray(acc, np.float32).reshape(-1, 3)
        gyro = np.asarray(gyro, np.float32).reshape(-1, 3)
        t = np.asarray(t, np.float64).reshape(-1)
        if len(t) == 0:
            return
        t0 = self.last_ts if self.last_ts is not None else t[0]
        dts = np.maximum(t - np.concatenate([[t0], t[:-1]]), 0.0)
        if ts > t[-1]:
            dts[-1] += ts - t[-1]
        if dts.sum() <= 0:
            return
        pre = inertial.integrate_frame_window(
            self.imu.calib, gyro, acc, dts.astype(np.float32), self.imu.bg,
            self.imu.ba, self.device)
        self.imu.pre_last_frame = pre
        self.imu.pre_since_kf = (pre if self.imu.pre_since_kf is None
                                 else inertial.pre_mod.merge(
                                     self.imu.pre_since_kf, pre))

    def _track_frame(self, prep: kernels.PreparedFrame, ts: float,
                     depth: Optional[torch.Tensor] = None,
                     imu_meas=None) -> Optional[np.ndarray]:
        """One frame through the state machine; depth [N] (on the device)
        for a stereo or RGB-D frame, None for a monocular one; imu_meas the
        IMU samples since the previous frame."""
        fid = self.frame_id
        self.frame_id += 1
        timing.frame(fid)
        with timing.span("Track total"):
            self.cur_depth = depth
            if self.imu is not None:
                self.imu.pre_last_frame = None
                if imu_meas is not None:
                    self._preintegrate(ts, imu_meas)
            self.last_ts = ts
            self.cur_ts = ts
            # everything below reads or writes the map: the mapping worker
            # waits for it (the extraction and the preintegration ran
            # unlocked)
            with self.map_lock:
                return self._track_frame_locked(prep, ts, depth, fid)

    def _track_frame_locked(self, prep: kernels.PreparedFrame, ts: float,
                            depth, fid: int) -> Optional[np.ndarray]:
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            # a map this tracker did not build (a loaded or frozen one):
            # relocalise into it instead of initialising a new one
            self.state = (LOST if self.localization_only
                          or (self.map.n_kf > 0 and self.ref_kf < 0)
                          else NOT_INITIALIZED)
        if self.state == NOT_INITIALIZED:
            if depth is None:
                self._monocular_initialization(prep, ts, fid)
            else:
                self._stereo_initialization(prep, depth, ts, fid)
            if self.state != OK:
                return None
            return self._log_and_return(ts)

        # timestamp jump: the sequence skipped ahead (> 1 s); abandon the
        # frame (reference: Tracking.cc:2010-2043)
        if (self.state == OK and not self.localization_only
                and self.last is not None and ts - self.last.ts > 1.0):
            self.state = LOST
            self.velocity = None
            return None

        # --- normal tracking ---
        self._update_last_frame_pose()
        ok = fused = False
        imu_ready = (self.imu is not None and self.map.imu_initialized
                     and self.imu.pre_last_frame is not None
                     and self.last is not None)
        # RECENTLY_LOST re-acquisition with an IMU: the local map matched at
        # the dead-reckoned pose, stage-1 candidates from the recent
        # keyframes (Tracking.cc:2203-2240 -> 3067)
        imu_rescue = imu_ready and self.state == RECENTLY_LOST
        use_imu = imu_ready and self.state in (OK, RECENTLY_LOST)
        vo_mode = False
        with timing.span("pose prediction"):
            if (use_imu or (self.velocity is not None and self.state == OK
                            and self.last is not None)):
                # the fused step covers both the motion-model and the
                # local-map stage; "fail1" falls through to the
                # reference's fallback chain (Tracking.cc:2120)
                seed = self._seed_from_kfs or imu_rescue
                self._seed_from_kfs = False
                r = self._track_steady_fused(prep, ts, fid, use_imu=use_imu,
                                             seed_from_kfs=seed)
                if r != "fail1":
                    fused = True
                    ok = r == "ok"
            if not ok and not fused:
                ok = self._track_reference_keyframe(prep, ts, fid)
                if not ok and self.localization_only:
                    # the frozen map gave too few matches: track frame to
                    # frame on the last frame's depth-backed features
                    ok = vo_mode = self._track_visual_odometry(prep)
                if not ok and self.state in (RECENTLY_LOST, LOST) \
                        and self.relocalizer is not None:
                    ok = self._relocalization(prep, fid)
        if ok and not fused and not vo_mode:
            with timing.span("track local map"):
                ok = self._track_local_map()
        if ok:
            was_lost = self.state in (RECENTLY_LOST, LOST)
            self.state = OK
            self.lost_count = 0
            # velocity update (reference: Tracking.cc:2512-2520); after a
            # re-acquisition the motion model restarts clean
            if self.last is not None:
                self.velocity = (None if was_lost else _compose_np(
                    self.cur_T, _inverse_np(self.last.T_cw)))
                if self.imu is not None:
                    self._update_imu_velocity(was_lost, ts, fid)
            self._update_found_counters()
            with timing.span("New KF decision"):
                if self._need_new_keyframe():
                    self._create_new_keyframe(ts, fid)
            self.last = FrameRecord(self.cur_T, self.cur_match, ts, fid,
                                    angles=self._cur_angles,
                                    prepared=self.cur_prep,
                                    depth=self.cur_depth)
            return self._log_and_return(ts)

        # --- lost handling (reference: Tracking.cc:2203-2262) ---
        self.lost_count += 1
        if (self.lost_count <= self.cfg.recently_lost_frames
                and self.map.n_kf > 5):
            self.state = RECENTLY_LOST
        else:
            self.state = LOST
        self.velocity = None
        if (self.state == RECENTLY_LOST and self.imu is not None
                and self.map.imu_initialized and self.last is not None
                and self.imu.pre_last_frame is not None):
            return self._dead_reckon(prep, ts, fid)
        return None

    def _update_imu_velocity(self, was_lost: bool, ts: float, fid: int):
        """The world velocity the next prediction starts from: after a
        re-acquisition the IMU-propagated one of this frame (a
        frame-to-frame difference would read the visual correction as
        motion), else the body's displacement over the frame gap once the
        IMU is initialised (the JAX tracker's rule)."""
        if was_lost:
            if self._v_pred is not None and self._v_pred_fid == fid:
                self.imu.v_w = device_mod.fetch_packed([self._v_pred])[0]
        elif self.map.imu_initialized:
            dt = ts - self.last.ts
            if dt > 1e-6:
                R_bc, t_bc = inertial.extrinsic(self.imu.calib)
                _, p1 = inertial.body_from_camera(self.last.T_cw.R,
                                                  self.last.T_cw.t, R_bc, t_bc)
                _, p2 = inertial.body_from_camera(self.cur_T.R, self.cur_T.t,
                                                  R_bc, t_bc)
                self.imu.v_w = ((p2 - p1) / dt).astype(np.float32)

    def _dead_reckon(self, prep, ts: float, fid: int) -> np.ndarray:
        """RECENTLY_LOST in an initialised inertial map: emit the
        IMU-predicted pose, propagate the state for the next prediction and
        keep inserting keyframes on the IMU cadence so the preintegration
        chain stays dense through the blackout (reference:
        Tracking.cc:2203-2240 and InsertKFsWhenLost, Tracking.cc:2569)."""
        T_d, v_d = self._predict_imu()
        R, t, v, cur_ang, cur_valid, *depth = device_mod.fetch_packed(
            [T_d.R, T_d.t, v_d, prep.feat.angle, prep.feat.valid]
            + self._device_depth())
        if depth:
            self.cur_depth = depth[0]
        self.n_dead_reckoned += 1
        self.cur_T = SE3(R, t)
        self.cur_prep = prep
        self.cur_match = np.full(self.map.cfg.n_feat, -1, np.int32)
        self._cur_angles, self._cur_valid = cur_ang, cur_valid
        self.imu.v_w = v
        with timing.span("New KF decision"):
            if (self.cfg.insert_kfs_when_lost and not self.localization_only
                    and ts - self.last_kf_ts >= self.min_kf_dt):
                self._create_new_keyframe(ts, fid)
        self.last = FrameRecord(self.cur_T, self.cur_match, ts, fid,
                                angles=cur_ang, prepared=prep,
                                depth=self.cur_depth)
        return self._log_and_return(ts)

    def _predict_imu(self):
        """The IMU's dead-reckoned pose (SE3) and velocity of this frame
        from the last frame's state, on the device."""
        R_bc, t_bc = inertial.extrinsic(self.imu.calib)
        R, t, v, bg, ba, Rb, tb = device_mod.upload_packed(
            [np.asarray(self.last.T_cw.R, np.float32),
             np.asarray(self.last.T_cw.t, np.float32), self.imu.v_w,
             self.imu.bg, self.imu.ba, R_bc, t_bc], self.device)
        return inertial.predict_pose_imu(
            R, t, v, bg, ba, Rb, tb, self.imu.pre_last_frame,
            inertial.gravity_vec(self.device))

    # ------------------------------------------------------------------
    def _log_and_return(self, ts) -> np.ndarray:
        """Append the stats and trajectory rows of the current frame (all
        host math) and return T_cw as a 4x4 matrix."""
        self.track_stats.append(
            (ts, self.state, int(self._cur_valid.sum()),
             int((self.cur_match >= 0).sum())))
        R_cw = np.asarray(self.cur_T.R)
        t_cw = np.asarray(self.cur_T.t)
        Rr = self.map.kf_R[self.ref_kf]
        tr = self.map.kf_t[self.ref_kf]
        R_cr = (R_cw @ Rr.T).astype(np.float32)    # T_cr = T_cw ∘ T_rw⁻¹
        t_cr = (t_cw - R_cr @ tr).astype(np.float32)
        self.trajectory.append(
            (ts, self.map.map_id, self.ref_kf,
             int(self.map.kf_epoch[self.ref_kf]), R_cr, t_cr, self.state))
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R_cw
        M[:3, 3] = t_cw
        return M

    def _update_last_frame_pose(self):
        """Re-anchor the last frame's pose on its reference keyframe's
        current map pose (reference: Tracking::UpdateLastFrame,
        Tracking.cc:3247: Tlw = Tlr * Trw). Bundle adjustment moves
        keyframes between frames; the motion-model prediction must start
        from a map-consistent pose. The last trajectory row holds T_lr at
        frame time, so this is host math."""
        if self.last is None or not self.trajectory:
            return
        ts_, mid, rk, ep, R_cr, t_cr, _ = self.trajectory[-1]
        if (mid != self.map.map_id or abs(ts_ - self.last.ts) > 1e-9
                or rk < 0 or not self.map.kf_valid[rk]
                or int(self.map.kf_epoch[rk]) != ep):
            return
        Rr, tr = self.map.kf_R[rk], self.map.kf_t[rk]
        R_lw = (R_cr @ Rr).astype(np.float32)
        t_lw = (R_cr @ tr + t_cr).astype(np.float32)
        self.last = dataclasses.replace(self.last, T_cw=SE3(R_lw, t_lw))

    # ------------------------------------------------------------------
    def _monocular_initialization(self, prep, ts, fid):
        """(reference: Tracking::MonocularInitialization, Tracking.cc:2818)"""
        n_valid = int(prep.feat.valid.sum())
        if self.init_ref is None or n_valid <= self.cfg.min_init_matches:
            if n_valid > self.cfg.min_init_matches:
                self.init_ref = FrameRecord(_identity_np(), None, ts, fid,
                                            prepared=prep)
                if self.imu is not None:
                    self.imu.pre_since_kf = None   # the chain starts here
            return

        f1 = self.init_ref.prepared
        res = matching.search_for_initialization(
            f1.feat._replace(xy=f1.xy_ud), prep.feat._replace(xy=prep.xy_ud))
        valid, idx2 = device_mod.fetch_packed([res.valid, res.idx])
        if int(valid.sum()) < self.cfg.min_init_matches:
            self.init_ref = FrameRecord(_identity_np(), None, ts, fid,
                                        prepared=prep)
            if self.imu is not None:
                self.imu.pre_since_kf = None
            return

        # the minimal sets are drawn from a generator seeded by the frame id
        gen = torch.Generator(device=self.device).manual_seed(fid)
        tv = twoview.reconstruct(f1.xyn, prep.xyn[res.idx.long()], res.valid,
                                 generator=gen, focal=float(self.cam.fx))
        success, good, X, R21, t21 = device_mod.fetch_packed(
            [tv.success, tv.is_good, tv.points3d, tv.R21, tv.t21])
        self.n_init_matches = int(valid.sum())
        self.n_init_good = int(good.sum())
        if not bool(success):
            return
        self._create_initial_map(f1, prep, idx2, good, X, R21, t21, ts, fid)

    def _create_initial_map(self, f1, f2prep, idx2, good, X, R21, t21, ts,
                            fid):
        """(reference: Tracking::CreateInitialMapMonocular, Tracking.cc:2920)"""
        good = good & np.isfinite(X).all(axis=1)
        n_good = int(good.sum())
        if n_good < 50:
            return
        # gauge: median depth -> 1
        med = float(np.median(X[good][:, 2]))
        if med <= 0:
            return
        X = X / med
        t21 = t21 / med

        m = self.map
        N = m.cfg.n_feat
        feat_pt1 = np.full(N, NO_POINT, np.int32)
        feat_pt2 = np.full(N, NO_POINT, np.int32)
        gidx1 = np.where(good)[0]
        pids = m.alloc_points(n_good)
        k1_feat = _frame_to_host(f1)
        k2_feat = _frame_to_host(f2prep)
        m.pt_xyz[pids] = X[gidx1]
        m.pt_desc[pids] = k1_feat["desc"][gidx1]
        m.pt_valid[pids] = True
        feat_pt1[gidx1] = pids
        feat_pt2[idx2[gidx1]] = pids

        def add(R, t, ts_, fid_, f, feat_pt):
            return m.add_keyframe(R, t, ts_, fid_, f["xy_ud"], f["xyn"],
                                  f["level"], f["angle"], f["desc"],
                                  f["valid"], feat_pt)

        k1 = add(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                 self.init_ref.ts, self.init_ref.frame_id, k1_feat, feat_pt1)
        k2 = add(R21, t21, ts, fid, k2_feat, feat_pt2)
        m.pt_ref_kf[pids] = k2
        m.pt_first_kf[pids] = k2
        m.update_point_stats(pids)

        # full BA on the initial two-view map (reference runs
        # GlobalBundleAdjustemnt(20) here)
        run_local_ba(m, [k1, k2], fixed=[k1], cam=self.cam, iters=20)

        # rescale again to median depth 1 after BA
        pvalid = m.pt_valid
        if pvalid.sum() >= 30:
            med = float(np.median(np.linalg.norm(m.pt_xyz[pvalid], axis=-1)))
            if med > 0:
                m.pt_xyz[pvalid] /= med
                m.kf_t[[k1, k2]] /= med
        m.update_point_stats(np.where(pvalid)[0])

        if self.imu is not None and self.imu.pre_since_kf is not None:
            m.set_kf_preintegration(k2, self.imu.pre_since_kf, k1)
            self.imu.pre_since_kf = None
            self.imu.t_first_kf = self.init_ref.ts
        self.ref_kf = k2
        self.last_kf_id = k2
        self.last_kf_frame_id = fid
        self.last_kf_ts = ts
        T2 = SE3(m.kf_R[k2].copy(), m.kf_t[k2].copy())
        self.cur_T = T2
        self.cur_prep = f2prep
        self.cur_match = feat_pt2
        self._cur_angles = k2_feat["angle"]
        self._cur_valid = k2_feat["valid"]
        self.last = FrameRecord(T2, feat_pt2, ts, fid,
                                angles=self._cur_angles, prepared=f2prep)
        self.velocity = None
        self.state = OK
        self.new_keyframes.extend([k1, k2])

    # ------------------------------------------------------------------
    def _stereo_initialization(self, prep, depth, ts, fid):
        """Instant map from one stereo / RGB-D frame: every feature with a
        depth becomes a point of the first keyframe, at the identity pose
        (reference: Tracking::StereoInitialization, Tracking.cc:2678). The
        frame and its depth come down in one packed fetch."""
        f = _frame_to_host(prep, depth)
        good = (f["depth"] > 0) & f["valid"]
        if good.sum() < 300:   # reference requires > 500 keypoints; the
            return             # depth-valid subset here
        m = self.map
        idx = np.where(good)[0]
        z = f["depth"][idx]
        xyn = f["xyn"][idx]
        X = np.stack([xyn[:, 0] * z, xyn[:, 1] * z, z], axis=1).astype(
            np.float32)
        feat_pt = np.full(m.cfg.n_feat, NO_POINT, np.int32)
        pids = m.alloc_points(len(idx))
        m.pt_xyz[pids] = X
        m.pt_desc[pids] = f["desc"][idx]
        m.pt_valid[pids] = True
        feat_pt[idx] = pids
        k = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                           ts, fid, f["xy_ud"], f["xyn"], f["level"],
                           f["angle"], f["desc"], f["valid"], feat_pt)
        m.pt_ref_kf[pids] = k
        m.pt_first_kf[pids] = k
        m.update_point_stats(pids)
        if self.imu is not None:
            self.imu.pre_since_kf = None   # the chain starts at this keyframe
            self.imu.t_first_kf = ts
        self.ref_kf = self.last_kf_id = k
        self.last_kf_frame_id = fid
        self.last_kf_ts = ts
        self.cur_T = _identity_np()
        self.cur_prep = prep
        self.cur_match = feat_pt
        self.cur_depth = f["depth"]
        self._cur_angles = f["angle"]
        self._cur_valid = f["valid"]
        self.last = FrameRecord(_identity_np(), feat_pt, ts, fid,
                                angles=self._cur_angles, prepared=prep)
        self.velocity = None
        self.state = OK
        self.new_keyframes.append(k)

    def _create_depth_points(self, k: int, max_new: int = 100):
        """Close map points from the frame's depth for the features of
        keyframe k that have no point yet, nearest first: every one closer
        than th_depth, and at least max_new (reference: CreateNewKeyFrame's
        stereo / RGB-D point creation, Tracking.cc:3865-3950). A tracked
        frame's depth is on the host: the stage that tracked it fetched
        it."""
        if self.cur_depth is None or self.bf <= 0:
            return
        m = self.map
        depth = self.cur_depth
        free = ((m.kf_feat_point[k] == NO_POINT) & m.kf_feat_valid[k]
                & (depth > 0))
        idx = np.where(free)[0]
        if len(idx) == 0:
            return
        z = depth[idx]
        sel = []
        for i in np.argsort(z):
            if z[i] <= self.th_depth or len(sel) < max_new:
                sel.append(i)
            if len(sel) >= max_new and z[i] > self.th_depth:
                break
        idx = idx[np.asarray(sel, np.int64)]
        z = depth[idx]
        xyn = m.kf_feat_xyn[k][idx]
        Xc = np.stack([xyn[:, 0] * z, xyn[:, 1] * z, z], 1).astype(np.float32)
        R_cw, t_cw = m.kf_R[k], m.kf_t[k]
        Xw = ((Xc - t_cw) @ R_cw).astype(np.float32)   # R_cw^T (Xc - t)
        pids = m.add_points(Xw, m.kf_feat_desc[k][idx], ref_kf=k)
        m.kf_feat_point[k, idx] = pids
        m.update_point_stats(pids)

    # ------------------------------------------------------------------
    def reset_for_new_map(self, new_map: MapStore):
        """Rebind to a fresh, empty map and restart initialisation
        (reference: Tracking::CreateMapInAtlas, Tracking.cc:3093). The frame
        counter and the trajectory log continue."""
        if new_map.device != self.device:
            raise ValueError(f"map lives on {new_map.device}, tracker on "
                             f"{self.device}")
        self.map = new_map
        self.state = NOT_INITIALIZED
        self.velocity = None
        self.last = None
        self.init_ref = None
        self.ref_kf = -1
        self.last_kf_frame_id = self.frame_id
        self.last_kf_id = -1
        self.last_kf_ts = -1e9
        self.lost_count = 0
        self._seed_from_kfs = False
        self._imu_prior = None
        if self.imu is not None:
            self.imu.pre_since_kf = None
            self.imu.pre_last_frame = None
            self.imu.v_w = np.zeros(3, np.float32)

    def on_map_transformed(self, R_wg: np.ndarray, s: float):
        """Re-express the tracker's state after Map::ApplyScaledRotation
        rotated and rescaled the world (reference: Tracking::UpdateFrameIMU,
        Tracking.cc:4769): T_cw' = (R_cw R_wg, s t_cw); the trajectory rows
        of this map scale their t_cr; velocity and biases come from the
        newest keyframe."""
        self._imu_prior = None    # the prior lives in the old world

        def fix(T):
            return SE3((np.asarray(T.R) @ R_wg).astype(np.float32),
                       (s * np.asarray(T.t)).astype(np.float32))
        if self.last is not None:
            self.last = dataclasses.replace(self.last, T_cw=fix(self.last.T_cw))
        if hasattr(self, "cur_T"):
            self.cur_T = fix(self.cur_T)
        if self.velocity is not None:
            self.velocity = SE3(np.asarray(self.velocity.R),
                                (s * np.asarray(self.velocity.t)).astype(
                                    np.float32))
        self.trajectory = [
            (ts_, mid, rk, ep, R_cr,
             (s * t_cr).astype(np.float32) if mid == self.map.map_id
             else t_cr, st)
            for (ts_, mid, rk, ep, R_cr, t_cr, st) in self.trajectory]
        if self.imu is not None:
            chain = self.map.temporal_chain()
            if len(chain):
                kl = int(chain[-1])
                self.imu.v_w = self.map.kf_vel[kl].copy()
                self.imu.bg = self.map.kf_bg[kl].copy()
                self.imu.ba = self.map.kf_ba[kl].copy()

    def _need_new_keyframe(self) -> bool:
        """(reference: Tracking::NeedNewKeyFrame, Tracking.cc:3625; the
        visual branches)"""
        if self.localization_only:
            return False     # mbOnlyTracking (Tracking.cc:3631)
        n_tracked = int((self.cur_match >= 0).sum())
        if self.imu is not None:
            # IMU: a time cadence keeps the preintegration chain dense
            # (reference: >= 0.25 s, Tracking.cc:3700-3710)
            return (self.cur_ts - self.last_kf_ts >= self.min_kf_dt
                    and n_tracked > 15)
        # only reference points with >= minObs observers count: 3, or 2
        # while the map has <= 2 keyframes (Tracking.cc:3659)
        min_obs = 3 if self.map.n_kf > 2 else 2
        # c2 is anchored on the strongest keyframe of the local window, not
        # only the (possibly brand-new) reference keyframe, whose count
        # shrinks in lockstep with the frame's; the anchor count changes
        # only with the map, so it is cached per (ref, map, version)
        key = (self.ref_kf, id(self.map), self.map.version, min_obs)
        if getattr(self, "_ref_tracked_key", None) == key:
            ref_tracked = self._ref_tracked
        else:
            obs = self.map.observation_counts()
            covis_ids, _ = self.map.covisibility(self.ref_kf, min_weight=15)
            ref_tracked = 0
            for a in [self.ref_kf] + [int(x) for x in covis_ids[:5]]:
                if a < 0 or not self.map.kf_valid[a]:
                    continue
                pts = self.map.kf_feat_point[a]
                pts = pts[pts >= 0]
                ref_tracked = max(ref_tracked,
                                  int((obs[pts] >= min_obs).sum()))
            self._ref_tracked_key = key
            self._ref_tracked = ref_tracked
        # stereo / RGB-D close-point pressure: few close points tracked but
        # many close features untracked -> densify the near field
        # (reference: bNeedToInsertClose, Tracking.cc:3674-3695)
        need_close = False
        if self.cur_depth is not None and self.bf > 0:
            close = ((self.cur_depth > 0) & (self.cur_depth < self.th_depth)
                     & self._cur_valid)
            need_close = (int((close & (self.cur_match >= 0)).sum()) < 100
                          and int((close & (self.cur_match < 0)).sum()) > 70)
        c1a = self.frame_id >= self.last_kf_frame_id + self.cfg.max_frames
        c1b = self.frame_id >= self.last_kf_frame_id + self.cfg.min_frames + 1
        # c1c (stereo / RGB-D only): tracking fell to a quarter of the anchor
        # or close points are needed (reference: Tracking.cc:3711)
        c1c = (self.sensor != SENSOR_MONO
               and (n_tracked < 0.25 * ref_tracked or need_close))
        c2 = ((n_tracked < self.cfg.ref_ratio * ref_tracked or need_close)
              and n_tracked > 15)
        # periodic floor: after max_frames without a keyframe, insert even
        # if tracking has not decayed (the JAX package's deviation from the
        # reference's pure-c2 gate; keyframe culling removes the excess)
        periodic = self.cfg.periodic_kf and c1a and n_tracked > 15
        return ((c1a or c1b or c1c) and c2) or periodic

    def _create_new_keyframe(self, ts, fid):
        """(reference: Tracking::CreateNewKeyFrame, Tracking.cc:3826): the
        frame's features come down in one packed fetch."""
        f = _frame_to_host(self.cur_prep)
        k = self.map.add_keyframe(
            np.asarray(self.cur_T.R), np.asarray(self.cur_T.t), ts, fid,
            f["xy_ud"], f["xyn"], f["level"], f["angle"], f["desc"],
            f["valid"], self.cur_match.astype(np.int32))
        if (self.imu is not None and self.imu.pre_since_kf is not None
                and self.last_kf_id >= 0):
            self.map.set_kf_preintegration(k, self.imu.pre_since_kf,
                                           self.last_kf_id)
            self.map.kf_vel[k] = self.imu.v_w
            self.map.kf_bg[k] = self.imu.bg
            self.map.kf_ba[k] = self.imu.ba
            self.imu.pre_since_kf = None
        self.ref_kf = k
        self.last_kf_frame_id = fid
        self.last_kf_id = k
        self.last_kf_ts = ts
        self._create_depth_points(k)
        self.new_keyframes.append(k)

    # ------------------------------------------------------------------
    def _pose_to_device(self, T: SE3) -> SE3:
        """A host pose as device tensors, in one upload."""
        p = device_mod.to_device(np.concatenate(
            [np.asarray(T.R, np.float32).reshape(-1),
             np.asarray(T.t, np.float32)]), self.device)
        return SE3(p[:9].reshape(3, 3), p[9:12])

    def _candidate_points(self, pt_ids: np.ndarray, T_pred: SE3):
        """Pad the candidate point set and project it on the device. The
        map arrays live on the device (cached per map version): only the id
        list and the pose are uploaded."""
        cap = self.cfg.local_pts_cap
        pt_ids = pt_ids[:cap]
        ids = np.concatenate([pt_ids,
                              np.full(cap - len(pt_ids), -1, np.int64)])
        ids_d = device_mod.to_device(ids.astype(np.int32), self.device)
        dp = self.map.device_points()
        proj = kernels.gather_and_project(
            T_pred, ids_d, dp["xyz"], dp["normal"], dp["min_dist"],
            dp["max_dist"], dp["valid"], self.cam, self.orb_cfg.scale,
            self.orb_cfg.n_levels, pt_proj8=dp["proj8"])
        return ids, ids_d, proj

    def _run_track(self, prep, T_pred: SE3, ids_d, proj, radius_per_level,
                   prior=None, proj_angle=None) -> kernels.TrackResult:
        """Projection search + pose optimization of one stage. T_pred,
        ids_d and radius_per_level live on the device; prior [N] (host)
        holds the assignments to keep."""
        N = self.map.cfg.n_feat
        prior_d = (torch.full((N,), -1, dtype=torch.int32, device=self.device)
                   if prior is None else device_mod.to_device(
                       np.asarray(prior, np.int32), self.device))
        dp = self.map.device_points()
        return kernels.match_and_optimize(
            T_pred, prep, ids_d, proj, dp["desc"], dp["xyz"],
            radius_per_level, self._inv_sigma2_dev, prior_d, self.cam,
            proj_angle=proj_angle)

    def _track_steady_fused(self, prep: kernels.PreparedFrame, ts, fid,
                            use_imu: bool = False,
                            seed_from_kfs: bool = False) -> str:
        """Motion-model tracking, local-keyframe selection and local-map
        tracking as one step (``kernels.track_step_visual``, or an inertial
        form of it) plus one packed fetch. use_imu: the prediction is the
        IMU's dead reckoning (reference: PredictStateIMU, Tracking.cc:1892).
        Returns "ok", "fail1" (motion-model short) or "fail2" (local-map
        short)."""
        # the host's inputs: the seed walk, the candidate ids and angles,
        # the packed upload and the map's device view
        with timing.span("track inputs"):
            m = self.map
            cap = m.cfg.n_feat
            ang_of_pt = np.zeros(m.pt_valid.shape[0], np.float32)
            if seed_from_kfs:
                # walk the keyframe chain back from the newest, collecting
                # observed points (tracking.py:734-754 of the JAX package)
                pts_l, k, hops, n_got = [], self.last_kf_id, 0, 0
                while k >= 0 and m.kf_valid[k] and hops < 64 and n_got < cap:
                    fp = m.kf_feat_point[k]
                    s = fp >= 0
                    if s.any():
                        pts_l.append(fp[s])
                        ang_of_pt[fp[s]] = m.kf_feat_angle[k][s]
                        n_got += int(s.sum())
                    k = int(m.kf_prev[k])
                    hops += 1
                last_pts = (np.unique(np.concatenate(pts_l)) if pts_l
                            else np.zeros(0, np.int64))
            else:
                lm = self.last.match_pt
                last_pts = np.unique(lm[lm >= 0])
            last_pts = last_pts[m.pt_valid[last_pts]]
            if len(last_pts) < 10:
                return "fail1"
            last_pts = last_pts[:cap]
            ids1 = np.full(cap, -1, np.int32)
            ids1[:len(last_pts)] = last_pts
            safe1 = np.where(ids1 >= 0, ids1, 0)
            if not seed_from_kfs:
                # rotation-consistency reference angles (ORBmatcher.cc:1950)
                sel = lm >= 0
                last_ang = (self.last.angles if self.last.angles is not None
                            else device_mod.to_device(
                                self.last.prepared.feat.angle, "cpu").numpy())
                ang_of_pt[lm[sel]] = last_ang[sel]
            # both radii widened after seeding; the local map's alone for the
            # 2 frames after a relocalisation (Tracking.cc:4039-4062)
            radius1, radius2 = self._radii_dev[
                (3.0, 3.0) if seed_from_kfs else
                (1.0, 3.0) if self.frame_id <= self.last_reloc_fid + 2 else
                (1.0, 1.0)]
            # the eligibility of the inertial refine, and its anchor: the last
            # frame under the running prior while the map is unchanged since,
            # else the last keyframe (Tracking.cc:3502-3528)
            refine = (self.imu is not None and m.imu_initialized
                      and self.imu.pre_since_kf is not None
                      and self.last_kf_id >= 0 and m.kf_valid[self.last_kf_id])
            use_lf = (refine and self._imu_prior is not None
                      and self._imu_prior_key == (id(m), m.version,
                                                  self.last.frame_id)
                      and self.imu.pre_last_frame is not None)
            # the frame's small inputs in ONE upload: the pose (or the IMU's
            # last state), stage-1 angles and ids, and the refine's anchor
            ups = [ang_of_pt[safe1], ids1]
            if use_imu:
                R_bc, t_bc = inertial.extrinsic(self.imu.calib)
                ups += [np.asarray(self.last.T_cw.R, np.float32),
                        np.asarray(self.last.T_cw.t, np.float32),
                        self.imu.v_w, self.imu.bg, self.imu.ba, R_bc, t_bc]
            else:
                T_pred = _compose_np(self.velocity, self.last.T_cw)
                ups += [T_pred.R, T_pred.t]
            if refine:
                R_bc, t_bc = inertial.extrinsic(self.imu.calib)
                k = self.last_kf_id
                R_wb_a, p_a = inertial.body_from_camera(m.kf_R[k], m.kf_t[k],
                                                        R_bc, t_bc)
                ups += [np.ascontiguousarray(R_bc.T), -R_bc.T @ t_bc,
                        self.imu.v_w, R_wb_a, p_a, m.kf_vel[k], m.kf_bg[k],
                        m.kf_ba[k]]
            up = device_mod.upload_packed(
                [np.asarray(a, np.float32) if a.dtype != np.int32 else a
                 for a in ups], self.device)
            ang1, ids1_d = up[0], up[1]
            if use_imu:
                T_pred_d, v_pred = inertial.predict_pose_imu(
                    *up[2:9], self.imu.pre_last_frame,
                    inertial.gravity_vec(self.device))
                self._v_pred, self._v_pred_fid = v_pred, fid
                rest = up[9:]
            else:
                T_pred_d = SE3(up[2], up[3])
                rest = up[4:]

            dp = m.device_points()
            ko = m.device_kf_obs()
        args = (T_pred_d, prep, ids1_d, ang1,
                dp["xyz"], dp["desc"], dp["normal"], dp["min_dist"],
                dp["max_dist"], dp["valid"],
                ko["feat_point"], ko["valid"], ko["covis"], ko["point_bits"],
                radius1, radius2, self._inv_sigma2_dev)
        statics = dict(cam=self.cam, scale=self.orb_cfg.scale,
                       n_levels=self.orb_cfg.n_levels,
                       local_cap=self.cfg.local_pts_cap,
                       pt_proj8=dp["proj8"])
        if refine:
            R_cb, t_cb, v0, R_wb_a, p_a, v_a, bg_a, ba_a = rest
            g = inertial.gravity_vec(self.device)
            if use_lf:
                res = kernels.track_step_inertial_lf(
                    *args, v0, self._imu_prior, self.imu.pre_last_frame, g,
                    R_cb, t_cb, **statics)
                self.n_inertial_steps["lf"] += 1
            else:
                res = kernels.track_step_inertial_anchor(
                    *args, v0, R_wb_a, p_a, v_a, bg_a, ba_a,
                    self.imu.pre_since_kf, g, R_cb, t_cb, **statics)
                self.n_inertial_steps["anchor"] += 1
        else:
            res = kernels.track_step_visual(*args, **statics)
        self.n_steps += 1
        # the single packed transfer of the whole frame, the refine's
        # leaves and the frame's depth with it (the prior stays on the
        # device)
        leaves = list(res)[:9]
        if refine:
            leaves += [res.ni, res.inl_i, res.v_w, res.Ri_cw, res.ti_cw]
        got = device_mod.fetch_packed(leaves + self._device_depth())
        (n1, ref_kf, match, R_cw, t_cw, ids2, visible2, cur_ang,
         cur_valid) = got[:9]
        if len(got) > len(leaves):
            self.cur_depth = got[-1]
        n1, ref_kf = int(n1), int(ref_kf)
        self.cur_prep = prep
        self._cur_angles = cur_ang
        self._cur_valid = cur_valid
        self.n_candidates2 = int((ids2 >= 0).sum())
        min1 = 11 if seed_from_kfs else self.cfg.min_inliers_mm
        if n1 < min1:
            return "fail1"
        self.ref_kf = ref_kf
        vis_ids = ids2[visible2 & (ids2 >= 0)]
        m.pt_visible[vis_ids] += 1
        self.cur_T = SE3(R_cw, t_cw)
        self.cur_match = match
        min2 = 11 if seed_from_kfs else self.cfg.min_inliers_local
        if int((self.cur_match >= 0).sum()) < min2:
            return "fail2"
        if refine:
            ni, inl_i, v_w, Ri_cw, ti_cw = got[9:14]
            self._accept_refine(int(ni), inl_i, v_w, Ri_cw, ti_cw, match,
                                res.prior)
        return "ok"

    def _accept_refine(self, ni, inl, v_w, R_cw, t_cw, match, prior):
        """Take the visual-inertial refine unless it kept too few inliers
        (then the visual solution stays); its prior serves the next frame
        only, while the map stays unchanged."""
        if ni < self.cfg.min_inliers_local:
            self._imu_prior = None
            return
        self._imu_prior = prior
        self._imu_prior_key = (id(self.map), self.map.version,
                               self.frame_id - 1)
        self.cur_T = SE3(R_cw, t_cw)
        self.imu.v_w = np.asarray(v_w, np.float32)
        self.cur_match = np.where(inl, match, -1).astype(np.int32)

    # ------------------------------------------------------------------
    def _track_reference_keyframe(self, prep, ts, fid) -> bool:
        """(reference: Tracking::TrackReferenceKeyFrame, Tracking.cc:3171;
        BoW-bucketed matching replaced by dense nearest-neighbour matching,
        two ``hamming_best2`` searches for the mutual check)"""
        m = self.map
        if self.ref_kf < 0:
            return False
        if not m.kf_valid[self.ref_kf]:
            # reference was culled: fall back to the newest valid keyframe
            ids = m.kf_ids()
            if len(ids) == 0:
                return False
            self.ref_kf = int(ids[np.argmax(m.kf_frame_id[ids])])
        k = self.ref_kf
        # the keyframe's descriptors, angles and mask in one upload
        has_pt = m.kf_feat_valid[k] & (m.kf_feat_point[k] >= 0)
        kf_d = device_mod.to_device(np.concatenate(
            [m.kf_feat_desc[k].reshape(-1),
             m.kf_feat_angle[k].view(np.int32),
             has_pt.astype(np.int32)]), self.device)
        N = m.cfg.n_feat
        kf_desc = kf_d[:8 * N].reshape(N, 8)
        kf_angle = kf_d[8 * N:9 * N].view(torch.float32)
        res = matching.match_nn(
            prep.feat.desc, prep.feat.valid, kf_desc, kf_d[9 * N:] > 0,
            max_dist=matching.TH_LOW, ratio=0.7, mutual=True)
        self.n_ref_kf_searches += 1
        # orientation-consistency gate (reference: the mbCheckOrientation
        # pass of SearchByBoW, ORBmatcher.cc:259,404-424)
        dang = kf_angle[res.idx.long()] - prep.feat.angle
        valid, idx = device_mod.fetch_packed(
            [matching.rotation_consistency_mask(dang, res.valid), res.idx])
        kf_pt = m.kf_feat_point[k][idx]
        match = np.where(valid & (kf_pt >= 0), kf_pt, -1).astype(np.int32)
        if (match >= 0).sum() < 15:
            return False
        T0 = self.last.T_cw if self.last is not None else _identity_np()
        has = match >= 0
        safe = np.where(has, match, 0)
        # matched points, mask and start pose in one upload
        up = device_mod.to_device(np.concatenate(
            [m.pt_xyz[safe].reshape(-1), has.astype(np.float32),
             np.asarray(T0.R, np.float32).reshape(-1),
             np.asarray(T0.t, np.float32)]), self.device)
        X = up[:3 * N].reshape(N, 3)
        has_d = up[3 * N:4 * N] > 0
        T0_d = SE3(up[4 * N:4 * N + 9].reshape(3, 3), up[4 * N + 9:])
        w = self._inv_sigma2_dev[prep.feat.level.long()]
        with timing.span("pose GN"):
            opt = pose_opt.pose_optimization(T0_d, X, prep.xy_ud, w,
                                             has_d & prep.feat.valid, self.cam)
        n_in, inl, R_cw, t_cw = device_mod.fetch_packed(
            [opt.n_inliers, opt.inlier, opt.T_cw.R, opt.T_cw.t])
        if int(n_in) < self.cfg.min_inliers_mm:
            return False
        self.cur_T = SE3(R_cw, t_cw)
        self.cur_prep = prep
        self.cur_match = np.where(inl, match, -1).astype(np.int32)
        return True

    def _track_local_map(self) -> bool:
        """(reference: Tracking::TrackLocalMap, Tracking.cc:3474). Runs on
        the frames that did not take the fused step; local keyframes are
        selected on the host."""
        m = self.map
        cur_pts = self.cur_match[self.cur_match >= 0]
        if len(cur_pts) == 0:
            return False
        # local keyframes: observers of current points + their covisibles
        obs_counts = m.incidence()[:, cur_pts].sum(axis=1)
        kf_order = np.argsort(-obs_counts)
        local_kfs = [k for k in kf_order[:10] if obs_counts[k] > 0]
        if not local_kfs:
            return False
        self.ref_kf = int(local_kfs[0])
        covis = m.covisibility_matrix()
        extra = set()
        for k in local_kfs:
            nb = np.argsort(-covis[k])
            extra.update(int(x) for x in nb[:10] if covis[k, x] >= 15)
        local_kfs = list(dict.fromkeys(list(local_kfs) + sorted(extra)))
        pt_ids = m.local_point_ids(np.asarray(local_kfs))
        T_d = self._pose_to_device(self.cur_T)
        ids, ids_d, proj = self._candidate_points(pt_ids, T_d)
        # widened 3x for the 2 frames after a relocalisation, and to the
        # motion-model radius while re-acquiring from RECENTLY_LOST
        # (reference: Tracking.cc:4039-4062)
        if self.frame_id <= self.last_reloc_fid + 2:
            radius = self._radii_dev[(1.0, 3.0)][1]
        elif (self.state == RECENTLY_LOST
              and self.cfg.motion_radius > self.cfg.local_radius):
            radius = self._radii_dev[(1.0, 1.0)][0]
        else:
            radius = self._radii_dev[(1.0, 1.0)][1]
        res = self._run_track(self.cur_prep, T_d, ids_d, proj, radius,
                              prior=self.cur_match)
        self.n_local_map_searches += 1
        # one packed transfer for the whole stage, the frame's depth with it
        (match, R_cw, t_cw, visible, cur_ang, cur_valid,
         *depth) = device_mod.fetch_packed(
            [res.match_pt, res.T_cw_R, res.T_cw_t, proj.visible,
             self.cur_prep.feat.angle, self.cur_prep.feat.valid]
            + self._device_depth())
        if depth:
            self.cur_depth = depth[0]
        m.pt_visible[ids[visible & (ids >= 0)]] += 1
        self._cur_angles = cur_ang
        self._cur_valid = cur_valid
        if int((match >= 0).sum()) < self.cfg.min_inliers_local:
            return False
        self.cur_T = SE3(R_cw, t_cw)
        self.cur_match = match
        self._pose_inertial_refine()
        return True

    def _pose_inertial_refine(self):
        """After the visual local-map stage outside the fused step,
        re-optimise the frame's nav state with the preintegrated edge
        (reference: TrackLocalMap's PoseInertialOptimization*,
        Tracking.cc:3502-3528): under the running prior while the map is
        unchanged since the last frame, else anchored on the last
        keyframe, seeding a new prior."""
        m = self.map
        if (self.imu is None or not m.imu_initialized
                or self.imu.pre_since_kf is None or self.last_kf_id < 0
                or not m.kf_valid[self.last_kf_id]):
            return
        k = self.last_kf_id
        R_bc, t_bc = inertial.extrinsic(self.imu.calib)
        R_wb_a, p_a = inertial.body_from_camera(m.kf_R[k], m.kf_t[k], R_bc,
                                                t_bc)
        match = self.cur_match
        has = match >= 0
        prep = self.cur_prep
        (safe, has_d, R_cw0, t_cw0, v0, R_cb, t_cb, Ra, pa, va, bga,
         baa) = device_mod.upload_packed(
            [np.where(has, match, 0).astype(np.int32), has,
             np.asarray(self.cur_T.R, np.float32),
             np.asarray(self.cur_T.t, np.float32), self.imu.v_w,
             np.ascontiguousarray(R_bc.T), (-R_bc.T @ t_bc), R_wb_a, p_a,
             m.kf_vel[k], m.kf_bg[k], m.kf_ba[k]], self.device)
        X = m.device_points()["xyz"][safe.long()]
        w = self._inv_sigma2_dev[prep.feat.level.long()]
        vmask = has_d & prep.feat.valid
        g = inertial.gravity_vec(self.device)
        T0 = SE3(R_cw0, t_cw0)
        use_lf = (self._imu_prior is not None
                  and self._imu_prior_key == (
                      id(m), m.version,
                      self.last.frame_id if self.last is not None else -1)
                  and self.imu.pre_last_frame is not None)
        with timing.span("pose GN"):
            if use_lf:
                res = pose_opt.pose_inertial_optimization_last_frame(
                    T0, v0, self._imu_prior, self.imu.pre_last_frame, X,
                    prep.xy_ud, w, vmask, self.cam, g, R_cb=R_cb, t_cb=t_cb)
                prior = res.prior
            else:
                res = pose_opt.pose_inertial_optimization(
                    T0, v0, Ra, pa, va, bga, baa, self.imu.pre_since_kf, X,
                    prep.xy_ud, w, vmask, self.cam, g, R_cb=R_cb, t_cb=t_cb)
                prior = pose_opt.build_frame_prior(
                    res.T_cw, res.v_w, bga, baa, Ra, pa, va,
                    self.imu.pre_since_kf, X, prep.xy_ud, w, res.inlier,
                    self.cam, g, R_cb=R_cb, t_cb=t_cb)
        n2, inl, v_w, R_cw, t_cw = device_mod.fetch_packed(
            [res.n_inliers, res.inlier, res.v_w, res.T_cw.R, res.T_cw.t])
        self._accept_refine(int(n2), inl, v_w, R_cw, t_cw, match, prior)

    def _relocalization(self, prep, fid) -> bool:
        """(reference: Tracking::Relocalization, Tracking.cc:4324): the
        System's candidates and PnP pose, optimised once more here over the
        matched points; accepted at >= 15 inliers."""
        out = self.relocalizer(prep)
        if out is None:
            return False
        R, t, match_pt, ref = out
        has = match_pt >= 0
        X, has_d, R_d, t_d = device_mod.upload_packed(
            [self.map.pt_xyz[np.where(has, match_pt, 0)], has,
             np.asarray(R, np.float32), np.asarray(t, np.float32)],
            self.device)
        w = self._inv_sigma2_dev[prep.feat.level.long()]
        with timing.span("pose GN"):
            opt = pose_opt.pose_optimization(SE3(R_d, t_d), X, prep.xy_ud, w,
                                             has_d & prep.feat.valid, self.cam)
        n_in, inl, R_cw, t_cw = device_mod.fetch_packed(
            [opt.n_inliers, opt.inlier, opt.T_cw.R, opt.T_cw.t])
        if int(n_in) < 15:
            return False
        self.cur_T = SE3(R_cw, t_cw)
        self.cur_prep = prep
        self.cur_match = np.where(inl, match_pt, -1).astype(np.int32)
        self.ref_kf = int(ref)
        self.n_relocalizations += 1
        self.last_reloc_fid = fid
        return True

    def _track_visual_odometry(self, prep) -> bool:
        """Localisation-mode rescue: match the last frame's depth-backed
        features against this frame and optimise the pose on their
        back-projections (reference: the mbVO branch, Tracking.cc:2279-2360,
        and UpdateLastFrame's temporal points, Tracking.cc:3270-3340).
        Stereo / RGB-D only (it needs per-feature depth)."""
        last = self.last
        if (last is None or last.depth is None or last.prepared is None):
            return False
        lp = last.prepared
        lvalid, xyn = device_mod.fetch_packed([lp.feat.valid, lp.xyn])
        depth = np.asarray(last.depth)
        lvalid = lvalid & (depth > 0)
        if lvalid.sum() < 40:
            return False
        res = matching.match_nn(
            lp.feat.desc, device_mod.to_device(lvalid, self.device),
            prep.feat.desc, prep.feat.valid, max_dist=matching.TH_HIGH,
            ratio=0.9, mutual=True)
        self.n_vo_searches += 1
        # one packed transfer, the frame's depth with it (the next frame's
        # odometry reads it on the host)
        (valid, idx, xy_ud, cur_ang, cur_valid,
         *cur_depth) = device_mod.fetch_packed(
            [res.valid, res.idx, prep.xy_ud, prep.feat.angle,
             prep.feat.valid] + self._device_depth())
        if cur_depth:
            self.cur_depth = cur_depth[0]
        if valid.sum() < 20:
            return False
        z = np.where(lvalid, depth, 1.0).astype(np.float32)
        Xc = np.stack([xyn[:, 0] * z, xyn[:, 1] * z, z], 1)
        R_lw, t_lw = np.asarray(last.T_cw.R), np.asarray(last.T_cw.t)
        Xw = ((Xc - t_lw) @ R_lw).astype(np.float32)
        uv = xy_ud[np.where(valid, idx, 0)]
        T0 = (_compose_np(self.velocity, last.T_cw)
              if self.velocity is not None else last.T_cw)
        Xw_d, uv_d, v_d, R0, t0 = device_mod.upload_packed(
            [Xw, uv, valid, np.asarray(T0.R, np.float32),
             np.asarray(T0.t, np.float32)], self.device)
        with timing.span("pose GN"):
            out = pose_opt.pose_optimization(
                SE3(R0, t0), Xw_d, uv_d, torch.ones_like(Xw_d[:, 0]), v_d,
                self.cam)
        n_inl, R_n, t_n = device_mod.fetch_packed(
            [out.n_inliers, out.T_cw.R, out.T_cw.t])
        if int(n_inl) < 20 or not np.isfinite(t_n).all():
            return False
        self.cur_T = SE3(R_n, t_n)
        self.cur_prep = prep
        self.cur_match = np.full(valid.shape[0], -1, np.int32)
        self._cur_angles = cur_ang
        self._cur_valid = cur_valid
        return True

    def _device_depth(self) -> list:
        """[cur_depth] while the frame's depth is still on the device, for
        the next packed fetch to carry; [] otherwise."""
        return [self.cur_depth] if torch.is_tensor(self.cur_depth) else []

    def _update_found_counters(self):
        pts = self.cur_match[self.cur_match >= 0]
        self.map.pt_found[pts] += 1


def _frame_to_host(prep: kernels.PreparedFrame, depth=None) -> dict:
    """A frame's keyframe fields (and its depth, if given) as numpy arrays,
    in one transfer."""
    f = prep.feat
    names = ("xy_ud", "xyn", "level", "angle", "desc", "valid", "depth")
    parts = [prep.xy_ud, prep.xyn, f.level, f.angle, f.desc, f.valid]
    return dict(zip(names, device_mod.fetch_packed(
        parts + ([] if depth is None else [depth]))))
