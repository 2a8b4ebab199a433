"""Tracking: the steady visual path of the per-frame front end.

Counterpart of ``pipeline/tracking.py`` of the JAX package, steady-state
monocular tracking only (reference: Tracking::Track, src/Tracking.cc:1971):
``track_monocular`` extracts the frame (``kernels.prepare_frame``), runs the
fused motion-model + local-map step (``kernels.track_step_visual``) and
updates the constant-velocity motion model. Initialisation, relocalisation
and keyframe insertion belong to later slices: a tracker starts from a map
built elsewhere (``start_from_map``), and a frame that fails either stage
returns None.

Per frame the host makes three copies: the image up, the small inputs
(predicted pose, stage-1 candidate ids and angles) up as one packed
buffer, and every result down as one packed buffer. Constant tables live
on the device from their first use, and the pose optimizer runs without a
host sync (``optim/pose_opt.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..lie import SE3
from ..mapping.mapstore import MapStore
from ..models import cameras
from ..ops import extractor
from . import kernels

NO_IMAGES_YET = 0
OK = 2
RECENTLY_LOST = 3
LOST = 4


@dataclass
class TrackingConfig:
    n_features: int = 1024
    motion_radius: float = 15.0   # px search radius, motion model (mono)
    local_radius: float = 4.0     # px search radius, local map
    local_pts_cap: int = 4096     # padded local point set size
    min_inliers_mm: int = 20
    min_inliers_local: int = 30
    recently_lost_frames: int = 100


@dataclass
class FrameRecord:
    """Host-side record of the last tracked frame."""
    T_cw: SE3               # numpy R [3, 3], t [3]
    match_pt: np.ndarray    # [N] map point per feature (-1 = none)
    ts: float
    frame_id: int
    angles: Optional[np.ndarray] = None   # [N] keypoint angles


def _compose_np(A: SE3, B: SE3) -> SE3:
    """A ∘ B on the host."""
    Ra, ta = np.asarray(A.R), np.asarray(A.t)
    Rb, tb = np.asarray(B.R), np.asarray(B.t)
    return SE3((Ra @ Rb).astype(np.float32), (Ra @ tb + ta).astype(np.float32))


def _inverse_np(A: SE3) -> SE3:
    Rt = np.asarray(A.R).T
    return SE3(Rt.astype(np.float32),
               (-Rt @ np.asarray(A.t)).astype(np.float32))


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of a tensor's bits (float32 / int32 / bool)."""
    t = t.reshape(-1)
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    return t.to(torch.int32)


class Tracker:
    def __init__(self, cam: cameras.CameraParams, mapstore: MapStore,
                 cfg: TrackingConfig = TrackingConfig(),
                 orb_cfg: Optional[extractor.OrbConfig] = None,
                 device=None):
        self.device = device_mod.resolve(device)
        if mapstore.device != self.device:
            raise ValueError(f"map lives on {mapstore.device}, tracker on "
                             f"{self.device}")
        self.cam = cam
        self.map = mapstore
        self.cfg = cfg
        self.orb_cfg = orb_cfg or extractor.OrbConfig(n_features=cfg.n_features)
        self.state = NO_IMAGES_YET
        self.velocity: Optional[SE3] = None
        self.last: Optional[FrameRecord] = None
        self.ref_kf = -1
        self.last_kf_id = -1
        self.frame_id = 0
        self.lost_count = 0
        self.n_steps = 0                 # fused steps dispatched
        self.n_candidates2 = 0           # stage-2 candidates of the last step
        self._seed_from_kfs = False
        self.radius_scale, self.inv_sigma2 = kernels.level_weights(
            self.orb_cfg.n_levels, self.orb_cfg.scale)
        self._inv_sigma2_dev = torch.from_numpy(self.inv_sigma2).to(self.device)
        # stage-1 / stage-2 search radii per level, at the normal and the
        # widened (first frame after seeding) scale, uploaded once
        self._radii_dev = {
            widen: tuple(torch.from_numpy(
                (widen * r * self.radius_scale).astype(np.float32)).to(
                    self.device)
                for r in (cfg.motion_radius, cfg.local_radius))
            for widen in (1.0, 3.0)}

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
        self.velocity = velocity or SE3(np.eye(3, dtype=np.float32),
                                        np.zeros(3, np.float32))
        self.last_kf_id = self.ref_kf = int(last_kf_id)
        self.state = OK
        self._seed_from_kfs = True

    # ------------------------------------------------------------------
    def track_monocular(self, img, ts: float) -> Optional[np.ndarray]:
        """Process one grayscale frame [H, W] (numpy or tensor, 0..255);
        returns T_cw 4x4 or None if the frame was not tracked."""
        img = torch.as_tensor(np.asarray(img, np.float32) if isinstance(
            img, np.ndarray) else img).to(self.device, torch.float32)
        prep = kernels.prepare_frame(img, self.cam, self.orb_cfg)
        fid = self.frame_id
        self.frame_id += 1
        if self.state != OK or self.velocity is None or self.last is None:
            return None
        seed = self._seed_from_kfs
        self._seed_from_kfs = False
        r = self._track_steady_fused(prep, ts, fid, seed_from_kfs=seed)
        if r != "ok":
            self.lost_count += 1
            self.state = (RECENTLY_LOST
                          if self.lost_count <= self.cfg.recently_lost_frames
                          else LOST)
            self.velocity = None
            return None
        self.lost_count = 0
        # velocity update (reference: Tracking.cc:2512-2520)
        self.velocity = _compose_np(self.cur_T, _inverse_np(self.last.T_cw))
        pts = self.cur_match[self.cur_match >= 0]
        self.map.pt_found[pts] += 1
        self.last = FrameRecord(self.cur_T, self.cur_match, ts, fid,
                                angles=self._cur_angles)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = self.cur_T.R
        M[:3, 3] = self.cur_T.t
        return M

    # ------------------------------------------------------------------
    def _track_steady_fused(self, prep: kernels.PreparedFrame, ts, fid,
                            seed_from_kfs: bool = False) -> str:
        """Motion-model tracking, local-keyframe selection and local-map
        tracking as one step (``kernels.track_step_visual``) plus one packed
        fetch. Returns "ok", "fail1" (motion-model short) or "fail2"
        (local-map short)."""
        T_pred = _compose_np(self.velocity, self.last.T_cw)
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
            last_pts = np.unique(self.last.match_pt[self.last.match_pt >= 0])
        last_pts = last_pts[m.pt_valid[last_pts]]
        if len(last_pts) < 10:
            return "fail1"
        last_pts = last_pts[:cap]
        ids1 = np.full(cap, -1, np.int32)
        ids1[:len(last_pts)] = last_pts
        safe1 = np.where(ids1 >= 0, ids1, 0)
        if not seed_from_kfs:
            # rotation-consistency reference angles (ORBmatcher.cc:1950)
            lm = self.last.match_pt
            sel = lm >= 0
            ang_of_pt[lm[sel]] = self.last.angles[sel]
        radius1, radius2 = self._radii_dev[3.0 if seed_from_kfs else 1.0]
        # the frame's small inputs in ONE upload: pose, stage-1 angles, and
        # the stage-1 ids as int32 bits carried in float32 words
        packed = torch.from_numpy(np.concatenate([
            T_pred.R.reshape(-1), T_pred.t, ang_of_pt[safe1],
            ids1.view(np.float32)])).to(self.device)
        T_pred_d = SE3(packed[:9].reshape(3, 3), packed[9:12])
        ang1 = packed[12:12 + cap]
        ids1_d = packed[12 + cap:].view(torch.int32)

        dp = m.device_points()
        ko = m.device_kf_obs()
        res = kernels.track_step_visual(
            T_pred_d, prep, ids1_d, ang1,
            dp["xyz"], dp["desc"], dp["normal"], dp["min_dist"],
            dp["max_dist"], dp["valid"],
            ko["feat_point"], ko["valid"], ko["covis"], ko["point_bits"],
            radius1, radius2,
            self._inv_sigma2_dev, self.cam, scale=self.orb_cfg.scale,
            n_levels=self.orb_cfg.n_levels, local_cap=self.cfg.local_pts_cap,
            pt_proj8=dp["proj8"])
        self.n_steps += 1
        # the single packed transfer of the whole frame
        parts = [res.n1, res.ref_kf, res.match_pt, res.T_cw_R, res.T_cw_t,
                 res.ids2, res.visible2, res.angle, res.valid]
        sizes = [p.numel() for p in parts]
        flat = torch.cat([_as_i32(p) for p in parts]).cpu().numpy()
        (n1, ref_kf, match, R_bits, t_bits, ids2, visible2, ang_bits,
         _) = np.split(flat, np.cumsum(sizes)[:-1])
        n1, ref_kf = int(n1[0]), int(ref_kf[0])
        self._cur_angles = ang_bits.view(np.float32)
        self.n_candidates2 = int((ids2 >= 0).sum())
        min1 = 11 if seed_from_kfs else self.cfg.min_inliers_mm
        if n1 < min1:
            return "fail1"
        self.ref_kf = ref_kf
        vis_ids = ids2[(visible2 > 0) & (ids2 >= 0)]
        m.pt_visible[vis_ids] += 1
        self.cur_T = SE3(R_bits.view(np.float32).reshape(3, 3).copy(),
                         t_bits.view(np.float32).copy())
        self.cur_match = match.astype(np.int32)
        min2 = 11 if seed_from_kfs else self.cfg.min_inliers_local
        if int((self.cur_match >= 0).sum()) < min2:
            return "fail2"
        return "ok"
