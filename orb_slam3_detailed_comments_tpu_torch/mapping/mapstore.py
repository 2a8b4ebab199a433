"""Tensor map store: the SLAM map as fixed-capacity SoA arrays.

Counterpart of ``mapping/mapstore.py`` of the JAX package, the subset that
tracking, map initialisation, bundle adjustment and the local mapper use
(reference: src/KeyFrame.cc, src/MapPoint.cc, src/Map.cc): insertion,
culling with tombstones, point fusion, covisibility.
Host bookkeeping runs on numpy arrays; ``device_points`` and
``device_kf_obs`` return tensors on the map's device, cached per
``version`` (a full upload when the version changed). The irregular
bookkeeping (observation counts, point fusion, the points' descriptors,
normals and scale ranges, covisibility on incidence bitsets) runs in the
g++-built host library ``host_native`` on every device, as the JAX package
runs its ``native/slam_host.cpp``; its numpy twins live in
``host_native/plain.py`` and serve only the tests.

The inertial block (reference: KeyFrame's mVw / mImuBias /
mpImuPreintegrated and the mPrevKF chain, include/KeyFrame.h): each
keyframe's velocity and biases, the preintegrated window from its
temporal predecessor ``kf_prev`` (``kf_pre_*``, with the biases it was
integrated at), and the map's flags ``imu_initialized``, ``imu_ba1``,
``imu_ba2``. Culling a keyframe merges its window into its successor's.

Descriptor arrays (``kf_feat_desc``, ``pt_desc``) hold the 256 bits as int32
words; ``from_numpy`` / ``to_numpy`` convert the JAX package's uint32
arrays without changing a bit.

Observation structure: ``kf_feat_point[k, i]`` = map-point id observed by
feature i of keyframe k (or -1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from .. import host_native
from ..imu import preintegration as pre_mod

NO_POINT = -1


@dataclass
class MapConfig:
    max_kf: int = 256
    max_pt: int = 16384
    n_feat: int = 1024        # per-KF feature capacity (extractor budget)
    n_levels: int = 8
    scale: float = 1.2

    def __post_init__(self):
        # the point bitsets need a whole number of 32-bit words
        self.max_pt = (self.max_pt + 31) & ~31


# SoA arrays that tracking reads, with their per-row trailing shape and type
_KF_ARRAYS = {
    "kf_R": ((3, 3), np.float32), "kf_t": ((3,), np.float32),
    "kf_valid": ((), bool), "kf_ts": ((), np.float64),
    "kf_frame_id": ((), np.int64), "kf_prev": ((), np.int32),
    "kf_epoch": ((), np.int64),
}
_KF_FEAT_ARRAYS = {
    "kf_feat_xy": ((2,), np.float32), "kf_feat_xyn": ((2,), np.float32),
    "kf_feat_level": ((), np.int32), "kf_feat_angle": ((), np.float32),
    "kf_feat_desc": ((8,), np.int32), "kf_feat_valid": ((), bool),
    "kf_feat_point": ((), np.int32),
}
_PT_ARRAYS = {
    "pt_xyz": ((3,), np.float32), "pt_valid": ((), bool),
    "pt_desc": ((8,), np.int32), "pt_normal": ((3,), np.float32),
    "pt_min_dist": ((), np.float32), "pt_max_dist": ((), np.float32),
    "pt_ref_kf": ((), np.int32), "pt_first_kf": ((), np.int32),
    "pt_found": ((), np.int32), "pt_visible": ((), np.int32),
    "pt_replaced_by": ((), np.int32),
}
# the inertial block, per keyframe
_KF_IMU_ARRAYS = {
    "kf_vel": ((3,), np.float32), "kf_bg": ((3,), np.float32),
    "kf_ba": ((3,), np.float32), "kf_pre_dT": ((), np.float32),
    "kf_pre_dR": ((3, 3), np.float32), "kf_pre_dV": ((3,), np.float32),
    "kf_pre_dP": ((3,), np.float32), "kf_pre_C": ((15, 15), np.float32),
    "kf_pre_JRg": ((3, 3), np.float32), "kf_pre_JVg": ((3, 3), np.float32),
    "kf_pre_JVa": ((3, 3), np.float32), "kf_pre_JPg": ((3, 3), np.float32),
    "kf_pre_JPa": ((3, 3), np.float32), "kf_pre_bg0": ((3,), np.float32),
    "kf_pre_ba0": ((3,), np.float32),
}
# Preintegrated's fields, in order, and the arrays that hold them
PRE_FIELDS = ("dT", "dR", "dV", "dP", "C", "JRg", "JVg", "JVa", "JPg",
              "JPa", "bg0", "ba0")
_IMU_FLAGS = ("imu_initialized", "imu_ba1", "imu_ba2")
_DESC_ARRAYS = ("kf_feat_desc", "pt_desc")
_ALL_ARRAYS = (*_KF_ARRAYS, *_KF_FEAT_ARRAYS, *_KF_IMU_ARRAYS,
               *_PT_ARRAYS)


class MapStore:
    """One map: host numpy SoA arrays plus per-version device caches."""

    def __init__(self, cfg: MapConfig, device=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        K, P, N = cfg.max_kf, cfg.max_pt, cfg.n_feat
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_ts = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)
        self.kf_prev = np.full(K, -1, np.int32)
        # generation of each keyframe slot (bumped when a slot is filled):
        # tells a trajectory row's keyframe from a later one in its slot
        self.kf_epoch = np.zeros(K, np.int64)
        self.map_id = 0
        self.kf_feat_xy = np.zeros((K, N, 2), np.float32)    # undistorted px
        self.kf_feat_xyn = np.zeros((K, N, 2), np.float32)   # normalized
        self.kf_feat_level = np.zeros((K, N), np.int32)
        self.kf_feat_angle = np.zeros((K, N), np.float32)
        self.kf_feat_desc = np.zeros((K, N, 8), np.int32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_feat_point = np.full((K, N), NO_POINT, np.int32)
        for name, (shape, dtype) in _KF_IMU_ARRAYS.items():
            setattr(self, name, np.zeros((K, *shape), dtype))
        self.kf_pre_dR[:] = np.eye(3, dtype=np.float32)
        self.imu_initialized = False
        self.imu_ba1 = False
        self.imu_ba2 = False
        self.pt_xyz = np.zeros((P, 3), np.float32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_desc = np.zeros((P, 8), np.int32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_ref_kf = np.full(P, -1, np.int32)
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_found = np.zeros(P, np.int32)     # matched-in-tracking count
        self.pt_visible = np.zeros(P, np.int32)   # predicted-visible count
        self.pt_replaced_by = np.full(P, -1, np.int32)
        # (slot, epoch) of a culled keyframe -> (slot', epoch', R_rel, t_rel)
        # through a surviving one, so that trajectory rows anchored to it
        # can be replayed (reference: the spanning-tree parent chain of
        # System::SaveTrajectoryEuRoC, System.cc:721)
        self.tombstones: dict = {}
        self.version = 0
        # bumped only on big corrections (loop closure, global BA, merge;
        # none is ported yet): System.map_changed reads it
        self.big_change_idx = 0
        self._scale_factors = cfg.scale ** np.arange(cfg.n_levels)

    # ---- exchange with the JAX package's map ------------------------------

    @classmethod
    def from_numpy(cls, arrays: dict, cfg: MapConfig, device=None
                   ) -> "MapStore":
        """The port's map from SoA arrays by attribute name (for a JAX
        ``MapStore`` m: ``vars(m)``). Arrays the port does not hold are
        ignored; uint32 descriptor words become int32 with the same bits.
        ``tombstones`` and ``big_change_idx`` are taken too where given."""
        m = cls(cfg, device)
        for name in _ALL_ARRAYS:
            if name not in arrays:
                continue
            a = np.asarray(arrays[name])
            mine = getattr(m, name)
            if a.shape != mine.shape:
                raise ValueError(f"{name}: shape {a.shape} does not match "
                                 f"the config's {mine.shape}")
            if name in _DESC_ARRAYS:
                a = np.ascontiguousarray(a).view(np.int32)
            setattr(m, name, a.astype(mine.dtype, copy=True))
        m.tombstones = {key: (s, e, np.array(R), np.array(t)) for key, (
            s, e, R, t) in arrays.get("tombstones", {}).items()}
        m.big_change_idx = int(arrays.get("big_change_idx", 0))
        for flag in _IMU_FLAGS:
            setattr(m, flag, bool(arrays.get(flag, False)))
        m.version = int(arrays.get("version", 0)) + 1
        return m

    def to_numpy(self) -> dict:
        """SoA arrays by attribute name, descriptors as uint32 words (the
        JAX package's types): ``setattr`` them onto a JAX ``MapStore``. The
        IMU flags (``imu_initialized``, ``imu_ba1``, ``imu_ba2``) are plain
        attributes of both stores, not arrays: ``from_numpy`` takes them
        where given."""
        out = {}
        for name in _ALL_ARRAYS:
            a = getattr(self, name).copy()
            out[name] = a.view(np.uint32) if name in _DESC_ARRAYS else a
        return out

    # ---- allocation --------------------------------------------------------

    def alloc_kf(self) -> int:
        free = np.where(~self.kf_valid)[0]
        if len(free) == 0:
            self.grow(grow_kf=True)
            free = np.where(~self.kf_valid)[0]
        return int(free[0])

    def alloc_points(self, n: int) -> np.ndarray:
        free = np.where(~self.pt_valid)[0]
        while len(free) < n:
            self.grow(grow_pt=True)
            free = np.where(~self.pt_valid)[0]
        return free[:n]

    def grow(self, grow_kf: bool = False, grow_pt: bool = False):
        """Double the keyframe and/or point capacity in place, as the JAX
        store does: a long sequence never meets a capacity wall. The
        device caches follow the version bump."""
        cfg2 = dataclasses.replace(
            self.cfg,
            max_kf=self.cfg.max_kf * 2 if grow_kf else self.cfg.max_kf,
            max_pt=self.cfg.max_pt * 2 if grow_pt else self.cfg.max_pt)
        fresh = MapStore(cfg2, self.device)
        for name in _ALL_ARRAYS:
            arr, new = getattr(self, name), getattr(fresh, name)
            new[:len(arr)] = arr
            setattr(self, name, new)
        self.cfg = cfg2
        self.version += 1

    @property
    def n_kf(self) -> int:
        return int(self.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def kf_ids(self) -> np.ndarray:
        return np.where(self.kf_valid)[0]

    # ---- device-resident view ----------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return device_mod.to_device(a, self.device)

    def device_points(self) -> dict:
        """Device copies of the point arrays (xyz, desc, normal, min_dist,
        max_dist, valid) plus the packed projection rows proj8 [P, 8] =
        (xyz, normal, min, max); cached per map version (full upload on a
        version change)."""
        if getattr(self, "_dev_pts_v", -1) == self.version:
            return self._dev_pts
        d = {k: self._to_dev(getattr(self, "pt_" + k))
             for k in ("xyz", "desc", "normal", "min_dist", "max_dist",
                       "valid")}
        d["proj8"] = torch.cat([d["xyz"], d["normal"], d["min_dist"][:, None],
                                d["max_dist"][:, None]], dim=1)
        self._dev_pts, self._dev_pts_v = d, self.version
        return d

    def device_kf_obs(self) -> dict:
        """Device copies of the observation structure for the on-device
        local-keyframe selection: feat_point [K, N], point_bits
        [K, max_pt/32] int32, valid [K] and the covisibility matrix
        [K, K]; cached per map version. The bitsets are the host
        library's incidence bits viewed as int32 words: bit p & 31 of word
        p >> 5 is set iff the live keyframe observes point p (little-endian:
        uint64 word w holds int32 words 2w and 2w + 1)."""
        if getattr(self, "_dev_kf_v", -1) == self.version:
            return self._dev_kf
        self._dev_kf = {
            "feat_point": self._to_dev(self.kf_feat_point),
            "point_bits": self._to_dev(self.incidence_bits().view(
                np.int32)[:, :self.cfg.max_pt // 32]),
            "valid": self._to_dev(self.kf_valid),
            "covis": self._to_dev(self.covisibility_matrix()),
        }
        self._dev_kf_v = self.version
        return self._dev_kf

    # ---- insertion -----------------------------------------------------------

    def add_keyframe(self, R, t, ts, frame_id, feat_xy, feat_xyn, feat_level,
                     feat_angle, feat_desc, feat_valid, feat_point) -> int:
        k = self.alloc_kf()
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_ts[k] = ts
        self.kf_frame_id[k] = frame_id
        self.kf_feat_xy[k] = feat_xy
        self.kf_feat_xyn[k] = feat_xyn
        self.kf_feat_level[k] = feat_level
        self.kf_feat_angle[k] = feat_angle
        self.kf_feat_desc[k] = np.asarray(feat_desc).view(np.int32)
        self.kf_feat_valid[k] = feat_valid
        # follow fuse forwarding, drop links to dead points
        fp = np.asarray(feat_point).copy()
        for _ in range(4):
            dead = (fp >= 0) & ~self.pt_valid[np.clip(fp, 0, None)]
            if not dead.any():
                break
            fp = np.where(dead, self.pt_replaced_by[np.clip(fp, 0, None)], fp)
        fp = np.where((fp >= 0) & self.pt_valid[np.clip(fp, 0, None)],
                      fp, NO_POINT)
        # two features on one point: keep the first
        idx = np.where(fp >= 0)[0]
        if len(idx):
            _, first = np.unique(fp[idx], return_index=True)
            dup = np.ones(len(idx), bool)
            dup[first] = False
            fp[idx[dup]] = NO_POINT
        self.kf_feat_point[k] = fp
        self.kf_valid[k] = True
        self.kf_epoch[k] += 1
        self.version += 1
        return k

    def add_points(self, xyz, desc, ref_kf: int, normals=None,
                   min_dist=None, max_dist=None) -> np.ndarray:
        ids = self.alloc_points(len(xyz))
        self.pt_xyz[ids] = xyz
        self.pt_desc[ids] = np.asarray(desc).view(np.int32)
        self.pt_valid[ids] = True
        self.pt_replaced_by[ids] = -1
        self.pt_ref_kf[ids] = ref_kf
        self.pt_first_kf[ids] = ref_kf
        self.pt_found[ids] = 1
        self.pt_visible[ids] = 1
        if normals is not None:
            self.pt_normal[ids] = normals
        if min_dist is not None:
            self.pt_min_dist[ids] = min_dist
            self.pt_max_dist[ids] = max_dist
        self.version += 1
        return ids

    def remove_points(self, ids: np.ndarray):
        if len(ids) == 0:
            return
        self.pt_valid[ids] = False
        # detach from all keyframes
        self.kf_feat_point[np.isin(self.kf_feat_point, ids)] = NO_POINT
        self.version += 1

    def replace_point(self, old_id: int, new_id: int):
        """Fuse old into new (reference: MapPoint::Replace). A keyframe that
        already observes new_id drops its old_id link instead."""
        host_native.replace_point(self.kf_valid, self.kf_feat_point, old_id,
                                  new_id)
        self.pt_found[new_id] += self.pt_found[old_id]
        self.pt_visible[new_id] += self.pt_visible[old_id]
        self.pt_valid[old_id] = False
        self.pt_replaced_by[old_id] = new_id
        self.version += 1

    def fuse_observations(self, kf: int, pids, feats) -> int:
        """Apply fuse matches into keyframe kf: candidate point pids[i],
        matched at feature feats[i], either replaces the point already at
        that feature (the more-observed one survives, reference
        ORBmatcher::Fuse, ORBmatcher.cc:1325) or becomes a new observation.
        Keeps one observation per point per keyframe and follows replace
        forwarding. Returns the number of changes."""
        obs = self.observation_counts().copy()
        row = self.kf_feat_point[kf]
        kf_pts = set(int(x) for x in row[row >= 0])
        changed = 0
        for pid, f in zip(pids, feats):
            pid = self.resolve_pid(int(pid))
            if pid < 0:
                continue
            f = int(f)
            existing = int(self.kf_feat_point[kf, f])
            if existing >= 0:
                if existing == pid or not self.pt_valid[existing]:
                    continue
                keep, kill = ((pid, existing) if obs[pid] >= obs[existing]
                              else (existing, pid))
                self.replace_point(kill, keep)
                obs[keep] += obs[kill]
                obs[kill] = 0
                row = self.kf_feat_point[kf]      # links were rewritten
                kf_pts = set(int(x) for x in row[row >= 0])
                changed += 1
            elif pid not in kf_pts:
                self.kf_feat_point[kf, f] = pid
                kf_pts.add(pid)
                obs[pid] += 1
                changed += 1
        if changed:
            self.version += 1
        return changed

    def resolve_pid(self, pid: int) -> int:
        """Follow replace_point forwarding to the surviving point; -1 if the
        chain ends at a dead, unreplaced point (reference: the
        MapPoint::GetReplaced loop of LoopClosing::SearchAndFuse)."""
        hops = 0
        while pid >= 0 and not self.pt_valid[pid] and hops < 32:
            pid = int(self.pt_replaced_by[pid])
            hops += 1
        return pid if pid >= 0 and self.pt_valid[pid] else -1

    # ---- keyframe culling ------------------------------------------------

    def remove_keyframe(self, k: int):
        """Cull a keyframe (reference: KeyFrame::SetBadFlag). Records a
        tombstone so that trajectory rows anchored to it replay through its
        most covisible surviving keyframe; points that lose their last
        observer die, points it referenced re-anchor on a survivor."""
        succ_ids, _ = self.covisibility(k, min_weight=1)
        if len(succ_ids) == 0:
            ids = self.kf_ids()
            succ_ids = ids[ids != k]
        if len(succ_ids) > 0:
            s = int(succ_ids[0])
            # T_k ∘ T_s^-1 at cull time
            R_rel = self.kf_R[k] @ self.kf_R[s].T
            t_rel = self.kf_t[k] - R_rel @ self.kf_t[s]
            self.tombstones[(k, int(self.kf_epoch[k]))] = (
                s, int(self.kf_epoch[s]), R_rel.copy(), t_rel.copy())
        self._merge_preintegration_chain(k)
        owned = self.kf_feat_point[k]
        owned = np.unique(owned[owned >= 0])
        self.kf_valid[k] = False
        self.kf_feat_point[k] = NO_POINT
        self.kf_feat_valid[k] = False
        refd = np.where(self.pt_valid & (self.pt_ref_kf == k))[0]
        targets = np.union1d(owned[self.pt_valid[owned]], refd)
        if len(targets):
            ki, fi = np.nonzero((self.kf_feat_point >= 0)
                                & self.kf_valid[:, None])
            pids = self.kf_feat_point[ki, fi]
            if len(pids) == 0:
                self.remove_points(targets)
            else:
                order = np.argsort(pids, kind="stable")
                ps, ks = pids[order], ki[order]
                idx = np.searchsorted(ps, targets)
                safe = np.minimum(idx, len(ps) - 1)
                has = (idx < len(ps)) & (ps[safe] == targets)
                self.remove_points(targets[~has])
                re = np.isin(targets, refd) & has
                self.pt_ref_kf[targets[re]] = ks[safe[re]]
        self.version += 1

    def _merge_preintegration_chain(self, k: int):
        """Keep the temporal chain connected across a cull: k's window is
        merged into its successor's (reference: Preintegrated::MergePrevious
        on KeyFrame culling, LocalMapping.cc:1230-1250, ImuTypes.cc:330).
        The merge runs on the map's device."""
        nxt = np.where(self.kf_prev == k)[0]
        if len(nxt) == 0 or self.kf_pre_dT[k] <= 0:
            # nothing downstream, or k had no window: just relink
            for n in nxt:
                self.kf_prev[n] = int(self.kf_prev[k])
            return
        n = int(nxt[0])
        if self.kf_pre_dT[n] > 0:
            both = self.get_kf_preintegration([k, n])
            merged = pre_mod.merge(pre_mod.index(both, 0),
                                   pre_mod.index(both, 1))
            self.set_kf_preintegration(n, merged, int(self.kf_prev[k]))
        else:
            self.kf_prev[n] = int(self.kf_prev[k])

    def set_kf_preintegration(self, k: int, pre, prev_kf: int):
        """Store a window (Preintegrated of tensors) from prev_kf to k, in
        one packed fetch."""
        self.kf_prev[k] = prev_kf
        for f, a in zip(PRE_FIELDS, device_mod.fetch_packed(
                [x.to(torch.float32) for x in pre])):
            getattr(self, "kf_pre_" + f)[k] = a

    def get_kf_preintegration(self, ks):
        """Stacked windows of keyframes ks ([len(ks)] leading) on the map's
        device, in one packed upload."""
        ks = np.asarray(ks, np.int64)
        return pre_mod.Preintegrated(*device_mod.upload_packed(
            [getattr(self, "kf_pre_" + f)[ks] for f in PRE_FIELDS],
            self.device))

    def temporal_chain(self) -> np.ndarray:
        """Live keyframes in time order (the prev-link chain's order)."""
        ids = self.kf_ids()
        return ids[np.argsort(self.kf_ts[ids])]

    def resolve_kf_pose(self, slot: int, epoch: int):
        """World->camera pose (R, t) of a keyframe incarnation, culled or
        not, through tombstone chains of any depth (a visited set guards
        against cycles); a resolved chain is compressed to point straight
        at the live keyframe. None if it does not resolve."""
        key0 = (slot, epoch)
        R_acc = np.eye(3, dtype=np.float32)
        t_acc = np.zeros(3, np.float32)
        seen = set()
        while True:
            if self.kf_valid[slot] and self.kf_epoch[slot] == epoch:
                if (slot, epoch) != key0 and key0 in self.tombstones:
                    self.tombstones[key0] = (slot, epoch,
                                             R_acc.copy(), t_acc.copy())
                return (R_acc @ self.kf_R[slot],
                        R_acc @ self.kf_t[slot] + t_acc)
            key = (slot, epoch)
            if key in seen:
                return None
            seen.add(key)
            tomb = self.tombstones.get(key)
            if tomb is None:
                return None
            s, e, R_rel, t_rel = tomb
            t_acc = R_acc @ t_rel + t_acc
            R_acc = R_acc @ R_rel
            slot, epoch = s, e

    # ---- derived structures ----------------------------------------------

    def observation_counts(self) -> np.ndarray:
        """[P] int32: the number of live keyframes observing each point."""
        return host_native.observation_counts(
            self.kf_valid, self.kf_feat_point, self.cfg.max_pt)

    def incidence(self) -> np.ndarray:
        """[K, P] bool: KF k observes point p. Cached per map version."""
        if getattr(self, "_inc_cache_v", -1) == self.version:
            return self._inc_cache
        K, P = self.cfg.max_kf, self.cfg.max_pt
        inc = np.zeros((K, P), bool)
        kk, ff = np.where(self.kf_feat_point >= 0)
        inc[kk, self.kf_feat_point[kk, ff]] = True
        inc &= self.kf_valid[:, None]
        self._inc_cache, self._inc_cache_v = inc, self.version
        return inc

    def incidence_bits(self) -> np.ndarray:
        """[K, ceil(P/64)] uint64 incidence bitsets of the live keyframes,
        cached per map version: AND and popcount over them give the
        covisibility counts (reference: KeyFrame::UpdateConnections)."""
        if getattr(self, "_bits_cache_v", -1) == self.version:
            return self._bits_cache
        self._bits_cache = host_native.build_incidence_bits(
            self.kf_valid, self.kf_feat_point, self.cfg.max_pt)
        self._bits_cache_v = self.version
        return self._bits_cache

    def _covis_weights(self, ks) -> np.ndarray:
        """[len(ks), K] int32 shared-point counts of the query keyframes."""
        return host_native.covis_counts(self.incidence_bits(), self.kf_valid,
                                        np.asarray(ks, np.int64))

    def covisibility_matrix(self) -> np.ndarray:
        """[K, K] shared-point counts (int32) of the live keyframes' rows,
        cached per map version."""
        if getattr(self, "_cov_cache_v", -1) == self.version:
            return self._cov_cache
        K = self.cfg.max_kf
        ids = self.kf_ids()
        cov = np.zeros((K, K), np.int32)
        if len(ids):
            cov[ids] = self._covis_weights(ids)
        self._cov_cache, self._cov_cache_v = cov, self.version
        return cov

    def covisibility(self, k: int, min_weight: int = 15) -> tuple:
        """Keyframes sharing >= min_weight points with KF k, sorted by weight
        (reference: KeyFrame::UpdateConnections threshold 15). Counts the
        one query row on the bitsets."""
        return self.covisibility_batch([k], min_weight)[0]

    def covisibility_batch(self, ks, min_weight: int = 15) -> list:
        """covisibility() of several keyframes in one pass over the
        bitsets: [(ids, weights), ...]."""
        W = self._covis_weights(ks)
        out = []
        for w, k in zip(W, ks):
            w[int(k)] = 0
            ids = np.where(w >= min_weight)[0]
            order = np.argsort(-w[ids])
            out.append((ids[order], w[ids][order]))
        return out

    def point_observers(self, pid: int) -> np.ndarray:
        """Live keyframes observing point pid."""
        return np.where((self.kf_feat_point == pid).any(axis=1)
                        & self.kf_valid)[0]

    def observers_of_points(self, pt_ids) -> np.ndarray:
        """[K] bool: live KFs observing any of pt_ids (the local-BA frontier
        query)."""
        if len(pt_ids) == 0:
            return np.zeros(self.cfg.max_kf, bool)
        return host_native.observers_of(self.incidence_bits(), self.kf_valid,
                                        pt_ids, self.cfg.max_pt)

    def local_point_ids(self, kf_ids) -> np.ndarray:
        """Union of points observed by the given keyframes."""
        ids = self.kf_feat_point[kf_ids]
        ids = np.unique(ids[ids >= 0])
        return ids[self.pt_valid[ids]]

    def check_invariants(self) -> list:
        """Self-check of the map's graph consistency (reference:
        Map::CheckEssentialGraph, Map.h:128). Returns a list of violation
        strings; empty means consistent."""
        errs = []
        inc = self.incidence()
        # live feature->point links must target live points
        fp = self.kf_feat_point[self.kf_valid]
        live = fp[fp >= 0]
        if live.size:
            n_dead = int((~self.pt_valid[live]).sum())
            if n_dead:
                errs.append(f"{n_dead} feature links target dead points")
        # no keyframe may observe the same point through two features
        for k in self.kf_ids():
            row = self.kf_feat_point[k]
            row = row[row >= 0]
            if len(row) != len(np.unique(row)):
                errs.append(f"KF {k} has duplicate point observations")
        # every live point must be observed by >= 1 live keyframe
        n_orphan = int((self.pt_valid & ~inc.any(axis=0)).sum())
        if n_orphan:
            errs.append(f"{n_orphan} live points have no observers")
        # reference keyframes of live points must be live
        ref = self.pt_ref_kf[self.pt_valid]
        bad_ref = int(((ref < 0)
                       | ~self.kf_valid[np.clip(ref, 0, None)]).sum())
        if bad_ref:
            errs.append(f"{bad_ref} live points have dead/absent ref KF")
        # temporal chain: prev links live, strictly back in time
        for k in self.kf_ids():
            p = int(self.kf_prev[k])
            if p >= 0:
                if not self.kf_valid[p]:
                    errs.append(f"KF {k} prev link -> dead KF {p}")
                elif self.kf_ts[p] >= self.kf_ts[k]:
                    errs.append(f"KF {k} prev link not back in time")
        # tombstone chains (culled keyframes) must resolve acyclically
        for (slot, epoch) in list(self.tombstones):
            if self.resolve_kf_pose(slot, epoch) is None:
                errs.append(f"tombstone ({slot},{epoch}) does not resolve")
        return errs

    # ---- maintenance -----------------------------------------------------

    def update_point_stats(self, pids: np.ndarray):
        """Recompute representative descriptor + normal + scale range
        (reference: MapPoint::ComputeDistinctiveDescriptors /
        UpdateNormalAndDepth) in the host library. The representative
        descriptor is the observation whose upper-middle Hamming distance
        to the others is least (``sorted(d)[n // 2]``; the first in
        keyframe-major order wins a tie), as the JAX package's C++ takes it
        (``native/slam_host.cpp``). ORB-SLAM3 takes the lower middle,
        ``vDists[0.5 * (N - 1)]``; the port follows the JAX package, which
        the tests compare against."""
        if len(pids) == 0:
            return
        host_native.update_point_stats(
            self.kf_valid, self.kf_feat_point, self.kf_feat_desc,
            self.kf_feat_level, self.kf_R, self.kf_t, self.pt_xyz,
            self.pt_ref_kf, np.asarray(pids, np.int64),
            self._scale_factors.astype(np.float32), self.pt_desc,
            self.pt_normal, self.pt_min_dist, self.pt_max_dist)
        self.version += 1
