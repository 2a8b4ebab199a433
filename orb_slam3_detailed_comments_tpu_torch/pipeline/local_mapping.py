"""Local mapping: map growth and refinement for each new keyframe.

Counterpart of ``pipeline/local_mapping.py`` of the JAX package (reference:
the LocalMapping thread, src/LocalMapping.cc:94 Run()). For each keyframe
``LocalMapper.process_keyframe`` runs ProcessNewKeyFrame -> MapPointCulling
-> CreateNewMapPoints -> SearchInNeighbors (fuse, both ways) ->
LocalBundleAdjustment -> KeyFrameCulling. The host picks windows and
neighbours from the map's numpy arrays and claims features in neighbour
order; triangulation, the fuse searches and BA run on the map's device.
Each device stage uploads its inputs in one packed copy and fetches its
results in one packed fetch: a keyframe event costs a handful of host
syncs, not one per neighbour. On an inertial map whose IMU is initialised
the local BA is the System's local inertial BA (``inertial_ba``), the fuse
window takes the temporal predecessor too, and keyframe culling keeps the
merged preintegration gap under 0.5 s (3 s after VIBA2).

``run_local_ba`` snapshots a keyframe window from the host map into a
padded ``ba.BAProblem`` on the map's device, solves it there and writes it
back (reference: Optimizer::LocalBundleAdjustment, src/Optimizer.cc:1740).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..lie import SE3
from ..mapping.mapstore import MapStore, NO_POINT
from ..models import cameras
from ..ops import extractor, matching
from ..optim import ba
from ..utils import timing
from . import kernels


@dataclass
class LocalMappingConfig:
    n_covis_triangulate: int = 20   # mono: 30 in reference, stereo 10
    cull_found_ratio: float = 0.25  # reference: LocalMapping.cc:463
    cull_min_obs: int = 2           # cnThObs for mono (ref: 2 mono / 3 stereo)
    kf_cull_redundancy: float = 0.9  # reference: LocalMapping.cc:1177
    ba_window: int = 20
    ba_iters: int = 9
    max_ba_points: int = 4096
    max_ba_obs: int = 16384


class LocalMapper:
    def __init__(self, mapstore: MapStore, cam: cameras.CameraParams,
                 cfg: LocalMappingConfig = LocalMappingConfig()):
        self.map = mapstore
        self.cam = cam
        self.cfg = cfg
        self.recent_points: dict = {}   # pid -> kf id at creation
        # what the last process_keyframe did: points created, culled and
        # fused, keyframes culled, the projection searches of the fuse
        # passes, and the local BA's padded camera count
        self.last_event: dict = {}
        # set by the System on inertial sensors: () -> camera count; runs
        # the local inertial BA once the IMU is initialised
        self.inertial_ba = None

    def process_keyframe(self, k: int):
        """One LocalMapping iteration for keyframe k
        (reference: LocalMapping::Run body, LocalMapping.cc:94-355)."""
        m = self.map
        ev = self.last_event = dict(kf=int(k), ba_cams=0, culled_kfs=[],
                                    fuse_searches=0)
        with timing.span("KF insertion"):
            obs_pts = m.kf_feat_point[k][m.kf_feat_point[k] >= 0]
            m.update_point_stats(np.unique(obs_pts))
        with timing.span("MP culling"):
            ev["culled_points"] = self._map_point_culling(k)
        with timing.span("MP creation"):
            ev["new_points"] = self._create_new_map_points(k)
            ev["fused"] = self._fuse_neighbors(k)
        covis_ids, _ = m.covisibility(k)
        window = [k] + [int(x) for x in covis_ids[: self.cfg.ba_window]]
        if m.n_kf > 2 and len(window) > 1:
            with timing.span("local BA"):
                if self.inertial_ba is not None and m.imu_initialized:
                    # LocalInertialBA replaces LocalBundleAdjustment once
                    # the IMU is initialised (LocalMapping.cc:197-208)
                    ev["ba_cams"] = self.inertial_ba()
                    ev["inertial_ba"] = True
                else:
                    ev["ba_cams"] = run_local_ba(
                        m, window, fixed=None, cam=self.cam,
                        iters=self.cfg.ba_iters,
                        max_points=self.cfg.max_ba_points,
                        max_obs=self.cfg.max_ba_obs)
        with timing.span("KF culling"):
            ev["culled_kfs"] = self._keyframe_culling(k)

    # ------------------------------------------------------------------
    def _map_point_culling(self, k: int) -> int:
        """(reference: LocalMapping::MapPointCulling, LocalMapping.cc:451).
        Returns the number of points dropped."""
        m = self.map
        drop = []
        done = []
        obs = m.observation_counts()
        for pid, created_kf in self.recent_points.items():
            if not m.pt_valid[pid]:
                done.append(pid)
                continue
            age = m.n_kf - int(np.searchsorted(np.sort(m.kf_ids()),
                                               created_kf))
            found_ratio = m.pt_found[pid] / max(m.pt_visible[pid], 1)
            if found_ratio < self.cfg.cull_found_ratio:
                drop.append(pid)
                done.append(pid)
            elif age >= 2 and obs[pid] <= self.cfg.cull_min_obs:
                drop.append(pid)
                done.append(pid)
            elif age >= 3:
                done.append(pid)   # survived probation
        m.remove_points(np.asarray(drop, np.int64))
        for pid in done:
            self.recent_points.pop(pid, None)
        return len(drop)

    # ------------------------------------------------------------------
    def _create_new_map_points(self, k: int) -> int:
        """(reference: LocalMapping::CreateNewMapPoints, LocalMapping.cc:506).
        Returns the number of points created."""
        m = self.map
        covis_ids, _ = m.covisibility(k, min_weight=10)
        neighbors = covis_ids[: self.cfg.n_covis_triangulate]
        if len(neighbors) == 0:
            return 0
        _, inv_s2 = kernels.level_weights(m.cfg.n_levels, m.cfg.scale)
        free_a = m.kf_feat_valid[k] & (m.kf_feat_point[k] == NO_POINT)
        ca = -m.kf_R[k].T @ m.kf_t[k]

        # host-side baseline / parallax precheck per neighbour
        keep = []
        for b in neighbors:
            b = int(b)
            cb = -m.kf_R[b].T @ m.kf_t[b]
            baseline = np.linalg.norm(ca - cb)
            pts_b = m.kf_feat_point[b][m.kf_feat_point[b] >= 0]
            if len(pts_b) == 0:
                continue
            depths = np.einsum("ij,pj->pi", m.kf_R[b],
                               m.pt_xyz[pts_b])[:, 2] + m.kf_t[b][2]
            med_depth = (float(np.median(depths[depths > 0]))
                         if (depths > 0).any() else 1.0)
            if baseline / max(med_depth, 1e-6) >= 0.01:
                keep.append(b)
        if not keep:
            return 0
        # every pair's search on the device, one upload and one fetch; the
        # feature claiming below stays sequential in neighbour order, as
        # the reference's loop is
        bi = np.asarray(keep)
        free_b_all = m.kf_feat_valid[bi] & (m.kf_feat_point[bi] == NO_POINT)
        (Ra, ta, Rb, tb, desc_a, xyn_a, level_a, fa_d, desc_b, xyn_b,
         level_b, fb_d, s2a, s2b) = device_mod.upload_packed(
            [m.kf_R[k], m.kf_t[k], m.kf_R[bi], m.kf_t[bi], m.kf_feat_desc[k],
             m.kf_feat_xyn[k], m.kf_feat_level[k], free_a,
             m.kf_feat_desc[bi], m.kf_feat_xyn[bi], m.kf_feat_level[bi],
             free_b_all, inv_s2[m.kf_feat_level[k]],
             inv_s2[m.kf_feat_level[bi]]], m.device)
        res = kernels.search_and_triangulate_batch(
            SE3(Ra, ta), SE3(Rb, tb), desc_a, xyn_a, level_a, fa_d, desc_b,
            xyn_b, level_b, fb_d, s2a, s2b, focal=float(self.cam.fx))
        ok_all, X_all, idx_b_all = device_mod.fetch_packed(
            [res.ok, res.xyz, res.idx_b])
        ok_all = ok_all & np.isfinite(X_all).all(axis=2)

        claimed_a = ~free_a
        n_new = 0
        for j, b in enumerate(keep):
            fa = np.where(ok_all[j] & ~claimed_a)[0]
            if len(fa) == 0:
                continue
            # drop pairs whose b-feature an earlier neighbour claimed
            fb = idx_b_all[j][fa]
            still_free = m.kf_feat_point[b][fb] == NO_POINT
            fa, fb = fa[still_free], fb[still_free]
            if len(fa) == 0:
                continue
            pids = m.add_points(X_all[j][fa], m.kf_feat_desc[k][fa], ref_kf=k)
            m.kf_feat_point[k, fa] = pids
            m.kf_feat_point[b, fb] = pids
            claimed_a[fa] = True
            for pid in pids:
                self.recent_points[int(pid)] = k
            m.update_point_stats(pids)
            n_new += len(pids)
        return n_new

    # ------------------------------------------------------------------
    def _fuse_neighbors(self, k: int) -> int:
        """Project the neighbours' points into k and fuse duplicates, then
        k's points into the first-level neighbours (reference:
        LocalMapping::SearchInNeighbors + ORBmatcher::Fuse,
        LocalMapping.cc:917, ORBmatcher.cc:1325). Returns the number of
        links changed."""
        m = self.map
        covis_ids, _ = m.covisibility(k, min_weight=15)
        neighbors = [int(b) for b in covis_ids[:10]]
        if not neighbors:
            return 0
        # second-level neighbours: 5 covisibles of each first-level one
        # (LocalMapping.cc:923-960)
        seen = set(neighbors) | {k}
        for sec, _ in m.covisibility_batch(np.asarray(neighbors),
                                           min_weight=15):
            for s in (int(x) for x in sec[:5]):
                if s not in seen:
                    neighbors.append(s)
                    seen.add(s)
            if len(neighbors) >= 25:
                break
        if m.imu_initialized:
            # the temporal predecessor joins an inertial map's window
            p = int(m.kf_prev[k])
            if p >= 0 and p not in seen:
                neighbors.append(p)
        cand = m.local_point_ids(np.asarray(neighbors))
        own = set(m.kf_feat_point[k][m.kf_feat_point[k] >= 0].tolist())
        cand = np.asarray([p for p in cand if p not in own], np.int64)
        if len(cand) == 0:
            return 0
        cap = 4096
        cand = cand[:cap]
        ids = np.concatenate([cand, np.full(cap - len(cand), -1, np.int64)])
        safe = np.where(ids >= 0, ids, 0)
        radius_scale, _ = kernels.level_weights(m.cfg.n_levels, m.cfg.scale)
        up = device_mod.upload_packed(
            [m.kf_R[k], m.kf_t[k], m.pt_xyz[safe], m.pt_normal[safe],
             m.pt_min_dist[safe], m.pt_max_dist[safe],
             (ids >= 0) & m.pt_valid[safe], m.pt_desc[safe], radius_scale,
             *_kf_features(m, [k])], m.device)
        R, t, xyz, normal, dmin, dmax, pvalid, pdesc, rs = up[:9]
        proj = kernels.project_points(SE3(R, t), xyz, normal, dmin, dmax,
                                      pvalid, self.cam, m.cfg.scale,
                                      m.cfg.n_levels)
        res = matching.search_by_projection(
            proj.uv, proj.visible, pdesc, proj.level,
            _as_features(*(a[0] for a in up[9:])),
            3.0 * rs[proj.level.long()], max_dist=matching.TH_LOW,
            ratio=1.0)
        self.last_event["fuse_searches"] = 1
        valid, fidx = device_mod.fetch_packed([res.valid, res.idx])
        sel = np.where(valid)[0]
        changed = m.fuse_observations(k, ids[sel], fidx[sel])
        # reverse direction: k's own points into the first-level neighbours
        # (the reference fuses both ways, LocalMapping.cc:930-960)
        return changed + self._fuse_into_neighbors(k, neighbors[:10])

    def _fuse_into_neighbors(self, k: int, nb: list) -> int:
        m = self.map
        own_f = np.where(m.kf_feat_point[k] >= 0)[0]
        if len(nb) == 0 or len(own_f) == 0:
            return 0
        pids_f = m.kf_feat_point[k][own_f]          # per-feature point id
        ids = np.full(m.cfg.n_feat, -1, np.int64)
        ids[: len(pids_f)] = pids_f
        safe = np.where(ids >= 0, ids, 0)
        nbp = np.asarray(nb)
        radius_scale, _ = kernels.level_weights(m.cfg.n_levels, m.cfg.scale)
        up = device_mod.upload_packed(
            [m.kf_R[nbp], m.kf_t[nbp], m.pt_xyz[safe], m.pt_normal[safe],
             m.pt_min_dist[safe], m.pt_max_dist[safe],
             (ids >= 0) & m.pt_valid[safe], m.pt_desc[safe], radius_scale,
             *_kf_features(m, nbp)], m.device)
        valid_b, fidx_b = device_mod.fetch_packed(list(_fuse_reverse_batch(
            *up, self.cam, float(m.cfg.scale), int(m.cfg.n_levels))))
        self.last_event["fuse_searches"] = (
            self.last_event.get("fuse_searches", 0) + len(nb))
        changed = 0
        for j, b in enumerate(nb):
            sel = np.where(valid_b[j])[0]
            changed += m.fuse_observations(b, ids[sel], fidx_b[j][sel])
        return changed

    # ------------------------------------------------------------------
    def _keyframe_culling(self, k: int) -> list:
        """Cull covisible keyframes where ~90 % of the points are seen by
        >= 3 OTHER keyframes at the same or a finer pyramid level
        (reference: LocalMapping::KeyFrameCulling, LocalMapping.cc:1177).
        Never culls k itself, keyframes 0 and 1, or the 3 newest (the
        tracker's reference must survive). Returns the culled ids."""
        m = self.map
        covis_ids, _ = m.covisibility(k)
        recent = set(int(x) for x in np.argsort(-m.kf_frame_id)[:3])
        # observation histogram over (point, level) across all live KFs
        nl = m.cfg.n_levels
        kk = np.where(m.kf_valid)[0]
        fp = m.kf_feat_point[kk]
        lv = m.kf_feat_level[kk]
        sel = fp >= 0
        hist = np.zeros((m.cfg.max_pt, nl), np.int32)
        np.add.at(hist, (fp[sel], lv[sel]), 1)
        cum = hist.cumsum(axis=1)                  # obs at level <= l
        culled = []
        for b in covis_ids:
            b = int(b)
            if b <= 1 or b == k or b in recent:
                continue
            # inertial spacing: culling b merges its window into its
            # successor's; the merged gap stays under 0.5 s (3 s after
            # VIBA2) or the chain is useless to inertial BA
            # (LocalMapping.cc:1230-1260)
            if m.imu_initialized and m.kf_pre_dT[b] > 0:
                nxt = np.where(m.kf_prev == b)[0]
                p = int(m.kf_prev[b])
                if p >= 0 and len(nxt):
                    gap = float(m.kf_ts[int(nxt[0])] - m.kf_ts[p])
                    if gap > (3.0 if m.imu_ba2 else 0.5):
                        continue
            feats = np.where(m.kf_feat_point[b] >= 0)[0]
            pts = m.kf_feat_point[b][feats]
            ok = m.pt_valid[pts]
            feats, pts = feats[ok], pts[ok]
            if len(pts) < 20:
                continue
            lv_b = np.minimum(m.kf_feat_level[b, feats] + 1, nl - 1)
            # b's own observation is within its own level gate
            redundant = (cum[pts, lv_b] - 1 >= 3).sum()
            if redundant > self.cfg.kf_cull_redundancy * len(pts):
                m.remove_keyframe(b)
                culled.append(b)
                # keep the histogram consistent after removal
                fsel = m.kf_feat_level[b, feats]
                np.subtract.at(hist, (pts, fsel), 1)
                cum = hist.cumsum(axis=1)
        return culled


def _kf_features(m: MapStore, ks) -> list:
    """The fuse search's view of keyframes ks: [B, N] xy (undistorted),
    level, descriptors and validity, as host arrays for one upload."""
    ks = np.asarray(ks)
    return [m.kf_feat_xy[ks], m.kf_feat_level[ks], m.kf_feat_desc[ks],
            m.kf_feat_valid[ks]]


def _as_features(xy, level, desc, valid) -> extractor.FrameFeatures:
    zeros = torch.zeros_like(xy[:, 0])
    return extractor.FrameFeatures(xy=xy, level=level, angle=zeros,
                                   score=zeros, desc=desc, valid=valid)


def full_obs_cap(m: MapStore) -> int:
    """Observation capacity covering the map's full observation set,
    bucketed to a power of two (>= 32768): full-map solves must not
    subsample the observation graph."""
    n_obs = int((m.kf_feat_point[m.kf_valid] >= 0).sum())
    cap = 32768
    while cap < n_obs:
        cap *= 2
    return cap


def _fuse_reverse_batch(kf_R_b, kf_t_b, pts, normals, min_d, max_d, pvalid,
                        pdesc, radius_scale, f_xy_b, f_level_b, f_desc_b,
                        f_valid_b, cam, scale: float, n_levels: int):
    """Project ONE keyframe's points into B neighbour keyframes and match
    (ORBmatcher::Fuse(pKFi, vpMapPointMatches), LocalMapping.cc:930-940):
    one projection search, one ``hamming_best2_windowed`` launch, per
    neighbour. Returns (valid [B, P], idx [B, P])."""
    valid, idx = [], []
    for j in range(kf_R_b.shape[0]):
        proj = kernels.project_points(SE3(kf_R_b[j], kf_t_b[j]), pts,
                                      normals, min_d, max_d, pvalid, cam,
                                      scale, n_levels)
        res = matching.search_by_projection(
            proj.uv, proj.visible, pdesc, proj.level,
            _as_features(f_xy_b[j], f_level_b[j], f_desc_b[j], f_valid_b[j]),
            3.0 * radius_scale[proj.level.long()],
            max_dist=matching.TH_LOW, ratio=1.0)
        valid.append(res.valid)
        idx.append(res.idx)
    return torch.stack(valid), torch.stack(idx)


def run_local_ba(m: MapStore, window: list, fixed, cam, iters: int = 10,
                 max_points: int = 4096, max_obs: int = 16384):
    """Build a BAProblem from a keyframe window, solve it and write the
    result back. Returns the problem's padded camera count C (0 if the
    window held too little to solve).

    window: keyframe ids to optimize. fixed: ids held constant (None: the
    frontier, i.e. observers of window points outside the window, or the
    oldest window keyframes if there is no frontier)."""
    built = build_ba_problem(m, window, fixed, max_points=max_points,
                             max_obs=max_obs)
    if built is None:
        return 0
    prob, meta = built
    res = ba.ba_solve(prob, cam, iters=iters, table_depth=meta["table_depth"])
    apply_ba_result(m, meta, res)
    return int(prob.kf_R.shape[0])


def build_ba_problem(m: MapStore, window: list, fixed,
                     max_points: int = 4096, max_obs: int = 16384):
    """Snapshot a keyframe window into a BAProblem on the map's device plus
    host metadata; None if the window holds too little to solve."""
    window = [int(k) for k in window if m.kf_valid[k]]
    if len(window) == 0:
        return None
    pt_ids = m.local_point_ids(np.asarray(window))[:max_points]
    if len(pt_ids) == 0:
        return None
    pt_slot = {int(p): i for i, p in enumerate(pt_ids)}

    # frontier: other observers of these points
    observers = np.where(m.observers_of_points(pt_ids))[0]
    frontier = [int(x) for x in observers if int(x) not in set(window)]
    if fixed is None:
        fixed_set = set(frontier)
        if not fixed_set:
            fixed_set = (set(window[:1]) if len(window) < 3
                         else set(sorted(window)[:2]))
    else:
        fixed_set = set(int(x) for x in fixed)
    cams = window + frontier
    cams = cams[: max(len(window) + 12, 24)]   # cap frontier size
    cam_slot = {int(c): i for i, c in enumerate(cams)}
    # the camera count is bucketed as in the JAX package, so both solve the
    # same padded problem (dummy cameras are fixed and observation-free)
    n_real = len(cams)
    C = ((n_real + 7) // 8) * 8

    # observations from kf_feat_point (vectorized over the whole window)
    sf2 = (m.cfg.scale ** np.arange(m.cfg.n_levels)) ** 2
    lut = np.full(m.cfg.max_pt, -1, np.int32)
    lut[pt_ids] = np.arange(len(pt_ids), dtype=np.int32)
    fp_all = m.kf_feat_point[cams]                     # [C, N]
    slot_of = lut[np.maximum(fp_all, 0)]
    sel = (fp_all >= 0) & (slot_of >= 0)
    ci, fi = np.nonzero(sel)
    oc = ci.astype(np.int32)                           # window slot == row
    op = slot_of[ci, fi]
    ouv = m.kf_feat_xy[cams][ci, fi]
    ow = (1.0 / sf2[m.kf_feat_level[cams][ci, fi]]).astype(np.float32)
    O = len(oc)
    if O < 20:
        return None
    if O > max_obs:
        keep = np.random.default_rng(0).choice(O, max_obs, replace=False)
    else:
        keep = np.arange(O)
    pad = max_obs - len(keep)

    def pad_arr(a, fill=0):
        a = np.asarray(a)[keep]
        return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])

    P = max_points
    pt_xyz = np.zeros((P, 3), np.float32)
    pt_xyz[: len(pt_ids)] = m.pt_xyz[pt_ids]
    pt_mask = np.zeros(P, bool)
    pt_mask[: len(pt_ids)] = True

    fixed_mask = np.asarray([c in fixed_set for c in cams]
                            + [True] * (C - n_real))
    kf_R_in = np.concatenate(
        [m.kf_R[cams], np.tile(np.eye(3, dtype=np.float32),
                               (C - n_real, 1, 1))])
    kf_t_in = np.concatenate([m.kf_t[cams],
                              np.zeros((C - n_real, 3), np.float32)])
    prob = ba.problem_from_numpy(dict(
        kf_R=kf_R_in, kf_t=kf_t_in, points=pt_xyz,
        obs_cam=pad_arr(oc), obs_pt=pad_arr(op),
        obs_uv=pad_arr(ouv.astype(np.float32)), obs_w=pad_arr(ow),
        obs_valid=np.concatenate([np.ones(len(keep), bool),
                                  np.zeros(pad, bool)]),
        fixed_cam=fixed_mask, point_valid=pt_mask), m.device)
    # true max observations per point, bucketed to a power of two: the
    # static depth of ba_solve's dense observation table
    d_max = int(np.bincount(np.asarray(op)[keep], minlength=1).max())
    table_depth = 1 << max(int(np.ceil(np.log2(max(d_max, 4)))), 2)
    meta = dict(cams=cams, n_real=n_real, pt_ids=pt_ids, keep=keep,
                oc=np.asarray(oc)[keep], op=np.asarray(op)[keep],
                cam_slot=cam_slot, pt_slot=pt_slot, table_depth=table_depth)
    return prob, meta


def apply_ba_result(m: MapStore, meta: dict, res: ba.BAResult):
    """Write a BAResult back into the map (poses, points, outlier edges)."""
    cams, n_real, pt_ids = meta["cams"], meta["n_real"], meta["pt_ids"]
    # one packed transfer for the whole BA result
    bR, bt, bp, binl = device_mod.fetch_packed(
        [res.kf_R, res.kf_t, res.points, res.obs_inlier])
    m.kf_R[cams] = bR[:n_real]
    m.kf_t[cams] = bt[:n_real]
    m.pt_xyz[pt_ids] = bp[: len(pt_ids)]

    # detach outlier observations (reference: Optimizer.cc:2040-2100)
    inl = binl[: len(meta["keep"])]
    oc_np, op_np = meta["oc"], meta["op"]
    touched = set()
    for o in np.where(~inl)[0]:
        c = cams[int(oc_np[o])]
        pid = int(pt_ids[int(op_np[o])])
        m.kf_feat_point[c, m.kf_feat_point[c] == pid] = NO_POINT
        touched.add(pid)
    # a point whose observations all got detached dies with them
    # (reference: MapPoint::EraseObservation -> SetBadFlag)
    if touched:
        tl = np.asarray(sorted(touched))
        tl = tl[m.pt_valid[tl]]
        if len(tl):
            obs = m.observation_counts()
            m.remove_points(tl[obs[tl] == 0])
    m.version += 1
