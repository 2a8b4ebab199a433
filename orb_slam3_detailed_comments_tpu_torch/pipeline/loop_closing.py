"""Loop closing: place-recognition candidates -> Sim3 verification ->
loop correction -> essential-graph optimisation -> global BA; the visual
path.

Counterpart of ``pipeline/loop_closing.py`` of the JAX package (reference:
the LoopClosing thread, src/LoopClosing.cc:100 Run, NewDetectCommonRegions
:383, CorrectLoop :1273). Host code orchestrates on the numpy map, as in
the JAX package; descriptor matching (``hamming_best2`` and
``hamming_best2_windowed``), the Sim3 RANSAC and refinement, the pose graph
and global BA run on the map's device.

What waits for later slices (``ROADMAP.md``): the global BA that races
tracking on a thread (``async_gba``, with the async mapping worker, item
1.4), the inertial branches (item 1.6) and the sharded GBA (item 1.7).
Global BA here is the synchronous one: ``gba_rounds`` bundle adjustments
over every keyframe (``ba.ba_solve`` routes them by camera count).

The RANSAC minimal sets are drawn on the host from a generator seeded by
the keyframe pair and uploaded, so the card and the CPU verify a pair on
the same sets.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..lie import SE3, Sim3
from ..mapping.mapstore import MapStore
from ..models import cameras
from ..ops import extractor, matching
from ..optim import ba, pose_graph
from ..placerec import sim3_solver
from ..placerec.keyframe_db import KeyFrameDatabase
from ..placerec.pnp import sample_sets
from ..utils import timing
from . import kernels
from .local_mapping import full_obs_cap, run_local_ba

ITEM_ASYNC = "1.4"     # ROADMAP.md: the racing global BA (async mapping)

# descriptor searches issued by place recognition, by caller: each
# "sim3_match" and "reloc_match" is a mutual match_nn (two hamming_best2
# launches), each other one search_by_projection (one
# hamming_best2_windowed launch); the System's relocalisation adds its own
SEARCHES = dict(sim3_match=0, projection=0, loop_fuse=0, reloc_match=0,
                reloc_search=0)


@dataclass
class LoopClosingConfig:
    n_candidates: int = 3
    min_bow_matches: int = 20     # nBoWMatches (LoopClosing.cc:746)
    min_sim3_inliers: int = 20    # nSim3Inliers
    min_proj_matches: int = 50    # nProjMatches
    min_proj_opt_matches: int = 80  # nProjOptMatches (LoopClosing.cc:752)
    prop_min_proj: int = 30       # propagation path's nProjMatches
    prop_min_proj_opt: int = 50   # and its post-refine gate
    consistency_needed: int = 3   # successive verifications of one region
    max_not_found: int = 2        # propagation misses a chain survives
    closure_cooldown_kfs: int = 10  # no detection within N KFs of a closure
    min_frame_gap: int = 0        # optional extra temporal gate (frames)
    fix_scale: bool = False       # metric depth (stereo / RGB-D): s = 1
    covis_edge_min_weight: int = 100  # essential-graph covisibility edges
    run_global_ba: bool = True
    gba_iters: int = 10
    gba_rounds: int = 3           # build + solve rounds of the sync GBA
    async_gba: bool = False       # not ported (ROADMAP item 1.4)


@dataclass
class _ActiveCandidate:
    """An in-progress loop hypothesis (reference: mpLoopMatchedKF /
    mg2oLoopSlw / mnLoopNumCoincidences / mnLoopNumNotFoundLoop,
    LoopClosing.h:180-196)."""
    c: int
    region: frozenset
    S_kc: Sim3
    count: int
    last_k: int
    not_found: int = 0


def host_sim3(R, t, s=1.0) -> Sim3:
    """A Sim3 of host (CPU float32) tensors from numpy-like values."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return Sim3(f(R), f(t), f(s))


def sim3_np(S: Sim3):
    """(R, t, s) of a Sim3 as numpy float32 / float."""
    return (S.R.cpu().numpy().astype(np.float32),
            S.t.cpu().numpy().astype(np.float32), float(S.s))


class LoopCloser:
    def __init__(self, mapstore: MapStore, cam: cameras.CameraParams,
                 kfdb: KeyFrameDatabase,
                 cfg: LoopClosingConfig = LoopClosingConfig()):
        if cfg.async_gba:
            raise NotImplementedError(
                "the racing global BA (async_gba) is not ported to the "
                f"PyTorch package yet (ROADMAP.md, queue item {ITEM_ASYNC})")
        self.map = mapstore
        self.cam = cam
        self.kfdb = kfdb
        self.cfg = cfg
        self.active: _ActiveCandidate | None = None
        self.n_loops_closed = 0
        self.n_loops_rejected_projgate = 0
        self.n_processed = 0
        self.cooldown_until = 0
        self.n_gba_runs = 0
        # what the last correction did: the keyframe count, and the global
        # BA's padded camera count and tier per round
        self.last_correction: dict = {}

    # ------------------------------------------------------------------
    def process_keyframe(self, k: int) -> bool:
        """One LoopClosing iteration; True if a loop was closed.

        An active hypothesis is first re-verified by propagating its Sim3 to
        this keyframe (DetectCommonRegionsFromLastKF); only when that fails
        does BoW retrieval run, and a fresh candidate continues the chain
        only in the same covisible region. The closure commits after
        ``consistency_needed`` verifications and a final nProjOptMatches
        gate (reference: NewDetectCommonRegions, LoopClosing.cc:383-760)."""
        closed = False
        self.n_processed += 1
        if self.n_processed < self.cooldown_until:
            self.kfdb.add(k, self.map.kf_feat_desc[k],
                          self.map.kf_feat_valid[k])
            return False
        detected = None
        if self.active is not None:
            with timing.span("PR detection"):
                detected = self._refine_from_last_kf(k)
            if detected is not None:
                self.active.S_kc = detected[1]
                self.active.count += 1
                self.active.last_k = k
                self.active.not_found = 0
            else:
                self.active.not_found += 1
                if self.active.not_found >= self.cfg.max_not_found:
                    self.active = None
        if detected is None:
            with timing.span("PR detection"):
                cand = self._detect(k)
            if cand is not None:
                c, S_kc = cand
                if self.active is not None and int(c) in self.active.region:
                    self.active.c = int(c)
                    self.active.S_kc = S_kc
                    self.active.count += 1
                    self.active.last_k = k
                    self.active.not_found = 0
                else:
                    covis, _ = self.map.covisibility(int(c), min_weight=15)
                    region = frozenset([int(c)] + [int(x) for x in covis])
                    self.active = _ActiveCandidate(
                        c=int(c), region=region, S_kc=S_kc, count=1,
                        last_k=k)
        if (self.active is not None
                and self.active.count >= self.cfg.consistency_needed):
            c, S_kc = self.active.c, self.active.S_kc
            n_proj = count_projection_matches(
                self.map, self.active.last_k, self.map, c, S_kc, self.cam)
            if n_proj >= self.cfg.min_proj_opt_matches:
                with timing.span("loop correction"):
                    closed = self._correct_loop(self.active.last_k, c, S_kc)
            else:
                self.n_loops_rejected_projgate += 1
            self.active = None
            if closed:
                self.n_loops_closed += 1
                self.cooldown_until = (self.n_processed
                                       + self.cfg.closure_cooldown_kfs)
        self.kfdb.add(k, self.map.kf_feat_desc[k], self.map.kf_feat_valid[k])
        return closed

    # ------------------------------------------------------------------
    def _detect(self, k: int):
        """BoW candidates + Sim3 geometric verification (reference:
        DetectCommonRegionsFromBoW)."""
        m = self.map
        for c in self.kfdb.detect_candidates(m, k, self.cfg.n_candidates):
            if self.cfg.min_frame_gap > 0 and abs(
                    int(m.kf_frame_id[k]) - int(m.kf_frame_id[c])
                    ) < self.cfg.min_frame_gap:
                continue
            out = self._verify_candidate(k, c)
            if out is not None:
                return out
        return None

    def _verify_candidate(self, k: int, c: int):
        return verify_sim3_pair(self.map, k, self.map, c, self.cam, self.cfg)

    def _refine_from_last_kf(self, k: int):
        """Propagate the active hypothesis' Sim3 to keyframe k, re-verify by
        guided projection and refine (reference:
        DetectAndReffineSim3FromLastKF, LoopClosing.cc:610-730). Returns
        (c, S_kc) or None."""
        a = self.active
        m = self.map
        if not (m.kf_valid[a.c] and m.kf_valid[a.last_k] and m.kf_valid[k]):
            return None
        T_k = host_sim3(m.kf_R[k], m.kf_t[k])
        T_l = host_sim3(m.kf_R[a.last_k], m.kf_t[a.last_k])
        S_prop = T_k.compose(T_l.inverse()).compose(a.S_kc)
        pt_ids, fidx = match_by_projection_pairs(m, k, m, a.c, S_prop,
                                                 self.cam)
        if len(pt_ids) < self.cfg.prop_min_proj:
            return None
        S_ref = S_prop
        pk = m.kf_feat_point[k][fidx]
        both = (pk >= 0) & m.pt_valid[np.maximum(pk, 0)]
        if both.sum() >= self.cfg.min_sim3_inliers:
            fk, pks, pcs = fidx[both], pk[both], pt_ids[both]
            xk = m.pt_xyz[pks] @ m.kf_R[k].T + m.kf_t[k]
            xc = m.pt_xyz[pcs] @ m.kf_R[a.c].T + m.kf_t[a.c]
            xn_c = xc[:, :2] / np.maximum(xc[:, 2:3], 1e-6)
            d = _padded_pairs(xk, xc, m.kf_feat_xyn[k][fk], xn_c, m.device)
            pR, pt, ps = sim3_np(S_prop)
            R0, t0, s0 = device_mod.upload_packed(
                [pR, pt, np.float32([ps])], m.device)
            s0 = s0.reshape(())
            ref = sim3_solver.refine_sim3_gn(
                R0, t0, s0, d["x1"], d["x2"], d["xn1"], d["xn2"], d["valid"],
                focal=float(self.cam.fx), fix_scale=self.cfg.fix_scale,
                min_inliers=self.cfg.min_sim3_inliers)
            rR, rt, rs, r_ok = device_mod.fetch_packed(
                [ref.R, ref.t, ref.s, ref.ok])
            if bool(r_ok):
                S_ref = host_sim3(rR, rt, rs)
        if (count_projection_matches(m, k, m, a.c, S_ref, self.cam)
                < self.cfg.prop_min_proj_opt):
            return None
        return a.c, S_ref

    # ------------------------------------------------------------------
    def _correct_loop(self, k: int, match_kf: int, S_kc: Sim3) -> bool:
        """(reference: LoopClosing::CorrectLoop, LoopClosing.cc:1273)"""
        m = self.map
        S_kw_corr = S_kc.compose(host_sim3(m.kf_R[match_kf],
                                           m.kf_t[match_kf]))
        kf_ids = m.kf_ids()
        K = len(kf_ids)
        slot = {int(x): i for i, x in enumerate(kf_ids)}
        R0 = m.kf_R[kf_ids].copy()
        t0 = m.kf_t[kf_ids].copy()
        s0 = np.ones(K, np.float32)

        # the correction of k's covisible group before the graph
        covis_k, _ = m.covisibility(k, min_weight=15)
        window = [k] + [int(x) for x in covis_k]
        delta = S_kw_corr.compose(host_sim3(m.kf_R[k], m.kf_t[k]).inverse())
        Rd, td, sd = sim3_np(delta)
        sc = 1.0 / sd
        widx = np.asarray([slot[w] for w in window])
        Rc = np.einsum("nij,kj->nik", m.kf_R[window], Rd)
        tc = m.kf_t[window] - sc * np.einsum("nij,j->ni", Rc, td)
        R0[widx] = Rc
        t0[widx] = tc
        s0[widx] = sc

        ei, ej, eR, et, es, ew = _chain_covis_edges(
            m, kf_ids, m.kf_R, m.kf_t, self.cfg.covis_edge_min_weight)
        m_loop = S_kw_corr.compose(host_sim3(m.kf_R[match_kf],
                                             m.kf_t[match_kf]).inverse())
        lR, lt, ls = sim3_np(m_loop)
        ei.append(slot[k]); ej.append(slot[match_kf])
        eR.append(lR); et.append(lt); es.append(ls); ew.append(5.0)

        fixed = np.zeros(K, bool)
        fixed[slot[match_kf]] = True
        R_new, t_new, s_new = _solve_essential_graph(
            m.device, R0, t0, s0, fixed, ei, ej, eR, et, es, ew,
            fix_scale=self.cfg.fix_scale)
        _apply_pose_graph(m, kf_ids, slot, R_new, t_new, s_new)

        self._fuse_loop_points(k, match_kf)
        m.update_point_stats(np.where(m.pt_valid)[0])

        self.last_correction = dict(k=int(k), match_kf=int(match_kf),
                                    n_kf=int(K), gba=[])
        if self.cfg.run_global_ba:
            window = [int(x) for x in m.kf_ids()]
            anchor = [match_kf] if match_kf in window else window[:1]
            for _ in range(self.cfg.gba_rounds):
                C = run_local_ba(m, window, fixed=anchor, cam=self.cam,
                                 iters=self.cfg.gba_iters,
                                 max_points=m.cfg.max_pt // 2,
                                 max_obs=full_obs_cap(m))
                self.last_correction["gba"].append(
                    dict(C=C, tier=ba.tier_of(C)))
            self.n_gba_runs += 1
        return True

    # ------------------------------------------------------------------
    def _fuse_loop_points(self, k: int, c: int):
        """Project the loop side's points into k's covisible window and
        merge duplicates (reference: LoopClosing::SearchAndFuse): one
        ``hamming_best2_windowed`` launch of at most 2048 queries a
        keyframe."""
        m = self.map
        covis_c, _ = m.covisibility(c, min_weight=10)
        loop_pts = m.local_point_ids(
            np.asarray([c] + [int(x) for x in covis_c[:10]]))
        covis_k, _ = m.covisibility(k, min_weight=10)
        for w in [k] + [int(x) for x in covis_k[:5]]:
            own = m.kf_feat_point[w]
            own_set = set(own[own >= 0].tolist())
            cand = np.asarray([p for p in loop_pts if p not in own_set],
                              np.int64)
            if len(cand) == 0:
                continue
            cap = 2048
            cand = cand[:cap]
            ids = np.concatenate([cand, np.full(cap - len(cand), -1,
                                                np.int64)])
            safe = np.where(ids >= 0, ids, 0)
            (R, t, xyz, nrm, dmin, dmax, ok, pdesc, *feat
             ) = device_mod.upload_packed(
                [m.kf_R[w], m.kf_t[w], m.pt_xyz[safe], m.pt_normal[safe],
                 m.pt_min_dist[safe], m.pt_max_dist[safe],
                 (ids >= 0) & m.pt_valid[safe], m.pt_desc[safe],
                 *_kf_feat_arrays(m, w)], m.device)
            proj = kernels.project_points(SE3(R, t), xyz, nrm, dmin, dmax, ok,
                                          self.cam, m.cfg.scale,
                                          m.cfg.n_levels)
            res = matching.search_by_projection(
                proj.uv, proj.visible & ok, pdesc, proj.level,
                _features(*feat), 6.0, level_lo=-2, level_hi=2,
                max_dist=matching.TH_LOW, ratio=1.0)
            SEARCHES["loop_fuse"] += 1
            valid, fidx = device_mod.fetch_packed([res.valid, res.idx])
            sel = np.where(valid)[0]
            m.fuse_observations(w, ids[sel], fidx[sel])


def _chain_covis_edges(m: MapStore, kf_ids, R_src, t_src, min_weight: int):
    """Essential-graph edges: strong covisibility (weight >= min_weight) and
    the sequential chain, with relative-pose measurements Sa Sb^-1 at unit
    scale taken from the (R_src, t_src) snapshot. Returns (ei, ej, eR, et,
    es, ew) lists over slot indices into kf_ids."""
    K = len(kf_ids)
    covm = m.covisibility_matrix()
    ai, bi = np.triu_indices(K, 1)
    keep = (covm[kf_ids[ai], kf_ids[bi]] >= min_weight) | (bi == ai + 1)
    ai, bi = ai[keep], bi[keep]
    Ra, ta = R_src[kf_ids[ai]], t_src[kf_ids[ai]]
    Rb, tb = R_src[kf_ids[bi]], t_src[kf_ids[bi]]
    Rrel = np.einsum("nij,nkj->nik", Ra, Rb)
    trel = ta - np.einsum("nij,nj->ni", Rrel, tb)
    return ([int(x) for x in ai], [int(x) for x in bi], list(Rrel),
            list(trel), [1.0] * len(ai), [1.0] * len(ai))


def _solve_essential_graph(device, R0, t0, s0, fixed, ei, ej, eR, et, es, ew,
                           fix_scale: bool, iters: int = 15):
    """Pad a Sim3 pose-graph problem to the JAX package's buckets (K to 16,
    E to 128; padded states fixed, padded edges of weight 0) and solve it
    on the device. Returns (R, t, s) numpy arrays of the K real keyframes."""
    K = len(R0)
    Kp = ((K + 15) // 16) * 16
    Ep = ((len(ei) + 127) // 128) * 128
    padK, padE = Kp - K, Ep - len(ei)
    eye = np.eye(3, dtype=np.float32)
    arrays = [
        np.concatenate([R0, np.tile(eye, (padK, 1, 1))]).astype(np.float32),
        np.concatenate([t0, np.zeros((padK, 3))]).astype(np.float32),
        np.concatenate([s0, np.ones(padK)]).astype(np.float32),
        np.concatenate([ei, np.zeros(padE, np.int64)]).astype(np.int32),
        np.concatenate([ej, np.zeros(padE, np.int64)]).astype(np.int32),
        np.concatenate([np.stack(eR), np.tile(eye, (padE, 1, 1))]).astype(
            np.float32),
        np.concatenate([np.stack(et), np.zeros((padE, 3))]).astype(np.float32),
        np.concatenate([es, np.ones(padE)]).astype(np.float32),
        np.concatenate([ew, np.zeros(padE)]).astype(np.float32),
        np.concatenate([fixed, np.ones(padK, bool)])]
    res = pose_graph.optimize_sim3_graph(
        *device_mod.upload_packed(arrays, device), iters=iters,
        fix_scale=fix_scale)
    R, t, s = device_mod.fetch_packed([res.R, res.t, res.s])
    return R[:K], t[:K], s[:K]


def _apply_pose_graph(m: MapStore, kf_ids, slot, R_new, t_new, s_new):
    """Write optimised keyframe similarities into the SE3 map (scale folded
    into translation) and carry each point with its reference keyframe's
    correction (reference: CorrectLoop's eigSwc point update)."""
    pts = np.where(m.pt_valid)[0]
    ref = m.pt_ref_kf[pts].copy()
    for i, p in enumerate(pts):
        if ref[i] not in slot:
            obs = m.point_observers(p)
            ref[i] = obs[0] if len(obs) else kf_ids[0]
    rs = np.asarray([slot[int(r)] for r in ref], np.int64)
    R_old, t_old = m.kf_R[kf_ids][rs], m.kf_t[kf_ids][rs]
    x_local = np.einsum("nij,nj->ni", R_old, m.pt_xyz[pts]) + t_old
    # S_new^-1 x = R^T (x - t) / s
    Rn, tn, sn = R_new[rs], t_new[rs], s_new[rs]
    x_corr = np.einsum("nji,nj->ni", Rn, x_local - tn) / sn[:, None]
    m.pt_xyz[pts] = x_corr.astype(np.float32)
    m.kf_R[kf_ids] = R_new
    m.kf_t[kf_ids] = t_new / np.maximum(s_new[:, None], 1e-9)
    m.version += 1
    m.big_change_idx += 1


def run_merge_essential_graph(m: MapStore, snap_R, snap_t, fixed_ids,
                              fix_scale: bool = False,
                              covis_edge_min_weight: int = 100,
                              iters: int = 15):
    """Merge variant of the essential graph (reference: the merge overload
    of Optimizer::OptimizeEssentialGraph, Optimizer.cc:5667): relax the
    rest of the merged map over covisibility + chain edges measured on the
    pre-refinement snapshot (snap_R, snap_t), holding ``fixed_ids`` at
    their current poses."""
    kf_ids = m.kf_ids()
    K = len(kf_ids)
    if K < 3:
        return
    slot = {int(x): i for i, x in enumerate(kf_ids)}
    fixed = np.zeros(K, bool)
    for f in fixed_ids:
        if int(f) in slot:
            fixed[slot[int(f)]] = True
    if fixed.all() or not fixed.any():
        return
    ei, ej, eR, et, es, ew = _chain_covis_edges(m, kf_ids, snap_R, snap_t,
                                                covis_edge_min_weight)
    if not ei:
        return
    R_new, t_new, s_new = _solve_essential_graph(
        m.device, m.kf_R[kf_ids].copy(), m.kf_t[kf_ids].copy(),
        np.ones(K, np.float32), fixed, ei, ej, eR, et, es, ew,
        fix_scale=fix_scale, iters=iters)
    if not np.isfinite(t_new).all():
        return
    _apply_pose_graph(m, kf_ids, slot, R_new, t_new, s_new)


def _kf_feat_arrays(m: MapStore, k: int) -> list:
    """The host arrays of keyframe k's features (xy, level, angle, desc,
    valid) for one packed upload."""
    return [m.kf_feat_xy[k], m.kf_feat_level[k], m.kf_feat_angle[k],
            m.kf_feat_desc[k], m.kf_feat_valid[k]]


def _features(xy, level, angle, desc, valid) -> extractor.FrameFeatures:
    return extractor.FrameFeatures(xy=xy, level=level, angle=angle,
                                   score=torch.zeros_like(angle), desc=desc,
                                   valid=valid)


def _padded_pairs(x1, x2, xn1, xn2, device, N: int = 256) -> dict:
    """3D-3D pairs padded to N rows (zeros, masked), uploaded in one go."""
    n = min(len(x1), N)

    def pad(a):
        a = np.asarray(a, np.float32)[:N]
        return np.concatenate([a, np.zeros((N - n, *a.shape[1:]),
                                           np.float32)])

    vmask = np.arange(N) < n
    parts = device_mod.upload_packed([pad(x1), pad(x2), pad(xn1), pad(xn2),
                                      vmask], device)
    return dict(zip(("x1", "x2", "xn1", "xn2", "valid"), parts))


def verify_sim3_pair(mk: MapStore, k: int, mc: MapStore, c: int, cam,
                     cfg: LoopClosingConfig):
    """Geometric verification of a place-recognition pair: descriptor
    matches with map points on both sides (``hamming_best2``, both ways) ->
    batched Horn Sim3 RANSAC on the 3D-3D pairs -> GN refinement -> guided
    projection re-verification. Works within one map (loops) or across two
    (merges) (reference: DetectCommonRegionsFromBoW, LoopClosing.cc:733).
    Returns (c, S_kc), S_kc mapping c-camera points into k's camera frame,
    or None."""
    dev = mk.device
    dk, vk, dc, vc = device_mod.upload_packed(
        [mk.kf_feat_desc[k], mk.kf_feat_valid[k] & (mk.kf_feat_point[k] >= 0),
         mc.kf_feat_desc[c], mc.kf_feat_valid[c] & (mc.kf_feat_point[c] >= 0)],
        dev)
    res = matching.match_nn(dk, vk, dc, vc, max_dist=matching.TH_LOW,
                            ratio=0.9, mutual=True)
    SEARCHES["sim3_match"] += 1
    valid, idx_c = device_mod.fetch_packed([res.valid, res.idx])
    if valid.sum() < cfg.min_bow_matches:
        return None
    fk = np.where(valid)[0]
    fc = idx_c[fk]
    pk = mk.kf_feat_point[k][fk]
    pc = mc.kf_feat_point[c][fc]
    ok = (pk >= 0) & (pc >= 0) & mk.pt_valid[pk] & mc.pt_valid[pc]
    fk, fc, pk, pc = fk[ok], fc[ok], pk[ok], pc[ok]
    if len(fk) < cfg.min_bow_matches:
        return None
    xk = mk.pt_xyz[pk] @ mk.kf_R[k].T + mk.kf_t[k]
    xc = mc.pt_xyz[pc] @ mc.kf_R[c].T + mc.kf_t[c]
    d = _padded_pairs(xk, xc, mk.kf_feat_xyn[k][fk], mc.kf_feat_xyn[c][fc],
                      dev)
    gen = torch.Generator().manual_seed(int(k) * 977 + int(c))
    sets = sample_sets(d["valid"].cpu(), 128, 3, gen)
    s3 = sim3_solver.solve_sim3_ransac(
        d["x1"], d["x2"], d["valid"], d["xn1"], d["xn2"],
        focal=float(cam.fx), min_inliers=cfg.min_sim3_inliers,
        fix_scale=cfg.fix_scale, sample_idx=sets.to(dev))
    # the refinement runs on the RANSAC result either way, so one fetch
    # brings both the RANSAC verdict and the refined Sim3
    ref = sim3_solver.refine_sim3_gn(
        s3.R, s3.t, s3.s, d["x1"], d["x2"], d["xn1"], d["xn2"], d["valid"],
        focal=float(cam.fx), fix_scale=cfg.fix_scale)
    s3_ok, R, t, s, n_ref = device_mod.fetch_packed(
        [s3.ok, ref.R, ref.t, ref.s, ref.n_inliers.to(torch.int32)])
    if not bool(s3_ok) or int(n_ref) < cfg.min_sim3_inliers:
        return None
    S_kc = host_sim3(R, t, s)
    if count_projection_matches(mk, k, mc, c, S_kc, cam) < cfg.min_proj_matches:
        return None
    return c, S_kc


def match_by_projection_pairs(mk: MapStore, k: int, mc: MapStore, c: int,
                              S_kc: Sim3, cam):
    """Project c's local map (at most 2048 points) through S_kc into k and
    run the guided match (``hamming_best2_windowed``). Returns (pt_ids,
    feat_idx): matched c-side point ids and the k-side feature of each."""
    covis_c, _ = mc.covisibility(c, min_weight=10)
    pts = mc.local_point_ids(
        np.asarray([c] + [int(x) for x in covis_c[:10]]))[:2048]
    if len(pts) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    xc = mc.pt_xyz[pts] @ mc.kf_R[c].T + mc.kf_t[c]
    S_R, S_t, S_s = sim3_np(S_kc)
    xk = S_s * (xc @ S_R.T) + S_t
    P = 2048
    pad = P - len(pts)
    xk_p = np.concatenate([xk, np.full((pad, 3), -1.0)]).astype(np.float32)
    vmask = np.arange(P) < len(pts)
    desc = np.concatenate([mc.pt_desc[pts], np.zeros((pad, 8), np.int32)])
    xk_d, vm, desc_d, *feat = device_mod.upload_packed(
        [xk_p, vmask, desc, *_kf_feat_arrays(mk, k)], mk.device)
    uv = cameras.project(cam, xk_d)
    vis = vm & (xk_d[:, 2] > 0.1) & cameras.in_image(cam, uv)
    res = matching.search_by_projection(
        uv, vis, desc_d, torch.zeros(P, dtype=torch.int32, device=mk.device),
        _features(*feat), 8.0, level_lo=-8, level_hi=8,
        max_dist=matching.TH_LOW, ratio=1.0)
    SEARCHES["projection"] += 1
    valid, fidx = device_mod.fetch_packed([res.valid, res.idx])
    sel = np.where(valid)[0]
    return pts[sel], fidx[sel].astype(np.int64)


def count_projection_matches(mk: MapStore, k: int, mc: MapStore, c: int,
                             S_kc: Sim3, cam) -> int:
    """Guided-match count through S_kc (reference nProjMatches gate)."""
    return len(match_by_projection_pairs(mk, k, mc, c, S_kc, cam)[0])
