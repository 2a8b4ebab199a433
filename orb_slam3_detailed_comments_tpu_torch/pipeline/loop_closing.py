"""Loop closing: place-recognition candidates -> Sim3 verification ->
loop correction -> essential-graph optimisation -> global BA; the visual
path.

Counterpart of ``pipeline/loop_closing.py`` of the JAX package (reference:
the LoopClosing thread, src/LoopClosing.cc:100 Run, NewDetectCommonRegions
:383, CorrectLoop :1273). Host code orchestrates on the numpy map, as in
the JAX package; descriptor matching (``hamming_best2`` and
``hamming_best2_windowed``), the Sim3 RANSAC and refinement, the pose graph
and global BA run on the map's device.

On an inertial map whose IMU is initialised: a correction must be
near-planar in the gravity-aligned world (the gravity gate of
CorrectLoop), the essential graph is the 4DoF one (yaw and translation)
and rotates the keyframes' velocities with their poses, the global BA
after the correction is the full inertial BA, and a Sim3 whose scale
strays from 1 is refused (the map is metric).

The global BA after a correction runs inline (``gba_rounds`` bundle
adjustments over every keyframe, ``ba.ba_solve`` routing them by camera
count, or one full inertial BA), or with ``async_gba`` and a map lock on a
thread of its own that races tracking and mapping (reference:
RunGlobalBundleAdjustment's thread and its mbStopGBA abort flag): the
snapshot is solved in chunks of ``gba_chunk`` iterations with an abort
check between chunks, and the result is applied under the map lock with
the drift carried to keyframes and points born during the solve
(``apply_gba_with_propagation``). With ``dist_gba`` (the default) and a
process group of several ranks (``group``), the racing global BA shards
its observations over the group, as the JAX package shards them over its
devices: the matrix-free PCG above ``ba._PCG_C_MIN`` cameras, sharded
Schur steps and a one-process polish below it, the sharded full inertial
BA on an inertial map (``parallel/dist_ba``; rank 0 runs the loop closer
and leads, the other ranks ``dist_ba.serve``). Only the global BA's thread
runs collectives; without a group, or with a group of one rank, the
solve is this process's alone.

The RANSAC minimal sets are drawn on the host from a generator seeded by
the keyframe pair and uploaded, so the card and the CPU verify a pair on
the same sets.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import comm, device as device_mod
from ..lie import SE3, Sim3, so3
from ..mapping.mapstore import NO_POINT, MapStore
from ..models import cameras
from ..ops import extractor, matching
from ..optim import ba, pose_graph, vi_ba
from ..parallel import dist_ba
from ..placerec import sim3_solver
from ..placerec.keyframe_db import KeyFrameDatabase
from ..placerec.pnp import sample_sets
from ..utils import timing
from ..utils.counters import Counts
from . import inertial, kernels
from .local_mapping import build_ba_problem, full_obs_cap, run_local_ba

# descriptor searches issued by place recognition, by caller: each
# "sim3_match" and "reloc_match" is a mutual match_nn (two hamming_best2
# launches), each other one search_by_projection (one
# hamming_best2_windowed launch); the System's relocalisation adds its own
SEARCHES = Counts("sim3_match", "projection", "loop_fuse", "reloc_match",
                  "reloc_search")


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
    async_gba: bool = False       # race the GBA against tracking on a thread
    gba_chunk: int = 5            # LM iterations between abort checks
    dist_gba: bool = True         # shard the racing GBA's observations
                                  # over the loop closer's process group
                                  # when it has more than one rank


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
                 cfg: LoopClosingConfig = LoopClosingConfig(), group=None):
        self.map = mapstore
        self.cam = cam
        self.kfdb = kfdb
        self.cfg = cfg
        self.group = group     # the sharded global BA's process group
        self.active: _ActiveCandidate | None = None
        self.n_loops_closed = 0
        self.n_loops_rejected_projgate = 0
        self.n_processed = 0
        self.cooldown_until = 0
        self.n_gba_runs = 0
        self.n_gba_aborted = 0
        self.n_loops_rejected_gravity = 0
        self.imu_calib = None          # set by the System on inertial sensors
        # the racing global BA: the map lock it applies under (set by the
        # System in async mode), its thread, the running thread's abort
        # flag, and one record per solve (its kind, camera count, seconds
        # on its thread, outcome)
        self.map_lock = None
        self._gba_thread = None
        self._gba_abort = threading.Event()
        self.gba_log: list = []
        # the outcome of the run on this thread: another run may apply
        # while this one is deciding, so the shared counts cannot say
        self._run = threading.local()
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
        """(reference: LoopClosing::CorrectLoop, LoopClosing.cc:1273).
        False when the inertial gravity gate refuses the correction (BAD
        LOOP, LoopClosing.cc:282-305)."""
        m = self.map
        S_kw_corr = S_kc.compose(host_sim3(m.kf_R[match_kf],
                                           m.kf_t[match_kf]))
        if m.imu_initialized:
            # the world correction S_ww = T_wc_old ∘ S_cw_corr must be
            # near-planar in the gravity-aligned world: refused past 0.008
            # rad of roll / pitch or 0.349 rad of yaw; after VIBA2 forced
            # to yaw only at unit scale (LoopClosing.cc:270-305)
            T_wc_old = host_sim3(m.kf_R[k], m.kf_t[k]).inverse()
            S_ww = T_wc_old.compose(S_kw_corr)
            phi = so3.log(S_ww.R).clone()
            if not (abs(float(phi[0])) < 0.008 and abs(float(phi[1])) < 0.008
                    and abs(float(phi[2])) < 0.349):
                self.n_loops_rejected_gravity += 1
                return False
            if m.imu_ba2:
                phi[0:2] = 0.0
                S_ww = host_sim3(so3.exp(phi), S_ww.t, 1.0)
                S_kw_corr = T_wc_old.inverse().compose(S_ww)
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
            inertial=m.imu_initialized, fix_scale=self.cfg.fix_scale)
        _apply_pose_graph(m, kf_ids, slot, R_new, t_new, s_new)

        self._fuse_loop_points(k, match_kf)
        m.update_point_stats(np.where(m.pt_valid)[0])

        self.last_correction = dict(k=int(k), match_kf=int(match_kf),
                                    n_kf=int(K), gba=[])
        if not self.cfg.run_global_ba:
            return True
        window = [int(x) for x in m.kf_ids()]
        anchor = [match_kf] if match_kf in window else window[:1]
        if self.cfg.async_gba and self.map_lock is not None:
            self._launch_global_ba(window, anchor)
        elif m.imu_initialized and self.imu_calib is not None:
            # FullInertialBA on inertial maps (LoopClosing.cc:2886-2890)
            C = inertial.run_full_inertial_ba(
                m, self.cam, iters=self.cfg.gba_iters,
                max_points=m.cfg.max_pt // 2, max_obs=full_obs_cap(m),
                calib=self.imu_calib)
            self.last_correction["gba"].append(dict(C=C, tier="inertial"))
            self.n_gba_runs += 1
        else:
            for _ in range(self.cfg.gba_rounds):
                C = run_local_ba(m, window, fixed=anchor, cam=self.cam,
                                 iters=self.cfg.gba_iters,
                                 max_points=m.cfg.max_pt // 2,
                                 max_obs=full_obs_cap(m))
                self.last_correction["gba"].append(
                    dict(C=C, tier=ba.tier_of(C)))
            self.n_gba_runs += 1
        return True

    # -------------------------------------------------------------- GBA
    def _launch_global_ba(self, window, anchor):
        """Snapshot the map into a BA problem (under the caller's map lock)
        and solve it on a thread that races tracking and mapping; a run
        still going is aborted first (mbStopGBA). On an initialised
        inertial map the problem is the full-chain visual-inertial one
        (FullInertialBA on mpThreadGBA). The reference launches mpThreadGBA
        from CorrectLoop (LoopClosing.cc:1530-1620)."""
        self.abort_gba()
        m = self.map
        if m.imu_initialized and self.imu_calib is not None:
            chain = [int(k) for k in m.temporal_chain()]
            built = inertial.build_full_viba_problem(
                m, chain, self.imu_calib, max_points=m.cfg.max_pt // 2,
                max_obs=full_obs_cap(m))
            target = self._gba_worker_inertial
        else:
            built = build_ba_problem(m, window, fixed=anchor,
                                     max_points=m.cfg.max_pt // 2,
                                     max_obs=full_obs_cap(m))
            target = self._gba_worker
        if built is None:
            return
        prob, meta = built
        # each run reads its own flag: a run that outlived abort_gba's join
        # still sees its abort after the next launch replaced the flag
        abort = self._gba_abort = threading.Event()
        self._gba_thread = threading.Thread(
            target=self._gba_thread_main,
            args=(target, m, prob, meta, abort), daemon=True)
        self._gba_thread.start()

    def _gba_thread_main(self, target, m: MapStore, prob, meta,
                         abort: threading.Event):
        """Run one GBA worker and log its camera count, time and
        outcome."""
        t0 = time.perf_counter()
        self._run.applied = False
        target(m, prob, meta, abort)
        self.gba_log.append(dict(
            kind=("inertial" if target == self._gba_worker_inertial
                  else "visual"), C=int(meta["n_real"]),
            seconds=time.perf_counter() - t0,
            applied=self._run.applied, aborted=not self._run.applied))

    def _apply_under_lock(self, apply, abort: threading.Event) -> None:
        """Take the map lock with a timeout, so that an aborter that holds
        the lock and joins this thread cannot deadlock against it, and
        apply the result unless the run was aborted meanwhile."""
        while not self.map_lock.acquire(timeout=0.1):
            if abort.is_set():
                self.n_gba_aborted += 1
                return
        try:
            if abort.is_set():
                self.n_gba_aborted += 1
                return
            apply()
            self.n_gba_runs += 1
            self._run.applied = True
        finally:
            self.map_lock.release()

    def gba_group(self, n_obs: int):
        """The process group the racing global BA shards n_obs observations
        over: the loop closer's when ``dist_gba`` holds, it has more than
        one rank and n_obs splits evenly over them; else None, the
        one-process solve (the JAX code's ``single``)."""
        group = comm.active(self.group)
        if (not self.cfg.dist_gba or group is None
                or n_obs % comm.world_size(group)):
            return None
        return group

    def _gba_worker(self, m: MapStore, prob, meta, abort: threading.Event):
        """Chunks of ``ba_solve_fused`` with an abort check between them
        (the reference checks mbStopGBA each iteration; a chunk is the
        port's grain, and LM restarts its damping each chunk as in the JAX
        package), then the apply under the map lock. Sharded over
        ``gba_group``: chunks of the sharded PCG above ``ba._PCG_C_MIN``
        cameras; below it sharded Schur steps, one between abort checks,
        then a one-process polish of one iteration, which also gives the
        inlier verdicts."""
        res = None
        done = 0
        td = meta.get("table_depth", 0)
        group = self.gba_group(int(prob.obs_cam.shape[0]))
        if group is None:
            while done < self.cfg.gba_iters and not abort.is_set():
                res = ba.ba_solve_fused(prob, self.cam,
                                        iters=self.cfg.gba_chunk,
                                        table_depth=td)
                prob = prob._replace(kf_R=res.kf_R, kf_t=res.kf_t,
                                     points=res.points)
                done += self.cfg.gba_chunk
        elif int(prob.kf_R.shape[0]) > ba._PCG_C_MIN:
            solve = dist_ba.make_dist_gba_pcg(
                self.cam, group, iters=self.cfg.gba_chunk, lead=True)
            while done < self.cfg.gba_iters and not abort.is_set():
                res = solve(prob)
                prob = prob._replace(kf_R=res.kf_R, kf_t=res.kf_t,
                                     points=res.points)
                done += self.cfg.gba_chunk
        else:
            step = dist_ba.make_dist_ba_step(self.cam, group, lead=True)
            while (done < max(self.cfg.gba_iters - 1, 1)
                   and not abort.is_set()):
                R, t, pts = step(prob.kf_R, prob.kf_t, prob.points,
                                 prob.obs_cam, prob.obs_pt, prob.obs_uv,
                                 prob.obs_w, prob.obs_valid, prob.fixed_cam,
                                 prob.point_valid)
                prob = prob._replace(kf_R=R, kf_t=t, points=pts)
                done += 1
            if not abort.is_set():
                res = ba.ba_solve_fused(prob, self.cam, iters=1,
                                        table_depth=td)
        if res is None or abort.is_set():
            self.n_gba_aborted += 1
            return
        self._apply_under_lock(
            lambda: apply_gba_with_propagation(m, meta, res), abort)

    def _gba_worker_inertial(self, m: MapStore, prob, meta,
                             abort: threading.Event):
        """The same protocol over chunks of the full-chain visual-inertial
        BA (``vi_ba_solve`` at zero bias priors, as the JAX worker), its
        visual observations sharded over ``gba_group``."""
        R_cb, t_cb = device_mod.upload_packed(
            [np.ascontiguousarray(meta["R_bc"].T), meta["t_cb"]], m.device)
        g = inertial.gravity_vec(m.device)
        res = None
        done = 0
        group = self.gba_group(int(prob.obs_cam.shape[0]))
        if group is None:
            solve = lambda p: vi_ba.vi_ba_solve(p, self.cam, R_cb, t_cb, g,
                                                iters=self.cfg.gba_chunk)
        else:
            dist = dist_ba.make_dist_viba_solve(
                self.cam, group, iters=self.cfg.gba_chunk, lead=True)
            solve = lambda p: dist(p, R_cb, t_cb, g)
        while done < self.cfg.gba_iters and not abort.is_set():
            res = solve(prob)
            prob = prob._replace(R_wb=res.R_wb, p_w=res.p_w, v_w=res.v_w,
                                 bg=res.bg, ba=res.ba, points=res.points)
            done += self.cfg.gba_chunk
        if res is None or abort.is_set():
            self.n_gba_aborted += 1
            return
        self._apply_under_lock(
            lambda: apply_vi_gba_with_propagation(m, meta, res), abort)

    def abort_gba(self):
        """Stop a running global BA and discard its result (mbStopGBA)."""
        if self._gba_thread is not None and self._gba_thread.is_alive():
            self._gba_abort.set()
            self._gba_thread.join(timeout=120)
        self._gba_thread = None

    def wait_gba(self):
        """Block until a running global BA has finished and applied."""
        if self._gba_thread is not None:
            self._gba_thread.join(timeout=600)
            self._gba_thread = None

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
            SEARCHES.bump("loop_fuse")
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
                           fix_scale: bool, iters: int = 15,
                           inertial: bool = False):
    """Pad a pose-graph problem to the JAX package's buckets (K to 16, E to
    128; padded states fixed, padded edges of weight 0) and solve it on the
    device: the Sim3 graph, or on a gravity-aligned inertial map the 4DoF
    one (yaw + translation, OptimizeEssentialGraph4DoF), whose edges take
    the Sim3 measurement's translation over its scale. Returns (R, t, s)
    numpy arrays of the K real keyframes."""
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
    up = device_mod.upload_packed(arrays, device)
    if inertial:
        R0d, t0d, _, eid, ejd, eRd, etd, esd, ewd, fxd = up
        res = pose_graph.optimize_4dof_graph(
            R0d, t0d, eid, ejd, eRd,
            etd / torch.clamp(esd[:, None], min=1e-9), ewd, fxd, iters=iters)
    else:
        res = pose_graph.optimize_sim3_graph(*up, iters=iters,
                                             fix_scale=fix_scale)
    R, t, s = device_mod.fetch_packed([res.R, res.t, res.s])
    return R[:K], t[:K], s[:K]


def _apply_pose_graph(m: MapStore, kf_ids, slot, R_new, t_new, s_new):
    """Write optimised keyframe similarities into the SE3 map (scale folded
    into translation), carry each point with its reference keyframe's
    correction (reference: CorrectLoop's eigSwc point update) and, on an
    inertial map, rotate each keyframe's velocity with its pose correction
    (the Rcor velocity updates: v' = R_new^T R_old v)."""
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
    if m.imu_initialized:
        Rcor = np.einsum("nji,njk->nik", R_new, m.kf_R[kf_ids])
        m.kf_vel[kf_ids] = np.einsum("nij,nj->ni", Rcor, m.kf_vel[kf_ids])
    m.kf_R[kf_ids] = R_new
    m.kf_t[kf_ids] = t_new / np.maximum(s_new[:, None], 1e-9)
    m.version += 1
    m.big_change_idx += 1


def run_merge_essential_graph(m: MapStore, snap_R, snap_t, fixed_ids,
                              inertial: bool = False,
                              fix_scale: bool = False,
                              covis_edge_min_weight: int = 100,
                              iters: int = 15):
    """Merge variant of the essential graph (reference: the merge overload
    of Optimizer::OptimizeEssentialGraph, Optimizer.cc:5667): relax the
    rest of the merged map over covisibility + chain edges measured on the
    pre-refinement snapshot (snap_R, snap_t), holding ``fixed_ids`` at
    their current poses; the 4DoF graph where ``inertial``."""
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
        fix_scale=fix_scale, iters=iters, inertial=inertial)
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
    SEARCHES.bump("sim3_match")
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
    sets = sample_sets(device_mod.to_device(d["valid"], "cpu"), 128, 3, gen)
    s3 = sim3_solver.solve_sim3_ransac(
        d["x1"], d["x2"], d["valid"], d["xn1"], d["xn2"],
        focal=float(cam.fx), min_inliers=cfg.min_sim3_inliers,
        fix_scale=cfg.fix_scale,
        sample_idx=device_mod.to_device(sets, dev))
    # the refinement runs on the RANSAC result either way, so one fetch
    # brings both the RANSAC verdict and the refined Sim3
    ref = sim3_solver.refine_sim3_gn(
        s3.R, s3.t, s3.s, d["x1"], d["x2"], d["xn1"], d["xn2"], d["valid"],
        focal=float(cam.fx), fix_scale=cfg.fix_scale)
    s3_ok, R, t, s, n_ref = device_mod.fetch_packed(
        [s3.ok, ref.R, ref.t, ref.s, ref.n_inliers.to(torch.int32)])
    if not bool(s3_ok) or int(n_ref) < cfg.min_sim3_inliers:
        return None
    # inertial maps are metric: a scale far from 1 is spurious
    # (LoopClosing.cc:168, the [0.90, 1.1] gate)
    if (mk.imu_initialized and mc.imu_initialized
            and not 0.90 <= float(s) <= 1.1):
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
    SEARCHES.bump("projection")
    valid, fidx = device_mod.fetch_packed([res.valid, res.idx])
    sel = np.where(valid)[0]
    return pts[sel], fidx[sel].astype(np.int64)


def count_projection_matches(mk: MapStore, k: int, mc: MapStore, c: int,
                             S_kc: Sim3, cam) -> int:
    """Guided-match count through S_kc (reference nProjMatches gate)."""
    return len(match_by_projection_pairs(mk, k, mc, c, S_kc, cam)[0])


def _host(parts) -> list:
    """numpy arrays of tensors (one packed fetch) or of host arrays."""
    if all(isinstance(p, torch.Tensor) for p in parts):
        return device_mod.fetch_packed(parts)
    return [device_mod.to_device(p, "cpu").numpy()
            if isinstance(p, torch.Tensor) else np.asarray(p) for p in parts]


def apply_vi_gba_with_propagation(m: MapStore, meta: dict, res):
    """Apply a full-chain inertial GBA result (body states) with the
    visual path's propagation to late keyframes and points, writing back
    velocities and biases (reference: the mVwbGBA handling of
    RunGlobalBundleAdjustment, LoopClosing.cc:2940-3050). Nothing happens
    on a non-finite solve."""
    n_real = meta["n_real"]
    R_wb, p_w, v_w, bg_o, ba_o, points, inl = _host(
        [res.R_wb, res.p_w, res.v_w, res.bg, res.ba, res.points,
         res.obs_inlier])
    if not np.isfinite(p_w[:n_real]).all():
        return
    kf_R = np.empty((n_real, 3, 3), np.float32)
    kf_t = np.empty((n_real, 3), np.float32)
    for i in range(n_real):
        kf_R[i], kf_t[i] = inertial.camera_from_body(
            R_wb[i], p_w[i], meta["R_bc"], meta["t_bc"])
    apply_gba_with_propagation(
        m, meta, ba.BAResult(kf_R=kf_R, kf_t=kf_t, points=points,
                             obs_inlier=inl, cost=None),
        vi=(v_w[:n_real], bg_o[:n_real], ba_o[:n_real]))


def apply_gba_with_propagation(m: MapStore, meta: dict, res, vi=None):
    """Write a finished global-BA result into a map that kept changing
    while the solve ran (reference: the correction loop at the end of
    LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cc:1530-1620).

    Keyframes and points of the snapshot take the solved values. A
    keyframe born during the solve is corrected through its temporal
    predecessor (else the nearest corrected keyframe before it), in id
    order: T_c_new = T_c_bef inv(T_a_bef) T_a_new. A point outside the
    snapshot rides its reference keyframe: x_new = Twc_ref_new Tcw_ref_bef
    x. Observations the solve found to be outliers are detached, and a
    point left with none dies.

    vi: optional (vel, bg, ba) aligned with meta["cams"]: the snapshot's
    keyframes take them, a late keyframe's world velocity turns with its
    pose correction."""
    cams, n_real = meta["cams"], meta["n_real"]
    pt_ids = np.asarray(meta["pt_ids"])
    bef_R, bef_t = m.kf_R.copy(), m.kf_t.copy()
    new_R, new_t = m.kf_R.copy(), m.kf_t.copy()
    gR, gt, g_points, g_inl = _host([res.kf_R, res.kf_t, res.points,
                                     res.obs_inlier])
    gR, gt = gR[:n_real], gt[:n_real]
    done = np.zeros(m.cfg.max_kf, bool)
    for i, c in enumerate(cams):
        if m.kf_valid[c]:
            new_R[c], new_t[c] = gR[i], gt[i]
            done[c] = True
    if not done.any():
        return

    late = []
    for c in np.where(m.kf_valid & ~done)[0]:
        a = int(m.kf_prev[c])
        if a < 0 or not done[a]:
            smaller = np.where(done[:c])[0]
            if len(smaller) == 0:
                continue
            a = int(smaller[-1])
        Rrel = bef_R[c] @ bef_R[a].T
        trel = bef_t[c] - Rrel @ bef_t[a]
        new_R[c] = Rrel @ new_R[a]
        new_t[c] = Rrel @ new_t[a] + trel
        done[c] = True
        late.append(c)

    if vi is not None:
        v_all, bg_all, ba_all = vi
        for i, c in enumerate(cams):
            if m.kf_valid[c]:
                m.kf_vel[c] = v_all[i]
                m.kf_bg[c] = bg_all[i]
                m.kf_ba[c] = ba_all[i]
        for c in late:
            m.kf_vel[c] = (new_R[c].T @ bef_R[c]) @ m.kf_vel[c]

    alive = m.pt_valid[pt_ids]
    m.pt_xyz[pt_ids[alive]] = g_points[: len(pt_ids)][alive]
    others = np.setdiff1d(np.where(m.pt_valid)[0], pt_ids)
    if len(others):
        r = m.pt_ref_kf[others]
        ok = (r >= 0) & done[np.maximum(r, 0)]
        r = np.maximum(r, 0)
        xc = np.einsum("nij,nj->ni", bef_R[r], m.pt_xyz[others]) + bef_t[r]
        xn = np.einsum("nji,nj->ni", new_R[r], xc - new_t[r])
        m.pt_xyz[others[ok]] = xn[ok]

    m.kf_R[:], m.kf_t[:] = new_R, new_t

    # detach the outlier observations the solve found (Optimizer.cc:2040)
    inl = g_inl[: len(meta["keep"])]
    inv_cam = {i: c for c, i in meta["cam_slot"].items()}
    inv_pt = {i: p for p, i in meta["pt_slot"].items()}
    touched = set()
    for o in np.where(~inl)[0]:
        c = inv_cam[int(meta["oc"][o])]
        pid = inv_pt[int(meta["op"][o])]
        m.kf_feat_point[c, m.kf_feat_point[c] == pid] = NO_POINT
        touched.add(pid)
    if touched:
        tl = np.asarray(sorted(touched))
        tl = tl[m.pt_valid[tl]]
        if len(tl):
            obs = m.observation_counts()
            m.remove_points(tl[obs[tl] == 0])
    m.version += 1
    m.big_change_idx += 1
