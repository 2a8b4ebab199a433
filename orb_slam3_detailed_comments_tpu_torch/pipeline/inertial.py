"""Visual-inertial pipeline pieces: per-frame IMU handling, state
prediction, the IMU initialisation and the inertial bundle adjustments.

Counterpart of ``pipeline/inertial.py`` of the JAX package (reference: the
inertial halves of Tracking, PreintegrateIMU Tracking.cc:1739,
PredictStateIMU 1892, UpdateFrameIMU 4769, and of LocalMapping,
InitializeIMU LocalMapping.cc:1516 with the VIBA1 / VIBA2 schedule at
236-310), built on ``imu/`` and ``optim/vi_ba.py``.

Frames: the map stores CAMERA poses (T_cw); inertial quantities live on the
BODY. calib.R_bc / t_bc is the camera in the body (x_b = R_bc x_c + t_bc,
the reference's Tbc). The host assembles each problem from the numpy map
and uploads it in one packed copy; the solve runs on the map's device and
its result comes back in one packed fetch. Where the JAX code pads a
problem to compile buckets (cameras to 8, edges to ``e_cap``, points and
observations to their caps), the port builds it at its real size: padded
rows add nothing to any sum, so the solution is the same.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..imu import inertial_init, preintegration as pre_mod
from ..imu.preintegration import ImuCalib, Preintegrated
from ..lie import SE3
from ..mapping.mapstore import MapStore
from ..optim import vi_ba

MAX_SAMPLES_PER_FRAME = 64
GRAVITY_MAG = 9.81
# the camera count of a full-map problem is rounded up to a multiple of this
# for its edge capacity (the JAX package's compile bucket)
_FULL_C_BUCKET = 16


@dataclass
class ImuFrameState:
    """Tracker-side inertial bookkeeping; the windows are on the device."""
    calib: ImuCalib
    pre_since_kf: Optional[Preintegrated] = None    # since the last keyframe
    pre_last_frame: Optional[Preintegrated] = None  # the last frame's window
    bg: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ba: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    v_w: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    t_first_kf: float = 0.0


@functools.lru_cache(maxsize=None)
def gravity_vec(device) -> torch.Tensor:
    """World gravity [3] on the device, uploaded once."""
    return torch.tensor([0.0, 0.0, -GRAVITY_MAG], dtype=torch.float32,
                        device=device)


def integrate_frame_window(calib: ImuCalib, gyro: np.ndarray, acc: np.ndarray,
                           dts: np.ndarray, bg, ba, device) -> Preintegrated:
    """Preintegrate one frame gap on the device (reference:
    PreintegrateIMU): the samples and biases go up in one packed copy;
    a gap longer than ``MAX_SAMPLES_PER_FRAME`` samples is integrated in
    chunks that are merged, as in the JAX code."""
    n = len(dts)
    cap = MAX_SAMPLES_PER_FRAME
    if n > cap:
        out = None
        for s in range(0, n, cap):
            p = integrate_frame_window(calib, gyro[s:s + cap], acc[s:s + cap],
                                       dts[s:s + cap], bg, ba, device)
            out = p if out is None else pre_mod.merge(out, p)
        return out
    a, g, d, bg_d, ba_d = device_mod.upload_packed(
        [np.asarray(acc, np.float32), np.asarray(gyro, np.float32),
         np.asarray(dts, np.float32), np.asarray(bg, np.float32),
         np.asarray(ba, np.float32)], device)
    return pre_mod.integrate(a, g, d, calib, bg0=bg_d, ba0=ba_d)


def extrinsic(calib: Optional[ImuCalib]):
    """(R_bc, t_bc) as float32 numpy; identity when unset."""
    if calib is None:
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R_bc = (np.asarray(calib.R_bc) if calib.R_bc is not None
            else np.eye(3))
    t_bc = (np.asarray(calib.t_bc) if calib.t_bc is not None
            else np.zeros(3))
    return R_bc.astype(np.float32), t_bc.astype(np.float32)


def body_from_camera(R_cw, t_cw, R_bc, t_bc):
    """T_cw (world -> camera) -> body state (R_wb, p_wb), on the host."""
    R_cb = R_bc.T
    t_cb = -R_cb @ t_bc
    R_cw = np.asarray(R_cw)
    R_wb = (R_bc @ R_cw).T
    p_wb = R_cw.T @ (t_cb - np.asarray(t_cw))
    return R_wb.astype(np.float32), p_wb.astype(np.float32)


def camera_from_body(R_wb, p_wb, R_bc, t_bc):
    """Body state -> T_cw (R_cw, t_cw), on the host."""
    R_cb = R_bc.T
    t_cb = -R_cb @ t_bc
    R_cw = R_cb @ np.asarray(R_wb).T
    t_cw = t_cb - R_cw @ np.asarray(p_wb)
    return R_cw.astype(np.float32), t_cw.astype(np.float32)


def predict_pose_imu(R_cw, t_cw, v_w, bg, ba, R_bc, t_bc, pre: Preintegrated,
                     g):
    """The dead-reckoned camera pose and velocity of the next frame from
    the last frame's state, all tensors on the device (reference:
    Tracking::PredictStateIMU): body_from_camera -> predict_state ->
    camera_from_body. Returns (SE3, v [3])."""
    R_cb = R_bc.T
    t_cb = -R_cb @ t_bc
    R_wb = (R_bc @ R_cw).T
    p_wb = R_cw.T @ (t_cb - t_cw)
    R2, v2, p2 = pre_mod.predict_state(R_wb, v_w, p_wb, pre, bg, ba, g)
    R_cw2 = R_cb @ R2.T
    return SE3(R_cw2, t_cb - R_cw2 @ p2), v2


def _chain_bodies(m: MapStore, kfs, calib):
    """Body rotations and positions [K] of keyframes kfs (host)."""
    R_bc, t_bc = extrinsic(calib)
    t_cb = -R_bc.T @ t_bc
    R_wb = np.transpose(np.einsum("ij,kjl->kil", R_bc, m.kf_R[kfs]),
                        (0, 2, 1))
    centers = -np.einsum("kij,ki->kj", m.kf_R[kfs], m.kf_t[kfs])
    p_body = centers + np.einsum("kji,j->ki", m.kf_R[kfs], t_cb)
    return R_wb.astype(np.float32), p_body.astype(np.float32)


def try_initialize_imu(m: MapStore, min_kf: int = 8, min_time: float = 1.0,
                       prior_gyro: float = 1e2, prior_acc: float = 1e6,
                       fix_scale: bool = False,
                       calib: Optional[ImuCalib] = None):
    """IMU initialisation: the gravity / scale / bias / velocity solve, then
    the map's change of frame (reference: LocalMapping::InitializeIMU +
    Map::ApplyScaledRotation). Returns (R_wg, scale) of the applied world
    transform, or None. The chain is padded to a multiple of 8 keyframes
    (padded edges masked) as in the JAX code, so the solve sees the same
    problem."""
    chain = m.temporal_chain()
    if len(chain) < min_kf:
        return None
    if m.kf_ts[chain[-1]] - m.kf_ts[chain[0]] < min_time:
        return None
    for a, b in zip(chain[:-1], chain[1:]):
        if m.kf_prev[b] != a or m.kf_pre_dT[b] <= 0:
            return None
    K = len(chain)
    Kb = max(8, 8 * int(np.ceil(K / 8.0)))
    pad = Kb - K
    R_wb, p_body = _chain_bodies(m, chain, calib)
    pre_ids = np.concatenate([chain[1:], np.repeat(chain[-1:], pad)])
    R_wb = np.concatenate([R_wb, np.repeat(R_wb[-1:], pad, 0)])
    p_body = np.concatenate([p_body, np.repeat(p_body[-1:], pad, 0)])
    edge_valid = np.concatenate([np.ones(K - 1, np.float32),
                                 np.zeros(pad, np.float32)])
    pres = m.get_kf_preintegration(pre_ids)
    R_d, p_d, ev_d = device_mod.upload_packed([R_wb, p_body, edge_valid],
                                              m.device)
    R_wg0 = inertial_init.initial_gravity_estimate(R_d, pres,
                                                   edge_valid=ev_d)
    res = inertial_init.inertial_optimization(
        R_d, p_d, pres, R_wg0, prior_gyro=prior_gyro, prior_acc=prior_acc,
        iters=25, fix_scale=fix_scale, edge_valid=ev_d)
    s, R_wg, vels, bg, ba = device_mod.fetch_packed(
        [res.scale, res.R_wg, res.velocities, res.bg, res.ba])
    s = float(s)
    if not np.isfinite(s) or s < 0.02 or s > 50.0:
        return None
    apply_scaled_rotation(m, R_wg, s)
    # velocities rotate into the gravity-aligned world (padding dropped)
    m.kf_vel[chain] = np.einsum("ji,kj->ki", R_wg, vels[:K])
    m.kf_bg[chain] = bg
    m.kf_ba[chain] = ba
    m.imu_initialized = True
    m.version += 1
    return R_wg, s


def apply_scaled_rotation(m: MapStore, R_wg: np.ndarray, s: float):
    """The world transform x' = s R_wg^T x applied to the whole map
    (reference: Map::ApplyScaledRotation): R_cw' = R_cw R_wg, t_cw' = s t_cw,
    points and velocities transformed, camera-frame distances scaled. The
    version bump re-uploads the device mirrors before the next frame."""
    ids = m.kf_ids()
    m.kf_R[ids] = np.einsum("kij,jl->kil", m.kf_R[ids], R_wg)
    m.kf_t[ids] = s * m.kf_t[ids]
    m.kf_vel[ids] = s * m.kf_vel[ids] @ R_wg
    pv = m.pt_valid
    m.pt_xyz[pv] = s * m.pt_xyz[pv] @ R_wg
    m.pt_min_dist[pv] *= s
    m.pt_max_dist[pv] *= s
    m.pt_normal[pv] = m.pt_normal[pv] @ R_wg
    # culled-keyframe tombstones hold relative poses: t scales
    m.tombstones = {key: (sid, ep, R_rel, s * t_rel)
                    for key, (sid, ep, R_rel, t_rel) in m.tombstones.items()}
    m.version += 1


def build_viba_problem(m: MapStore, kfs: list, fix: set,
                       calib: Optional[ImuCalib], max_points: int = 2048,
                       max_obs: int = 8192, e_cap: int = 24):
    """A keyframe set as a VIBAProblem on the map's device plus host
    metadata. kfs: keyframes in time order; fix: those held fixed. At most
    max_points points, max_obs observations (a seeded subsample, as in the
    JAX code) and the newest e_cap inertial edges."""
    n_real = len(kfs)
    slot = {int(k): i for i, k in enumerate(kfs)}
    pt_ids = m.local_point_ids(np.asarray(kfs))[:max_points]
    if len(pt_ids) < 30:
        return None
    pt_slot = {int(p): i for i, p in enumerate(pt_ids)}
    sf2 = (m.cfg.scale ** np.arange(m.cfg.n_levels)) ** 2
    lut = np.full(m.cfg.max_pt, -1, np.int32)
    lut[pt_ids] = np.arange(len(pt_ids), dtype=np.int32)
    fp_all = m.kf_feat_point[kfs]
    slot_of = lut[np.maximum(fp_all, 0)]
    ci, fi = np.nonzero((fp_all >= 0) & (slot_of >= 0))
    O = len(ci)
    if O < 50:
        return None
    keep = (np.random.default_rng(0).choice(O, max_obs, replace=False)
            if O > max_obs else np.arange(O))
    oc = ci.astype(np.int32)[keep]
    op = slot_of[ci, fi][keep]
    ouv = m.kf_feat_xy[kfs][ci, fi].astype(np.float32)[keep]
    ow = (1.0 / sf2[m.kf_feat_level[kfs][ci, fi]]).astype(np.float32)[keep]

    # inertial edges: consecutive pairs linked by a live window
    ei, ej, pre_list = [], [], []
    for a, b in zip(kfs[:-1], kfs[1:]):
        if m.kf_prev[b] == a and m.kf_pre_dT[b] > 0:
            ei.append(slot[int(a)])
            ej.append(slot[int(b)])
            pre_list.append(int(b))
    if not pre_list:
        return None
    ei, ej, pre_list = ei[-e_cap:], ej[-e_cap:], pre_list[-e_cap:]

    R_bc, t_bc = extrinsic(calib)
    t_cb = (-R_bc.T @ t_bc).astype(np.float32)
    R_wb, p_w = _chain_bodies(m, list(kfs), calib)
    fixed = np.asarray([int(k) in set(int(x) for x in fix) for k in kfs],
                       bool)
    up = device_mod.upload_packed(
        [R_wb, p_w, m.kf_vel[kfs], m.kf_bg[kfs], m.kf_ba[kfs],
         m.pt_xyz[pt_ids], np.ones(len(pt_ids), bool), oc, op, ouv, ow,
         np.ones(len(keep), bool), np.asarray(ei, np.int32),
         np.asarray(ej, np.int32), np.ones(len(ei), bool), fixed], m.device)
    prob = vi_ba.VIBAProblem(
        *up[:12], edge_i=up[12], edge_j=up[13],
        edge_pre=m.get_kf_preintegration(pre_list), edge_valid=up[14],
        fixed_cam=up[15])
    meta = dict(cams=[int(k) for k in kfs], n_real=n_real, pt_ids=pt_ids,
                keep=keep, oc=oc, op=op, cam_slot=slot, pt_slot=pt_slot,
                fixed=fixed, R_bc=R_bc, t_bc=t_bc, t_cb=t_cb)
    return prob, meta


def build_full_viba_problem(m: MapStore, kfs: list,
                            calib: Optional[ImuCalib],
                            max_points: int = 4096, max_obs: int = 16384):
    """The whole chain: gauge fixed at the oldest keyframe; the edge
    capacity rounds up with the chain as in the JAX code."""
    e_cap = max(_FULL_C_BUCKET * int(np.ceil(len(kfs) / _FULL_C_BUCKET)), 8)
    return build_viba_problem(m, kfs, {int(kfs[0])}, calib,
                              max_points=max_points, max_obs=max_obs,
                              e_cap=e_cap)


def apply_viba_result(m: MapStore, meta: dict, res) -> bool:
    """Write a VIBAResult back (body states -> camera poses, velocities,
    biases, points) from one packed fetch. False on a non-finite solve."""
    kfs, n_real, pt_ids = meta["cams"], meta["n_real"], meta["pt_ids"]
    p_all, R_all, v_all, bg_all, ba_all, pts_all = device_mod.fetch_packed(
        [res.p_w, res.R_wb, res.v_w, res.bg, res.ba, res.points])
    if not np.isfinite(p_all[:n_real]).all():
        return False
    for i, k in enumerate(kfs):
        if meta["fixed"][i]:
            continue
        m.kf_R[k], m.kf_t[k] = camera_from_body(R_all[i], p_all[i],
                                                meta["R_bc"], meta["t_bc"])
    m.kf_vel[kfs] = v_all[:n_real]
    m.kf_bg[kfs] = bg_all[:n_real]
    m.kf_ba[kfs] = ba_all[:n_real]
    m.pt_xyz[pt_ids] = pts_all[:len(pt_ids)]
    m.version += 1
    return True


def _solve(m: MapStore, cam, prob, meta, **kw):
    R_cb, t_cb = device_mod.upload_packed(
        [np.ascontiguousarray(meta["R_bc"].T), meta["t_cb"]], m.device)
    return vi_ba.vi_ba_solve(prob, cam, R_cb, t_cb, gravity_vec(m.device),
                             **kw)


def run_local_inertial_ba(m: MapStore, cam, window: int = 10, iters: int = 8,
                          max_points: int = 2048, max_obs: int = 8192,
                          prior_gyro: float = 1.0, prior_acc: float = 1e4,
                          calib: Optional[ImuCalib] = None):
    """Temporal-window visual-inertial BA (reference:
    Optimizer::LocalInertialBA, Optimizer.cc:2203: the newest 10 keyframes
    optimised, up to 4 older ones fixed). Returns the camera count, or 0
    when nothing ran."""
    chain = m.temporal_chain()
    if len(chain) < 3 or not m.imu_initialized:
        return 0
    opt = chain[-window:]
    fixed_n = min(4, len(chain) - len(opt))
    fix = chain[-window - fixed_n:-window] if fixed_n > 0 else chain[:1]
    kfs = list(fix) + list(opt)
    built = build_viba_problem(m, kfs, set(int(x) for x in fix), calib,
                               max_points=max_points, max_obs=max_obs)
    if built is None:
        return 0
    prob, meta = built
    res = _solve(m, cam, prob, meta, prior_gyro=prior_gyro,
                 prior_acc=prior_acc, iters=iters)
    apply_viba_result(m, meta, res)
    return len(kfs)


def run_full_inertial_ba(m: MapStore, cam, iters: int = 10,
                         max_points: int = 4096, max_obs: int = 16384,
                         prior_gyro: float = 1.0, prior_acc: float = 1e4,
                         calib: Optional[ImuCalib] = None):
    """Visual-inertial BA over the whole temporal chain (reference:
    Optimizer::FullInertialBA, Optimizer.cc:3237: at the end of each IMU
    initialisation stage, LocalMapping.cc:1760-1800, and as the global BA
    after a loop on an inertial map, LoopClosing.cc:2886-2890). Returns the
    camera count, or 0 when nothing ran."""
    chain = m.temporal_chain()
    if len(chain) < 3 or not m.imu_initialized:
        return 0
    kfs = [int(k) for k in chain]
    built = build_full_viba_problem(m, kfs, calib, max_points, max_obs)
    if built is None:
        return 0
    prob, meta = built
    res = _solve(m, cam, prob, meta, prior_gyro=prior_gyro,
                 prior_acc=prior_acc, iters=iters)
    apply_viba_result(m, meta, res)
    return len(kfs)


def run_merge_inertial_ba(m: MapStore, cam, k: int, c: int,
                          calib: Optional[ImuCalib], nd: int = 6,
                          iters: int = 8, max_points: int = 2048,
                          max_obs: int = 8192):
    """Visual-inertial weld refinement after a merge (reference:
    Optimizer::MergeInertialBA, Optimizer.cc:6017, from MergeLocal,
    LoopClosing.cc:2127): an nd-keyframe temporal window ending at the
    current keyframe k and a window around the welded match c, each with
    its own preintegration edges (the junction has none), each anchored by
    its fixed temporal predecessor. Returns the keyframes optimised or
    fixed, or None when no inertial problem could be built (the caller
    falls back to the visual weld BA)."""
    if not m.imu_initialized:
        return None

    def back_chain(start: int, count: int):
        out = [int(start)]
        while len(out) < count:
            p = int(m.kf_prev[out[-1]])
            if p < 0 or not m.kf_valid[p]:
                break
            out.append(p)
        return out

    next_of = {}
    for b in m.kf_ids():
        p = int(m.kf_prev[b])
        if p >= 0:
            next_of[p] = int(b)

    win_k = back_chain(k, nd)
    p = int(m.kf_prev[win_k[-1]])
    if p >= 0 and m.kf_valid[p]:
        fix_k = [p]
    else:
        fix_k = [win_k.pop()]
        if not win_k:
            return None
    win_c = back_chain(c, nd // 2)
    p = int(m.kf_prev[win_c[-1]])
    if p >= 0 and m.kf_valid[p]:
        fix_c = [p]
    else:
        fix_c = [win_c.pop()]
        if not win_c:
            return None
    nxt = next_of.get(int(c), -1)
    while len(win_c) + len(win_k) < 2 * nd and nxt >= 0 and nxt not in win_k:
        win_c.append(int(nxt))
        nxt = next_of.get(int(nxt), -1)

    chain_c = sorted(set(fix_c + win_c), key=lambda x: m.kf_ts[x])
    chain_k = sorted(set(fix_k + win_k), key=lambda x: m.kf_ts[x])
    if set(chain_c) & set(chain_k):
        return None   # overlapping windows: the visual BA takes over
    kfs = chain_c + chain_k
    fix = {chain_c[0], chain_k[0]} | set(fix_c) | set(fix_k)
    built = build_viba_problem(m, kfs, fix, calib, max_points=max_points,
                               max_obs=max_obs, e_cap=2 * nd + 8)
    if built is None:
        return None
    prob, meta = built
    res = _solve(m, cam, prob, meta, iters=iters)
    if not apply_viba_result(m, meta, res):
        return None
    return kfs
