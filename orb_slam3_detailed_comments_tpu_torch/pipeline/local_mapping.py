"""Local mapping: the bundle-adjustment half.

Counterpart of ``pipeline/local_mapping.py`` of the JAX package, restricted
to ``run_local_ba`` and its two halves (reference:
Optimizer::LocalBundleAdjustment, src/Optimizer.cc:1740). A keyframe window
is snapshotted from the host map into a padded ``ba.BAProblem`` on the map's
device, solved there, and written back with one packed fetch. The
``LocalMapper`` (keyframe insertion, triangulation, culling) belongs to a
later slice.
"""
from __future__ import annotations

import numpy as np

from .. import device as device_mod
from ..mapping.mapstore import MapStore, NO_POINT
from ..optim import ba


def run_local_ba(m: MapStore, window: list, fixed, cam, iters: int = 10,
                 max_points: int = 4096, max_obs: int = 16384):
    """Build a BAProblem from a keyframe window, solve it and write the
    result back.

    window: keyframe ids to optimize. fixed: ids held constant (None: the
    frontier, i.e. observers of window points outside the window, or the
    oldest window keyframes if there is no frontier)."""
    built = build_ba_problem(m, window, fixed, max_points=max_points,
                             max_obs=max_obs)
    if built is None:
        return
    prob, meta = built
    res = ba.ba_solve(prob, cam, iters=iters, table_depth=meta["table_depth"])
    apply_ba_result(m, meta, res)


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
