"""The device programs of visual tracking and mapping.

Counterpart of ``pipeline/kernels.py`` of the JAX package:
``prepare_frame`` (ORB extraction + undistortion), its stereo and
RGB-D forms ``prepare_frame_stereo`` (rectified pair),
``prepare_frame_stereo_fisheye`` (two cameras and their extrinsic) and
``prepare_frame_rgbd`` (registered depth map),
``track_step_visual`` (motion-model projection search + pose GN, local-
keyframe selection on point bitsets, local-map projection search + pose
GN), its inertial forms ``track_step_inertial_anchor`` /
``track_step_inertial_lf`` (the same visual core, then the visual-inertial
refine of the frame's nav state) and ``search_and_triangulate`` (new
points from a keyframe pair).
PyTorch runs them eagerly; apart from the host-side id lists they read and
the one packed fetch their caller makes, they run on the tensors' device
without a host sync. The steady step's stages are spans (``utils/timing``):
"projection search" and "pose GN" for each of its two stages and "local
keyframes" between them; a stereo frame's row matching is "Stereo
matching".
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..lie import SE3, so3
from ..models import cameras
from ..ops import extractor, hamming, matching, stereo, triangulate
from ..ops.topk import stable_top
from ..optim import pose_opt
from ..utils import timing


class PreparedFrame(NamedTuple):
    """Per-frame feature data in all coordinate systems the pipeline needs."""

    feat: extractor.FrameFeatures
    xy_ud: torch.Tensor   # [N, 2] undistorted pixel coords
    xyn: torch.Tensor     # [N, 2] normalized camera-plane coords


def prepare_frame(img: torch.Tensor, cam: cameras.CameraParams,
                  cfg: extractor.OrbConfig,
                  frontend: str = "fused") -> PreparedFrame:
    """ORB extraction + undistortion (reference: Frame ctor,
    Frame.cc:513,1003). Runs on img's device; on the fused front end the
    one-frame case of ``prepare_frames``."""
    if frontend == "fused":
        return unbatch(prepare_frames(img[None], cam, cfg))[0]
    feat = extractor.extract(img, cfg, frontend)
    xyn = cameras.unproject(cam, feat.xy)[:, :2]
    return PreparedFrame(feat, cameras.undistort_points(cam, feat.xy), xyn)


def prepare_frames(imgs: torch.Tensor, cam: cameras.CameraParams,
                   cfg: extractor.OrbConfig) -> PreparedFrame:
    """``prepare_frame`` for a batch of frames imgs [B, H, W] at once
    (``extractor.extract_batch``, then the undistortion over the batch's
    keypoints): a PreparedFrame with a leading axis of B whose frame b
    equals ``prepare_frame(imgs[b], cam, cfg)`` bit for bit
    (``unbatch`` splits it)."""
    feat = extractor.extract_batch(imgs, cfg)
    xy = feat.xy.reshape(-1, 2)
    B = imgs.shape[0]
    xyn = cameras.unproject(cam, xy)[:, :2].reshape(B, -1, 2)
    return PreparedFrame(feat, cameras.undistort_points(cam, xy).reshape(
        B, -1, 2), xyn)


def unbatch(prep: PreparedFrame, n: int = 0) -> list:
    """The first n frames (all if n is 0) of a batched PreparedFrame, each
    a PreparedFrame of its own."""
    n = n or prep.xyn.shape[0]
    take = lambda tree, i: type(tree)(*[x[i] for x in tree])
    return [PreparedFrame(take(prep.feat, i), prep.xy_ud[i], prep.xyn[i])
            for i in range(n)]


def prepare_frame_stereo(img_l: torch.Tensor, img_r: torch.Tensor,
                         cam: cameras.CameraParams, bf: float,
                         cfg: extractor.OrbConfig, n_levels: int = 8,
                         scale: float = 1.2, frontend: str = "fused"):
    """Stereo frame prep: extract both images, row-match, attach depth
    (reference: Frame stereo ctor + ComputeStereoMatches, Frame.cc:1102).
    Returns (PreparedFrame of the left image, depth [N], u_right [N]), all
    on the images' device."""
    prep = prepare_frame(img_l, cam, cfg, frontend)
    feat_r = extractor.extract(img_r, cfg, frontend)
    with timing.span("Stereo matching"):
        sm = stereo.stereo_match(
            prep.xy_ud, prep.feat.level, prep.feat.desc, prep.feat.valid,
            feat_r.xy, feat_r.level, feat_r.desc, feat_r.valid, img_l, img_r,
            bf, min_z=max(bf / cam.fx * 2.0, 0.3), n_levels=n_levels,
            scale=scale)
    return prep, sm.depth, sm.u_right


def prepare_frame_stereo_fisheye(img_l: torch.Tensor, img_r: torch.Tensor,
                                 cam_l: cameras.CameraParams,
                                 cam_r: cameras.CameraParams,
                                 R_rl: torch.Tensor, t_rl: torch.Tensor,
                                 cfg: extractor.OrbConfig,
                                 frontend: str = "fused"):
    """Non-rectified (fisheye) stereo prep: descriptor matching gated by the
    epipolar constraint of the known extrinsic, two-view triangulation, the
    epipolar SAD sub-pixel refinement and re-triangulation (the JAX
    package's ``KB8_SUBPIXEL = True``), then reprojection checks in both
    views (reference: Frame::ComputeStereoFishEyeMatches, Frame.cc:1530 +
    KannalaBrandt8::TriangulateMatches, KannalaBrandt8.cpp:327).

    R_rl / t_rl: right <- left extrinsic, on the images' device. Returns
    (PreparedFrame left, depth [N] (0 where no match), idx_r [N])."""
    prep_l = prepare_frame(img_l, cam_l, cfg, frontend)
    feat_r = extractor.extract(img_r, cfg, frontend)
    with timing.span("Stereo matching"):
        depth, idx = fisheye_stereo_depth(prep_l, feat_r, img_l, img_r,
                                          cam_l, cam_r, R_rl, t_rl)
    return prep_l, depth, idx


def fisheye_stereo_depth(prep_l: PreparedFrame, feat_r, img_l, img_r,
                         cam_l: cameras.CameraParams,
                         cam_r: cameras.CameraParams, R_rl: torch.Tensor,
                         t_rl: torch.Tensor):
    """prepare_frame_stereo_fisheye after the two extractions: (depth [N],
    idx_r [N]) of the left features from the right image's features."""
    xyn_r = cameras.unproject(cam_r, feat_r.xy)[:, :2]

    # epipolar gate: l_r = E x_l with E = [t]x R (lines in the right camera)
    E = so3.hat(t_rl) @ R_rl
    Xl = torch.cat([prep_l.xyn, torch.ones_like(prep_l.xyn[:, :1])], dim=-1)
    Xr = torch.cat([xyn_r, torch.ones_like(xyn_r[:, :1])], dim=-1)
    l_r = Xl @ E.T
    num = l_r @ Xr.T
    d2 = num * num / torch.clamp(
        (l_r[:, 0] ** 2 + l_r[:, 1] ** 2)[:, None], min=1e-12)
    epi_ok = d2 * float(cam_l.fx) ** 2 < 3.84 * 4.0   # ~2 sigma of 2 px

    res = matching.match_nn(prep_l.feat.desc, prep_l.feat.valid,
                            feat_r.desc, feat_r.valid,
                            max_dist=matching.TH_LOW, ratio=0.8, mutual=True,
                            extra_mask=epi_ok)
    idx = res.idx.long()
    T_l = SE3(torch.eye(3, dtype=R_rl.dtype, device=R_rl.device),
              torch.zeros_like(t_rl))
    T_r = SE3(R_rl, t_rl)
    X, tri_ok = triangulate.triangulate(T_l, prep_l.xyn, T_r, xyn_r[idx])

    # epipolar SAD sub-pixel (beyond the reference, whose KB8 matches stay
    # at integer keypoints): slide an 11x11 window along the epipolar
    # tangent at the matched right feature, fit a parabola, re-triangulate
    xy_r0 = feat_r.xy[idx]
    uvr0 = cameras.project(cam_r, T_r.apply(X))
    dtan = cameras.project(cam_r, T_r.apply(X * 1.05)) - uvr0
    e_dir = dtan / torch.clamp(torch.linalg.norm(dtan, dim=-1, keepdim=True),
                               min=1e-6)
    baseline = torch.linalg.norm(t_rl)
    # only matches with real depth information: past ~60 baselines one
    # pixel of slide moves depth by far more than the SAD minimum resolves
    near = X[:, 2] < 60.0 * baseline
    delta, ok_ref = stereo.epipolar_sad_refine(
        img_l, img_r, prep_l.feat.xy, xy_r0, e_dir, res.valid & tri_ok & near)
    # wander guard: the descriptor match localised the feature to ~1 px
    ok_ref = ok_ref & (torch.abs(delta) <= 2.5)
    xy_r_use = xy_r0 + torch.where(ok_ref, delta,
                                   torch.zeros_like(delta))[:, None] * e_dir
    xyn_r_use = cameras.unproject(cam_r, xy_r_use)[:, :2]
    X2, tri_ok2 = triangulate.triangulate(T_l, prep_l.xyn, T_r, xyn_r_use)
    dz = X2[:, 2] / torch.clamp(X[:, 2], min=1e-6)
    use = ok_ref & tri_ok2 & (dz > 0.8) & (dz < 1.25)
    X = torch.where(use[:, None], X2, X)
    tri_ok = torch.where(use, tri_ok2, tri_ok)
    xy_r_chk = torch.where(use[:, None], xy_r_use, xy_r0)

    # reprojection checks in both views (chi2 < 5.991, sigma 1 px)
    X_r = T_r.apply(X)
    e_l = torch.sum((cameras.project(cam_l, X) - prep_l.feat.xy) ** 2, dim=-1)
    e_r = torch.sum((cameras.project(cam_r, X_r) - xy_r_chk) ** 2, dim=-1)
    good = (res.valid & tri_ok & (X[:, 2] > baseline * 2)
            & (X_r[:, 2] > baseline * 2) & (e_l < 5.991) & (e_r < 5.991))
    depth = torch.where(good, X[:, 2], torch.zeros_like(X[:, 2]))
    return depth, res.idx


def prepare_frame_rgbd(img: torch.Tensor, depth_img: torch.Tensor,
                       cam: cameras.CameraParams, bf: float,
                       cfg: extractor.OrbConfig, frontend: str = "fused"):
    """RGB-D frame prep: the registered depth map sampled at each keypoint
    (reference: Frame RGB-D ctor ComputeStereoFromRGBD, Frame.cc:1487).
    Returns (PreparedFrame, depth [N], virtual u_right [N])."""
    prep = prepare_frame(img, cam, cfg, frontend)
    H, W = depth_img.shape
    u = torch.clamp(prep.feat.xy[:, 0].to(torch.int32), 0, W - 1).long()
    v = torch.clamp(prep.feat.xy[:, 1].to(torch.int32), 0, H - 1).long()
    z = depth_img[v, u]
    z = torch.where(z > 0.05, z, torch.zeros_like(z))
    # bf divided as a tensor: a Python number over a tensor is taken as a
    # multiply by the reciprocal, one rounding off XLA's quotient
    u_r = torch.where(z > 0, prep.xy_ud[:, 0] - torch.full_like(z, bf)
                      / torch.clamp(z, min=1e-6), torch.full_like(z, -1.0))
    return prep, z, u_r


class ProjectedPoints(NamedTuple):
    uv: torch.Tensor        # [P, 2] predicted pixel (undistorted frame)
    dist: torch.Tensor      # [P] distance to camera center
    level: torch.Tensor     # [P] int32 predicted pyramid level
    visible: torch.Tensor   # [P] frustum + scale + view-angle gate


def gather_and_project(T_cw: SE3, ids: torch.Tensor, pt_xyz, pt_normal,
                       pt_min_dist, pt_max_dist, pt_valid,
                       cam: cameras.CameraParams, scale: float = 1.2,
                       n_levels: int = 8,
                       pt_proj8: torch.Tensor | None = None) -> ProjectedPoints:
    """project_points on the rows of the full map arrays named by the padded
    id list ids [C] (-1 padding). pt_proj8: optional packed [P, 8]
    (xyz, normal, min, max) rows — one row gather instead of four."""
    safe = torch.clamp(ids, min=0).long()
    valid = (ids >= 0) & pt_valid[safe]
    if pt_proj8 is not None:
        rows = pt_proj8[safe]
        return project_points(T_cw, rows[:, 0:3], rows[:, 3:6], rows[:, 6],
                              rows[:, 7], valid, cam, scale, n_levels)
    return project_points(T_cw, pt_xyz[safe], pt_normal[safe],
                          pt_min_dist[safe], pt_max_dist[safe], valid, cam,
                          scale, n_levels)


def project_points(T_cw: SE3, pts, normals, min_dist, max_dist, valid,
                   cam: cameras.CameraParams, scale: float = 1.2,
                   n_levels: int = 8) -> ProjectedPoints:
    """Frustum/scale/view-angle visibility + level prediction (reference:
    Frame::isInFrustum, Frame.cc:667)."""
    pc = T_cw.apply(pts)
    z = pc[..., 2]
    uv = cameras.project(cam, pc)
    cw = T_cw.inverse().t
    vec = pts - cw
    dist = torch.linalg.norm(vec, dim=-1)
    cos_view = torch.sum(vec * normals, dim=-1) / torch.clamp(dist, min=1e-9)
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    level = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                       / math.log(scale))
    level = torch.clamp(level, 0, n_levels - 1).to(torch.int32)
    visible = (valid & (z > 0.05) & cameras.in_image(cam, uv)
               & (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
               & (cos_view > 0.5))
    return ProjectedPoints(uv, dist, level, visible)


class TrackResult(NamedTuple):
    T_cw_R: torch.Tensor
    T_cw_t: torch.Tensor
    match_pt: torch.Tensor   # [N] map-point id per feature (-1 = none)
    n_inliers: torch.Tensor


def invert_matches(res: matching.MatchResult, pt_ids: torch.Tensor,
                   n_feat: int) -> torch.Tensor:
    """Feature -> point from point -> feature matches: [N] int32, -1 where
    no match. Where several candidates matched one feature, the HIGHEST
    candidate index wins, deterministically. (The JAX program writes
    ``.at[tgt].set(upd)``, whose duplicates resolve to the last update on
    XLA-CPU; its comment's "first projected point wins" does not hold.)"""
    Q = pt_ids.shape[0]
    dev = pt_ids.device
    tgt = torch.where(res.valid, res.idx.long(),
                      torch.full_like(res.idx, n_feat, dtype=torch.long))
    winner = torch.full((n_feat + 1,), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(0, tgt, torch.arange(Q, device=dev),
                                   "amax", include_self=True)[:n_feat]
    return torch.where(winner >= 0, pt_ids[winner.clamp(min=0)].to(torch.int32),
                       torch.full_like(winner, -1, dtype=torch.int32))


def _projection_search(frame: PreparedFrame, pt_ids: torch.Tensor,
                       proj: ProjectedPoints, pt_desc: torch.Tensor,
                       radius_per_level: torch.Tensor,
                       prior_match_pt: torch.Tensor,
                       proj_angle: torch.Tensor | None = None) -> torch.Tensor:
    """Projection search (reference: ORBmatcher.cc:1950/45): [N] feature ->
    point matches, the prior's assignments kept."""
    feat = frame.feat
    radius = radius_per_level[proj.level.long()]
    taken = prior_match_pt >= 0
    desc_c = pt_desc[torch.clamp(pt_ids, min=0).long()]
    res = matching.search_by_projection(
        proj.uv, proj.visible & (pt_ids >= 0), desc_c, proj.level,
        feat._replace(xy=frame.xy_ud), radius, level_lo=-1, level_hi=1,
        max_dist=matching.TH_HIGH, ratio=0.8, taken=taken)
    if proj_angle is not None:
        dang = proj_angle - feat.angle[res.idx.long()]
        res = res._replace(
            valid=matching.rotation_consistency_mask(dang, res.valid))

    N = feat.xy.shape[0]
    match_pt = invert_matches(res, pt_ids, N)
    return torch.where(taken, prior_match_pt, match_pt)


def _optimize_pose(T_cw0: SE3, frame: PreparedFrame, match_pt: torch.Tensor,
                   pt_xyz: torch.Tensor, inv_sigma2_per_level: torch.Tensor,
                   cam: cameras.CameraParams) -> TrackResult:
    """Motion-only pose optimization on the matches (reference:
    Optimizer::PoseOptimization); the outliers' matches dropped."""
    feat = frame.feat
    has = match_pt >= 0
    X = pt_xyz[torch.where(has, match_pt, torch.zeros_like(match_pt)).long()]
    w = inv_sigma2_per_level[feat.level.long()]
    with timing.span("pose GN"):
        opt = pose_opt.pose_optimization(T_cw0, X, frame.xy_ud, w,
                                         has & feat.valid, cam)
    match_pt = torch.where(opt.inlier | ~has, match_pt,
                           torch.full_like(match_pt, -1))
    return TrackResult(opt.T_cw.R, opt.T_cw.t, match_pt,
                       torch.sum((match_pt >= 0).to(torch.int32)))


def match_and_optimize(T_cw0: SE3, frame: PreparedFrame, pt_ids, proj,
                       pt_desc, pt_xyz, radius_per_level,
                       inv_sigma2_per_level, prior_match_pt,
                       cam: cameras.CameraParams,
                       proj_angle=None) -> TrackResult:
    """Projection search + pose optimization as one stage (covers
    TrackWithMotionModel and TrackLocalMap's hot loops; reference:
    ORBmatcher.cc:1950/45 + Optimizer::PoseOptimization). pt_ids [P]:
    global point ids of the candidates (-1 padding); pt_desc/pt_xyz are the
    full map arrays; prior_match_pt [N]: assignments to keep; proj_angle
    [P]: optional rotation-consistency reference angle per candidate."""
    with timing.span("projection search"):
        match_pt = _projection_search(frame, pt_ids, proj, pt_desc,
                                      radius_per_level, prior_match_pt,
                                      proj_angle)
    return _optimize_pose(T_cw0, frame, match_pt, pt_xyz,
                          inv_sigma2_per_level, cam)


class TrackStepResult(NamedTuple):
    """Everything the host needs from one steady visual tracking step."""
    n1: torch.Tensor         # stage-1 (motion-model) inlier count
    ref_kf: torch.Tensor     # argmax-observation local keyframe
    match_pt: torch.Tensor   # [N] final feature->point matches
    T_cw_R: torch.Tensor
    T_cw_t: torch.Tensor
    ids2: torch.Tensor       # [C2] local-map candidate point ids (-1 pad)
    visible2: torch.Tensor   # [C2] frustum-visible mask
    angle: torch.Tensor      # [N] current frame keypoint angles
    valid: torch.Tensor      # [N] current frame validity


def track_step_visual(T_pred: SE3, frame: PreparedFrame, ids1, ang1,
                      pt_xyz, pt_desc, pt_normal, pt_min_dist, pt_max_dist,
                      pt_valid, kf_feat_point, kf_valid, covis, kf_point_bits,
                      radius1_per_level, radius2_per_level,
                      inv_sigma2_per_level, cam: cameras.CameraParams,
                      scale: float = 1.2, n_levels: int = 8,
                      min_covis_w: int = 15, local_cap: int = 4096,
                      pt_proj8=None) -> TrackStepResult:
    """The whole steady-state visual tracking step:

      motion-model projection search + pose GN      (Tracking.cc:3352)
      -> local-keyframe selection on the device      (Tracking.cc:4132)
      -> local-point union + projection at the       (Tracking.cc:3979)
         stage-1 pose
      -> local-map projection search + pose GN       (Tracking.cc:3474)

    ids1 [C1] stage-1 candidate point ids (-1 pad); ang1 [C1] their
    rotation-consistency angles; kf_feat_point [K, N], kf_valid [K],
    covis [K, K] and kf_point_bits [K, P/32] int32 describe the map's
    observation structure."""
    res1, ref_kf, ids2, proj2, res2 = _track_step_visual_core(
        T_pred, frame, ids1, ang1, pt_xyz, pt_desc, pt_normal, pt_min_dist,
        pt_max_dist, pt_valid, kf_feat_point, kf_valid, covis, kf_point_bits,
        radius1_per_level, radius2_per_level, inv_sigma2_per_level, cam,
        scale, n_levels, min_covis_w, local_cap, pt_proj8=pt_proj8)
    return TrackStepResult(res1.n_inliers, ref_kf, res2.match_pt,
                           res2.T_cw_R, res2.T_cw_t, ids2, proj2.visible,
                           frame.feat.angle, frame.feat.valid)


class TrackStepInertialResult(NamedTuple):
    """track_step_visual's outputs and the visual-inertial refine appended
    (reference: the PoseInertialOptimization call at the end of
    TrackLocalMap, Tracking.cc:3502-3528). ``prior`` (the next frame's
    marginalisation prior) stays on the device."""
    n1: torch.Tensor
    ref_kf: torch.Tensor
    match_pt: torch.Tensor
    T_cw_R: torch.Tensor
    T_cw_t: torch.Tensor
    ids2: torch.Tensor
    visible2: torch.Tensor
    angle: torch.Tensor
    valid: torch.Tensor
    ni: torch.Tensor          # refine inlier count
    inl_i: torch.Tensor       # [N] refine inlier mask over the features
    v_w: torch.Tensor         # [3] refined world velocity
    Ri_cw: torch.Tensor
    ti_cw: torch.Tensor
    prior: object             # pose_opt.PriorPoseImu


def _refine_inputs(frame: PreparedFrame, res2: TrackResult, pt_xyz,
                   inv_sigma2_per_level):
    """The refine's start pose, matched points, weights and mask."""
    has = res2.match_pt >= 0
    X = pt_xyz[torch.where(has, res2.match_pt,
                           torch.zeros_like(res2.match_pt)).long()]
    w = inv_sigma2_per_level[frame.feat.level.long()]
    return SE3(res2.T_cw_R, res2.T_cw_t), X, w, has & frame.feat.valid


def _inertial_result(res1, ref_kf, ids2, proj2, res2, frame, ri, prior):
    return TrackStepInertialResult(
        res1.n_inliers, ref_kf, res2.match_pt, res2.T_cw_R, res2.T_cw_t,
        ids2, proj2.visible, frame.feat.angle, frame.feat.valid,
        ri.n_inliers, ri.inlier, ri.v_w, ri.T_cw.R, ri.T_cw.t, prior)


def track_step_inertial_anchor(T_pred: SE3, frame: PreparedFrame, ids1, ang1,
                               pt_xyz, pt_desc, pt_normal, pt_min_dist,
                               pt_max_dist, pt_valid, kf_feat_point, kf_valid,
                               covis, kf_point_bits, radius1_per_level,
                               radius2_per_level, inv_sigma2_per_level,
                               v0, R_wb_a, p_a, v_a, bg, ba, pre, gravity,
                               R_cb, t_cb, cam: cameras.CameraParams,
                               scale: float = 1.2, n_levels: int = 8,
                               min_covis_w: int = 15, local_cap: int = 4096,
                               pt_proj8=None) -> TrackStepInertialResult:
    """The steady step for inertial sensors anchored on the last KEYFRAME
    (the map changed since the last frame, so the running prior is stale;
    reference: the mbMapUpdated branch of Tracking.cc:3502-3528): the
    visual core, then ``pose_inertial_optimization`` and the prior's seed
    (``build_frame_prior``)."""
    res1, ref_kf, ids2, proj2, res2 = _track_step_visual_core(
        T_pred, frame, ids1, ang1, pt_xyz, pt_desc, pt_normal, pt_min_dist,
        pt_max_dist, pt_valid, kf_feat_point, kf_valid, covis, kf_point_bits,
        radius1_per_level, radius2_per_level, inv_sigma2_per_level, cam,
        scale, n_levels, min_covis_w, local_cap, pt_proj8=pt_proj8)
    T2, X, w, vmask = _refine_inputs(frame, res2, pt_xyz,
                                     inv_sigma2_per_level)
    with timing.span("pose GN"):
        ri = pose_opt.pose_inertial_optimization(
            T2, v0, R_wb_a, p_a, v_a, bg, ba, pre, X, frame.xy_ud, w, vmask,
            cam, gravity, R_cb=R_cb, t_cb=t_cb)
        prior = pose_opt.build_frame_prior(
            ri.T_cw, ri.v_w, bg, ba, R_wb_a, p_a, v_a, pre, X, frame.xy_ud,
            w, ri.inlier, cam, gravity, R_cb=R_cb, t_cb=t_cb)
    return _inertial_result(res1, ref_kf, ids2, proj2, res2, frame, ri,
                            prior)


def track_step_inertial_lf(T_pred: SE3, frame: PreparedFrame, ids1, ang1,
                           pt_xyz, pt_desc, pt_normal, pt_min_dist,
                           pt_max_dist, pt_valid, kf_feat_point, kf_valid,
                           covis, kf_point_bits, radius1_per_level,
                           radius2_per_level, inv_sigma2_per_level,
                           v0, prior_in, pre, gravity, R_cb, t_cb,
                           cam: cameras.CameraParams, scale: float = 1.2,
                           n_levels: int = 8, min_covis_w: int = 15,
                           local_cap: int = 4096,
                           pt_proj8=None) -> TrackStepInertialResult:
    """The steady step for inertial sensors, last-FRAME form: the visual
    core, then the joint 30-dof optimisation with the last frame's state
    under the running prior, marginalising it into the next prior
    (reference: PoseInertialOptimizationLastFrame + Marginalize,
    Optimizer.cc:983 / 1644)."""
    res1, ref_kf, ids2, proj2, res2 = _track_step_visual_core(
        T_pred, frame, ids1, ang1, pt_xyz, pt_desc, pt_normal, pt_min_dist,
        pt_max_dist, pt_valid, kf_feat_point, kf_valid, covis, kf_point_bits,
        radius1_per_level, radius2_per_level, inv_sigma2_per_level, cam,
        scale, n_levels, min_covis_w, local_cap, pt_proj8=pt_proj8)
    T2, X, w, vmask = _refine_inputs(frame, res2, pt_xyz,
                                     inv_sigma2_per_level)
    with timing.span("pose GN"):
        ri = pose_opt.pose_inertial_optimization_last_frame(
            T2, v0, prior_in, pre, X, frame.xy_ud, w, vmask, cam, gravity,
            R_cb=R_cb, t_cb=t_cb)
    return _inertial_result(res1, ref_kf, ids2, proj2, res2, frame, ri,
                            ri.prior)


def _pack_mask_bits(m: torch.Tensor) -> torch.Tensor:
    """[P] bool -> [P/32] int32 bitset (bit p & 31 of word p >> 5)."""
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    words = torch.sum(m.reshape(-1, 32).to(torch.int64) << shifts, dim=1)
    words = words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32
    return words.to(torch.int32)


def _track_step_visual_core(T_pred: SE3, frame: PreparedFrame, ids1, ang1,
                            pt_xyz, pt_desc, pt_normal, pt_min_dist,
                            pt_max_dist, pt_valid, kf_feat_point, kf_valid,
                            covis, kf_point_bits, radius1_per_level,
                            radius2_per_level, inv_sigma2_per_level,
                            cam: cameras.CameraParams, scale: float,
                            n_levels: int, min_covis_w: int, local_cap: int,
                            pt_proj8=None):
    """Body of track_step_visual, each stage a span."""
    dev = pt_xyz.device

    # ---- stage 1: track with motion model --------------------------------
    with timing.span("projection search"):
        proj1 = gather_and_project(T_pred, ids1, pt_xyz, pt_normal,
                                   pt_min_dist, pt_max_dist, pt_valid, cam,
                                   scale, n_levels, pt_proj8=pt_proj8)
        no_prior = torch.full((frame.feat.xy.shape[0],), -1,
                              dtype=torch.int32, device=dev)
        match1 = _projection_search(frame, ids1, proj1, pt_desc,
                                    radius1_per_level, no_prior, ang1)
    res1 = _optimize_pose(T_pred, frame, match1, pt_xyz,
                          inv_sigma2_per_level, cam)
    match1 = res1.match_pt
    T1 = SE3(res1.T_cw_R, res1.T_cw_t)
    with timing.span("local keyframes"):
        ref_kf, ids2 = _local_keyframes(match1, pt_valid, kf_valid, covis,
                                        kf_point_bits, min_covis_w, local_cap)

    # ---- stage 2: track local map at the stage-1 pose ----------------------
    with timing.span("projection search"):
        proj2 = gather_and_project(T1, ids2, pt_xyz, pt_normal, pt_min_dist,
                                   pt_max_dist, pt_valid, cam, scale,
                                   n_levels, pt_proj8=pt_proj8)
        match2 = _projection_search(frame, ids2, proj2, pt_desc,
                                    radius2_per_level, match1)
    res2 = _optimize_pose(T1, frame, match2, pt_xyz, inv_sigma2_per_level,
                          cam)
    return res1, ref_kf, ids2, proj2, res2


def _local_keyframes(match1, pt_valid, kf_valid, covis, kf_point_bits,
                     min_covis_w: int, local_cap: int):
    """(ref_kf, ids2 [C2]): the local keyframes of the stage-1 matches and
    the padded id list of the points they observe (reference:
    UpdateLocalKeyFrames + UpdateLocalPoints, Tracking.cc:4132 / 3979). The
    selection works on the [K, P/32] point-membership bitsets: per-KF
    observation counts are AND + popcount against the matched-point bitset,
    and the local point union is an OR-reduction."""
    P = pt_valid.shape[0]
    K = kf_valid.shape[0]
    dev = pt_valid.device

    # ---- local-keyframe selection (UpdateLocalKeyFrames) ------------------
    # matched-point mask; ids outside [0, P) are dropped like mode="drop"
    ok1 = (match1 >= 0) & (match1 < P)
    # index_fill_ rather than `x[idx] = True`: assigning a Python scalar
    # through indexing copies it from the host, a host sync
    m = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(ok1, match1, torch.full_like(match1, P)).long(), True)
    matched_bits = _pack_mask_bits(m[:P])
    obs = torch.sum(hamming.popcount32(kf_point_bits & matched_bits[None, :]),
                    dim=1, dtype=torch.int32)
    obs = torch.where(kf_valid, obs, torch.zeros_like(obs))
    cnt10, top10 = stable_top(obs, 10)
    sel10 = cnt10 > 0
    ref_kf = top10[0]
    # extend by each selected KF's top covisible neighbours (weight >= 15)
    w10 = covis[top10]                                        # [10, K]
    w10 = torch.where(w10 >= min_covis_w, w10, torch.zeros_like(w10))
    nb_w, nb = stable_top(w10, 10)                           # [10, 10]
    nb_flat = torch.where(sel10[:, None] & (nb_w > 0), nb,
                          torch.full_like(nb, K)).reshape(-1)
    local_k = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.cat([torch.where(sel10, top10, torch.full_like(top10, K)),
                      nb_flat]), True)[:K]

    # ---- local point union -> padded candidate list -----------------------
    x = torch.where((local_k & kf_valid)[:, None], kf_point_bits,
                    torch.zeros_like(kf_point_bits))
    # OR-reduction as a halving tree (the JAX program's order; OR is exact)
    if x.shape[0] & (x.shape[0] - 1):
        K2 = 1 << (x.shape[0] - 1).bit_length()
        x = torch.cat([x, torch.zeros((K2 - x.shape[0], x.shape[1]),
                                      dtype=x.dtype, device=dev)])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] | x[h:]
    union = x[0]
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    # arithmetic right shift on int32: mask after shifting
    pmask = (((union[:, None] >> shifts[None, :]) & 1) > 0).reshape(P)
    pmask = pmask & pt_valid
    C2 = min(P, local_cap)
    # compact the first C2 set bits (ascending id) via cumsum + scatter
    pos = torch.cumsum(pmask.to(torch.int32), dim=0) - 1
    tgt = torch.where(pmask & (pos < C2), pos, torch.full_like(pos, C2))
    ids2 = torch.full((C2 + 1,), -1, dtype=torch.int32, device=dev)
    ids2 = ids2.scatter(0, tgt, torch.arange(P, dtype=torch.int32,
                                             device=dev))[:C2]
    return ref_kf, ids2


def level_weights(n_levels: int = 8, scale: float = 1.2):
    """(radius_scale[l], inv_sigma2[l]) numpy arrays used by matching and
    optimization."""
    sf = scale ** np.arange(n_levels, dtype=np.float32)
    return sf.astype(np.float32), (1.0 / (sf * sf)).astype(np.float32)


class TriangulationResult(NamedTuple):
    idx_b: torch.Tensor    # [N] matched feature in keyframe b per feature of a
    ok: torch.Tensor       # [N] accepted new point
    xyz: torch.Tensor      # [N, 3] world coordinates


def search_and_triangulate_batch(T_a: SE3, T_bs: SE3, desc_a, xyn_a, level_a,
                                 free_a, desc_bs, xyn_bs, level_bs, free_bs,
                                 inv_sigma2_a, inv_sigma2_bs,
                                 focal: float = 460.0) -> TriangulationResult:
    """search_and_triangulate of keyframe a against B neighbours: T_bs,
    desc_bs, ... carry a leading [B] axis. One pair at a time, so that the
    dense [N, N] search of one pair is all that is alive at once; results
    stacked on the device, ready for one packed fetch."""
    outs = [search_and_triangulate(
        T_a, SE3(T_bs.R[j], T_bs.t[j]), desc_a, xyn_a, level_a, free_a,
        desc_bs[j], xyn_bs[j], level_bs[j], free_bs[j], inv_sigma2_a,
        inv_sigma2_bs[j], focal=focal) for j in range(desc_bs.shape[0])]
    return TriangulationResult(*(torch.stack(parts) for parts in zip(*outs)))


def search_and_triangulate(T_a: SE3, T_b: SE3, desc_a, xyn_a, level_a,
                           free_a, desc_b, xyn_b, level_b, free_b,
                           inv_sigma2_a, inv_sigma2_b,
                           focal: float = 460.0) -> TriangulationResult:
    """Epipolar-constrained matching + triangulation between two keyframes
    (reference: ORBmatcher::SearchForTriangulation, ORBmatcher.cc:1045 +
    LocalMapping::CreateNewMapPoints, LocalMapping.cc:506). free_*: the
    features not yet associated with a map point. The masked search is
    ``matching.match_nn`` with ``extra_mask`` (dense, as in the JAX
    package: no Pallas kernel there either)."""
    # relative pose b <- a; E maps a-rays to epipolar lines in b
    T_ba = T_b.compose(T_a.inverse())
    E = so3.hat(T_ba.t) @ T_ba.R
    ones = torch.ones_like(xyn_a[:, :1])
    Xa = torch.cat([xyn_a, ones], dim=-1)
    Xb = torch.cat([xyn_b, ones], dim=-1)
    l_b = Xa @ E.T                                        # [Na, 3]
    num = l_b @ Xb.T                                      # [Na, Nb]
    d2 = num * num / torch.clamp(
        (l_b[:, 0] ** 2 + l_b[:, 1] ** 2)[:, None], min=1e-12)
    # pixel-scaled epipolar gate at the b feature's level
    epi_ok = d2 * focal * focal < 3.84 / inv_sigma2_b[None, :]

    res = matching.match_nn(desc_a, free_a, desc_b, free_b,
                            max_dist=matching.TH_LOW, ratio=0.9, mutual=True,
                            extra_mask=epi_ok)
    idx = res.idx.long()
    xn_b_matched = xyn_b[idx]
    # the DLT in float64: in float32 the adjugate's null direction loses
    # more than 1e-4 m on some low-parallax pairs the gates still accept
    # (ROADMAP.md section 3)
    f64 = lambda T: SE3(T.R.double(), T.t.double())
    X, tri_ok = triangulate.triangulate(f64(T_a), xyn_a.double(), f64(T_b),
                                        xn_b_matched.double())
    X = X.float()
    # acceptance: cheirality, parallax, reprojection in both views
    pa = T_a.apply(X)
    pb = T_b.apply(X)
    cosp = triangulate.parallax_cos(T_a, T_b, X)
    ra = pa[:, :2] / torch.clamp(pa[:, 2:3], min=1e-9) - xyn_a
    rb = pb[:, :2] / torch.clamp(pb[:, 2:3], min=1e-9) - xn_b_matched
    ea = torch.sum(ra * ra, -1) * focal * focal * inv_sigma2_a
    eb = torch.sum(rb * rb, -1) * focal * focal * inv_sigma2_b[idx]
    ok = (res.valid & tri_ok & (pa[:, 2] > 0) & (pb[:, 2] > 0)
          & (cosp < 0.9998) & (ea < 5.991) & (eb < 5.991))
    return TriangulationResult(res.idx, ok, X)
