"""The port's steady tracking step against the JAX package's, on one map.

The map is seeded by the port (ground-truth fixture, 376x240, 512
features, 2048 points, 32 keyframes), carried into a JAX ``MapStore``
through ``to_numpy``, and both packages run ``track_step_visual`` on the
same frame. The frame is extracted once (by JAX) and shared, so the search
inputs are identical: n1, ref_kf, ids2 and match_pt must be equal, and the
pose within 1e-4.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.pipeline import kernels as jk
from orb_slam3_detailed_comments_tpu_torch.lie import SE3
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM = cameras.pinhole(**CAM_KW)
JCAM = jcam.pinhole(**CAM_KW)
CFG = mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=512)
ORB = extractor.OrbConfig(n_features=512)
LOCAL_CAP = 1024


@pytest.fixture(scope="module")
def world():
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(64)
    m = synth_render.seed_map(CAM, planes, R, t, 2, CFG, "cpu", ORB)
    jm = jms.MapStore(jms.MapConfig(max_kf=32, max_pt=2048, n_feat=512))
    for name, arr in m.to_numpy().items():
        setattr(jm, name, arr)
    jm.version += 1
    return planes, R, t, m, jm


def _frame(planes, R, t, i):
    img, _, _ = synth_render.render_frame_raycast(CAM, planes, R[i], t[i])
    prep_j = jk.prepare_frame(jnp.asarray(img), JCAM,
                              jext.OrbConfig(n_features=512))
    f = prep_j.feat
    feat = extractor.FrameFeatures(
        *(torch.from_numpy(np.array(a)) for a in
          (f.xy, f.level, f.angle, f.score)),
        torch.from_numpy(np.array(f.desc).view(np.int32)),
        torch.from_numpy(np.array(f.valid)))
    prep_t = kernels.PreparedFrame(feat, torch.from_numpy(np.array(prep_j.xy_ud)),
                                   torch.from_numpy(np.array(prep_j.xyn)))
    return prep_t, prep_j


def _stage1_inputs(m, kf):
    fp = m.kf_feat_point[kf]
    ids1 = np.full(512, -1, np.int32)
    pts = np.unique(fp[fp >= 0])[:512]
    ids1[:len(pts)] = pts
    ang_of_pt = np.zeros(m.cfg.max_pt, np.float32)
    ang_of_pt[fp[fp >= 0]] = m.kf_feat_angle[kf][fp >= 0]
    return ids1, ang_of_pt[np.maximum(ids1, 0)]


def test_track_step_visual_matches_jax(world):
    planes, R, t, m, jm = world
    i = 13                                     # between keyframes 6 and 7
    prep_t, prep_j = _frame(planes, R, t, i)
    ids1, ang1 = _stage1_inputs(m, 6)
    rs, inv_s2 = kernels.level_weights()
    # the previous frame's pose, nudged: at exactly a keyframe's pose the
    # predicted level of that keyframe's points sits on a rounding boundary
    # (ceil(log(ratio) / log(1.2)) of an integer), where float32 log of the
    # two libraries may round apart
    T_pred = (R[i - 1], t[i - 1] + np.float32([0.004, -0.003, 0.006]))
    dp, ko = m.device_points(), m.device_kf_obs()
    f = torch.from_numpy
    res_t = kernels.track_step_visual(
        SE3(f(T_pred[0]), f(T_pred[1])), prep_t, f(ids1), f(ang1),
        dp["xyz"], dp["desc"], dp["normal"], dp["min_dist"], dp["max_dist"],
        dp["valid"], ko["feat_point"], ko["valid"], ko["covis"],
        ko["point_bits"], f(15.0 * rs), f(4.0 * rs), f(inv_s2), CAM,
        local_cap=LOCAL_CAP, pt_proj8=dp["proj8"])
    dpj, koj = jm.device_points(), jm.device_kf_obs()
    res_j = jk.track_step_visual(
        JSE3(jnp.asarray(T_pred[0]), jnp.asarray(T_pred[1])), prep_j,
        jnp.asarray(ids1), jnp.asarray(ang1),
        dpj["xyz"], dpj["desc"], dpj["normal"], dpj["min_dist"],
        dpj["max_dist"], dpj["valid"], koj["feat_point"], koj["valid"],
        koj["covis"], koj["point_bits"], jnp.asarray(15.0 * rs),
        jnp.asarray(4.0 * rs), jnp.asarray(inv_s2), cam=JCAM,
        local_cap=LOCAL_CAP, pt_proj8=dpj["proj8"])
    assert int(res_t.n1) == int(res_j.n1) > 100
    assert int(res_t.ref_kf) == int(res_j.ref_kf)
    np.testing.assert_array_equal(res_t.ids2.numpy(), np.asarray(res_j.ids2))
    np.testing.assert_array_equal(res_t.visible2.numpy(),
                                  np.asarray(res_j.visible2))
    np.testing.assert_array_equal(res_t.match_pt.numpy(),
                                  np.asarray(res_j.match_pt))
    assert (res_t.match_pt >= 0).sum() > 150
    np.testing.assert_allclose(res_t.T_cw_R.numpy(), np.asarray(res_j.T_cw_R),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.T_cw_t.numpy(), np.asarray(res_j.T_cw_t),
                               atol=1e-4)
    C = -R[i].T @ t[i]
    C_est = -res_t.T_cw_R.numpy().T @ res_t.T_cw_t.numpy()
    assert np.linalg.norm(C - C_est) < 0.05


@pytest.mark.parametrize("dup_first", [True, False])
def test_duplicate_match_resolution_matches_jax(world, dup_first):
    """Two candidates matching one feature: the HIGHER candidate index wins,
    as XLA's scatter resolves the JAX program's ``.at[tgt].set`` (the JAX
    comment says the first wins; ROADMAP §3)."""
    planes, R, t, m, jm = world
    i = 13
    prep_t, prep_j = _frame(planes, R, t, i)
    ids1, ang1 = _stage1_inputs(m, 6)
    # clone point p into a free slot q: same position and descriptor, so
    # both candidates match the same feature
    q = int(np.where(~m.pt_valid)[0][0]) if not m.pt_valid.all() else None
    arrays = m.to_numpy()
    if q is None:     # map full: reuse the last slot of a dead point list
        q = int(np.setdiff1d(np.arange(m.cfg.max_pt), ids1)[-1])
    p = int(ids1[3])
    for name in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
                 "pt_max_dist", "pt_valid"):
        arrays[name][q] = arrays[name][p]
    ids = ids1.copy()
    ang = ang1.copy()
    slot_q = 0 if dup_first else len(np.where(ids1 >= 0)[0])
    if not dup_first and slot_q >= len(ids):
        slot_q = len(ids) - 1
    ids[slot_q], ang[slot_q] = q, ang1[3]
    cfg_j = jms.MapConfig(max_kf=32, max_pt=2048, n_feat=512)
    jm2 = jms.MapStore(cfg_j)
    for name, arr in arrays.items():
        setattr(jm2, name, arr)
    m2 = mapstore.MapStore.from_numpy(arrays, CFG, device="cpu")
    rs, inv_s2 = kernels.level_weights()
    T = (R[i], t[i])
    no_prior = -np.ones(512, np.int32)
    f = torch.from_numpy
    dp = m2.device_points()
    proj = kernels.gather_and_project(SE3(f(T[0]), f(T[1])), f(ids),
                                      dp["xyz"], dp["normal"], dp["min_dist"],
                                      dp["max_dist"], dp["valid"], CAM)
    res_t = kernels.match_and_optimize(
        SE3(f(T[0]), f(T[1])), prep_t, f(ids), proj, dp["desc"], dp["xyz"],
        f(15.0 * rs), f(inv_s2), f(no_prior), CAM, proj_angle=f(ang))
    dpj = jm2.device_points()
    projj = jk.gather_and_project(JSE3(jnp.asarray(T[0]), jnp.asarray(T[1])),
                                  jnp.asarray(ids), dpj["xyz"], dpj["normal"],
                                  dpj["min_dist"], dpj["max_dist"],
                                  dpj["valid"], JCAM)
    res_j = jk.match_and_optimize(
        JSE3(jnp.asarray(T[0]), jnp.asarray(T[1])), prep_j, jnp.asarray(ids),
        projj, dpj["desc"], dpj["xyz"], jnp.asarray(15.0 * rs),
        jnp.asarray(inv_s2), jnp.asarray(no_prior), cam=JCAM,
        proj_angle=jnp.asarray(ang))
    mt, mj = res_t.match_pt.numpy(), np.asarray(res_j.match_pt)
    np.testing.assert_array_equal(mt, mj)
    # the collision really happened and resolved to the later candidate
    later = q if slot_q > 3 else p
    earlier = p if later == q else q
    assert (mt == later).sum() == 1 and (mt == earlier).sum() == 0
