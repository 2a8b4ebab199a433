"""The port's LocalMapper against the JAX package's, stage by stage, and
the tracker's keyframe decision, on maps that the JAX System built.

The JAX ``System(cam, MONOCULAR, enable_loop_closing=False)`` runs the
first 34 frames of the 60-frame orbit at the small size of
``test_torch_bootstrap.py`` (376x240, 512 features, 32 keyframes / 2048
points, ``min_init_matches`` 50; world seed 3, where it initialises at frame
2). Before each stage of each keyframe event its map is snapshotted. Each
port stage then starts from the same snapshot (``MapStore.from_numpy``) as
the JAX stage did:

- ``_map_point_culling`` drops exactly the same points;
- ``search_and_triangulate`` agrees on ``ok`` for >= 99 % of the features
  over an event's pairs, with ``xyz`` within 1e-4 m where both accept (its
  gates are float thresholds, so a pair may flip); the whole
  ``_create_new_map_points`` creates as many points within 5 %;
- the forward and reverse fuse passes give the same matches, applied in the
  same order, to the same arrays;
- ``_keyframe_culling`` culls the same keyframes;
- ``Tracker._need_new_keyframe`` gives the same answer on the same state.
"""
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.models import cameras as jcameras
from orb_slam3_detailed_comments_tpu.pipeline import kernels as jkernels
from orb_slam3_detailed_comments_tpu.pipeline import local_mapping as jlm
from orb_slam3_detailed_comments_tpu.pipeline import system as jsystem
from orb_slam3_detailed_comments_tpu.pipeline import tracking as jtracking
from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu_torch.lie import SE3
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import (
    kernels, local_mapping, tracking)
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM, JCAM = cameras.pinhole(**CAM_KW), jcameras.pinhole(**CAM_KW)
N_FRAMES, N_FEAT, MIN_INIT, WORLD_SEED = 34, 512, 50, 3
MAP_KW = dict(max_kf=32, max_pt=2048, n_feat=N_FEAT)
STAGES = ("_map_point_culling", "_create_new_map_points", "_fuse_neighbors",
          "_keyframe_culling")


def _snap(m, lm):
    arrays = {k: v.copy() for k, v in vars(m).items()
              if isinstance(v, np.ndarray)}
    arrays["tombstones"] = copy.deepcopy(m.tombstones)
    return dict(map=arrays, recent=dict(lm.recent_points))


@pytest.fixture(scope="module")
def events():
    planes = synth_render.default_world(np.random.default_rng(WORLD_SEED))
    R, t = synth_render.orbit_trajectory(60)
    slam = jsystem.System(
        JCAM, jsystem.MONOCULAR,
        map_cfg=jms.MapConfig(**MAP_KW),
        tracking_cfg=jtracking.TrackingConfig(n_features=N_FEAT,
                                              min_init_matches=MIN_INIT),
        enable_loop_closing=False)
    lm = slam.local_mapper
    out = []
    for name in STAGES:
        orig = getattr(lm, name)

        def wrapped(k, *a, _orig=orig, _name=name):
            if _name == STAGES[0]:
                out.append(dict(kf=int(k)))
            out[-1][_name] = _snap(lm.map, lm)
            res = _orig(k, *a)
            out[-1][_name + ":after"] = _snap(lm.map, lm)
            return res
        setattr(lm, name, wrapped)
    for i in range(N_FRAMES):
        img = synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0]
        slam.track_monocular(img, 0.05 * i)
    assert len(out) >= 8
    return out


def _jax_map(arrays):
    m = jms.MapStore(jms.MapConfig(**MAP_KW))
    for k, v in arrays.items():
        setattr(m, k, copy.deepcopy(v))
    m.version += 1
    return m


def _port_map(arrays):
    return mapstore.MapStore.from_numpy(arrays, mapstore.MapConfig(**MAP_KW),
                                        "cpu")


def _pick(events, which):
    culls = [e for e in events
             if (e["_keyframe_culling"]["map"]["kf_valid"]
                 != e["_keyframe_culling:after"]["map"]["kf_valid"]).any()]
    return {"first": events[1], "middle": events[len(events) // 2],
            "last": events[-1], "culls": culls[0] if culls else None}[which]


def _same_map(tm, arrays, names=None):
    for name, arr in tm.to_numpy().items():
        if names is None or name in names:
            np.testing.assert_array_equal(arr, arrays[name], err_msg=name)


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_map_point_culling_drops_the_same_points(events, which):
    ev = _pick(events, which)
    before, after = ev["_map_point_culling"], ev["_map_point_culling:after"]
    m = _port_map(before["map"])
    lm = local_mapping.LocalMapper(m, CAM)
    lm.recent_points = dict(before["recent"])
    n = lm._map_point_culling(ev["kf"])
    assert n == int(before["map"]["pt_valid"].sum()
                    - after["map"]["pt_valid"].sum())
    _same_map(m, after["map"])
    assert lm.recent_points == after["recent"]


def _dlt64(Ra, ta, xa, Rb, tb, xb):
    """The DLT null direction as both packages define it (the normal
    matrix's adjugate column of largest diagonal, multiplied by the
    adjugate once more), in float64 numpy: the value both approximate."""
    def rows(R, t, x):
        P = np.concatenate([R, t[:, None]], 1).astype(np.float64)
        return [x[:, 0:1] * P[2] - P[0], x[:, 1:2] * P[2] - P[1]]
    A = np.stack(rows(Ra, ta, xa.astype(np.float64))
                 + rows(Rb, tb, xb.astype(np.float64)), 1)   # [N, 4, 4]
    M = np.swapaxes(A, 1, 2) @ A
    adj = np.empty_like(M)
    for i in range(4):
        for j in range(4):
            minor = np.delete(np.delete(M, j, axis=1), i, axis=2)
            adj[:, i, j] = (-1.0) ** (i + j) * np.linalg.det(minor)
    k = np.argmax(np.abs(np.diagonal(adj, axis1=1, axis2=2)), axis=1)
    col = np.take_along_axis(adj, k[:, None, None], axis=2)[..., 0]
    col /= np.linalg.norm(col, axis=1, keepdims=True)
    v = np.einsum("nij,nj->ni", adj, col)
    return v[:, :3] / v[:, 3:]


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_search_and_triangulate_agrees(events, which):
    """Every covisible pair of the event's triangulation stage, in both
    packages, from the same keyframes: ``ok`` equal on >= 99 % of the
    features; where both accept, the same match and xyz within 1e-4 m.
    The port solves the DLT in float64; the JAX package's float32 adjugate
    strays more than 1e-4 m from it on some low-parallax pairs (ROADMAP.md
    section 3). Where the JAX point is more than 1e-4 m off the
    same algorithm in float64 numpy, the port's point must be that value
    within 1e-6 m instead."""
    ev = _pick(events, which)
    arrays = ev["_create_new_map_points"]["map"]
    m = _port_map(arrays)
    k = ev["kf"]
    nbs, _ = m.covisibility(k, min_weight=10)
    assert len(nbs) >= 1
    _, inv_s2 = kernels.level_weights(m.cfg.n_levels, m.cfg.scale)
    free_a = m.kf_feat_valid[k] & (m.kf_feat_point[k] < 0)
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    n_feat = n_agree = n_both = n_jax_off = 0
    for b in nbs[:20]:
        free_b = m.kf_feat_valid[b] & (m.kf_feat_point[b] < 0)
        j = jkernels.search_and_triangulate(
            JSE3(jnp.asarray(m.kf_R[k]), jnp.asarray(m.kf_t[k])),
            JSE3(jnp.asarray(m.kf_R[b]), jnp.asarray(m.kf_t[b])),
            jnp.asarray(arrays["kf_feat_desc"][k]),
            jnp.asarray(m.kf_feat_xyn[k]), jnp.asarray(m.kf_feat_level[k]),
            jnp.asarray(free_a), jnp.asarray(arrays["kf_feat_desc"][b]),
            jnp.asarray(m.kf_feat_xyn[b]), jnp.asarray(m.kf_feat_level[b]),
            jnp.asarray(free_b), jnp.asarray(inv_s2[m.kf_feat_level[k]]),
            jnp.asarray(inv_s2[m.kf_feat_level[b]]), focal=float(CAM.fx))
        p = kernels.search_and_triangulate(
            SE3(t_(m.kf_R[k]), t_(m.kf_t[k])),
            SE3(t_(m.kf_R[b]), t_(m.kf_t[b])), t_(m.kf_feat_desc[k]),
            t_(m.kf_feat_xyn[k]), t_(m.kf_feat_level[k]), t_(free_a),
            t_(m.kf_feat_desc[b]), t_(m.kf_feat_xyn[b]),
            t_(m.kf_feat_level[b]), t_(free_b),
            t_(inv_s2[m.kf_feat_level[k]]), t_(inv_s2[m.kf_feat_level[b]]),
            focal=float(CAM.fx))
        ok_j, ok_p = np.asarray(j.ok), p.ok.numpy()
        n_feat += len(ok_j)
        n_agree += int((ok_j == ok_p).sum())
        both = np.where(ok_j & ok_p)[0]
        n_both += len(both)
        idx = p.idx_b.numpy()[both]
        np.testing.assert_array_equal(idx, np.asarray(j.idx_b)[both])
        xp, xj = p.xyz.numpy()[both], np.asarray(j.xyz)[both]
        exact = _dlt64(m.kf_R[k], m.kf_t[k], m.kf_feat_xyn[k][both],
                       m.kf_R[b], m.kf_t[b], m.kf_feat_xyn[b][idx])
        near = np.abs(xp - xj).max(1) <= 1e-4
        jax_off = np.abs(xj - exact).max(1) > 1e-4
        port_exact = np.abs(xp - exact).max(1) <= 1e-6
        assert (near | (jax_off & port_exact)).all()
        n_jax_off += int(jax_off.sum())
    assert n_agree >= 0.99 * n_feat, (n_agree, n_feat)
    assert n_both > 0 and n_jax_off <= 0.1 * n_both


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_create_new_map_points_counts(events, which):
    ev = _pick(events, which)
    before = ev["_create_new_map_points"]
    after = ev["_create_new_map_points:after"]
    m = _port_map(before["map"])
    lm = local_mapping.LocalMapper(m, CAM)
    lm.recent_points = dict(before["recent"])
    n = lm._create_new_map_points(ev["kf"])
    n_jax = len(after["recent"]) - len(before["recent"])
    assert n == len(lm.recent_points) - len(before["recent"])
    assert n_jax > 0 and abs(n - n_jax) <= 0.05 * n_jax, (n, n_jax)
    assert m.check_invariants() == []


def _record_fuses(m):
    calls = []
    orig = m.fuse_observations

    def rec(kf, pids, feats):
        calls.append((int(kf), np.asarray(pids, np.int64).tolist(),
                      np.asarray(feats, np.int64).tolist()))
        return orig(kf, pids, feats)
    m.fuse_observations = rec
    return calls


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_fuse_passes_give_the_same_matches(events, which):
    """Forward (neighbours' points into k, one search) and reverse (k's
    points into each first-level neighbour, one search each): the same
    fuse calls in the same order, and the same arrays after."""
    ev = _pick(events, which)
    arrays = ev["_fuse_neighbors"]["map"]
    jm, tm = _jax_map(arrays), _port_map(arrays)
    jcalls, tcalls = _record_fuses(jm), _record_fuses(tm)
    jlm.LocalMapper(jm, JCAM)._fuse_neighbors(ev["kf"])
    changed = local_mapping.LocalMapper(tm, CAM)._fuse_neighbors(ev["kf"])
    assert len(tcalls) >= 2 and tcalls[0][0] == ev["kf"]
    assert tcalls == jcalls
    assert changed > 0 and sum(len(c[1]) for c in tcalls) > 0
    _same_map(tm, {k: (v.view(np.uint32) if k in ("kf_feat_desc", "pt_desc")
                       else v) for k, v in vars(jm).items()
                   if isinstance(v, np.ndarray)})


@pytest.mark.parametrize("which", ["culls", "first", "last"])
def test_keyframe_culling_culls_the_same_keyframes(events, which):
    ev = _pick(events, which)
    assert ev is not None, "no keyframe was culled in the JAX run"
    before, after = ev["_keyframe_culling"], ev["_keyframe_culling:after"]
    m = _port_map(before["map"])
    culled = local_mapping.LocalMapper(m, CAM)._keyframe_culling(ev["kf"])
    jax_culled = np.where(before["map"]["kf_valid"]
                          & ~after["map"]["kf_valid"])[0]
    assert sorted(culled) == jax_culled.tolist()
    if which == "culls":
        assert len(culled) >= 1
    _same_map(m, after["map"])
    assert set(m.tombstones) == set(after["map"]["tombstones"])


@pytest.mark.parametrize("frac,gap", [(1.0, 1), (0.85, 1), (0.5, 1),
                                      (0.02, 1), (1.0, 25), (0.02, 25)])
def test_need_new_keyframe_same_answer(events, frac, gap):
    """The same map, reference keyframe, frame counters and matches: the
    same decision, for tracking as strong as the reference keyframe, a
    little and much weaker, collapsed, and after a long gap."""
    answers = []
    for ev in (events[1], events[len(events) // 2], events[-1]):
        arrays = ev["_keyframe_culling:after"]["map"]
        k = ev["kf"]
        if not arrays["kf_valid"][k]:
            continue
        fp = arrays["kf_feat_point"][k].copy()
        has = np.where(fp >= 0)[0]
        drop = has[int(frac * len(has)):]
        fp[drop] = -1
        jm = _jax_map(arrays)
        jtk = jtracking.Tracker(JCAM, jm, jtracking.TrackingConfig(
            n_features=N_FEAT))
        tk = tracking.Tracker(CAM, _port_map(arrays), tracking.TrackingConfig(
            n_features=N_FEAT), device="cpu")
        for x in (jtk, tk):
            x.ref_kf, x.cur_match = k, fp
            x.frame_id, x.last_kf_frame_id = 40 + gap, 40
        a = tk._need_new_keyframe()
        assert a == jtk._need_new_keyframe()
        # the anchor count is cached per map version
        assert tk._need_new_keyframe() == a
        answers.append(a)
    assert answers
    if frac == 0.02:
        assert not any(answers)      # too few tracked points to insert


def test_config_and_full_obs_cap_match_jax(events):
    import dataclasses
    import types
    pc, jc = local_mapping.LocalMappingConfig(), jlm.LocalMappingConfig()
    for f in dataclasses.fields(pc):
        assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    for ev in events[::4]:
        arrays = ev["_keyframe_culling:after"]["map"]
        assert (local_mapping.full_obs_cap(_port_map(arrays))
                == jlm.full_obs_cap(_jax_map(arrays)) == 32768)
    big = types.SimpleNamespace(kf_feat_point=np.zeros((80, 512), np.int32),
                                kf_valid=np.ones(80, bool))
    assert local_mapping.full_obs_cap(big) == jlm.full_obs_cap(big) == 65536
