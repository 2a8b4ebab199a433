"""The monocular bootstrap path of the port against the JAX package's, on
the CPU at a small size: 376x240 (half EuRoC), 512 features, capacity 32
keyframes / 2048 points, 26 rendered frames fed from NO_IMAGES_YET.
``min_init_matches`` is 50 on both sides (the level-0 matches of 512
features never reach the default 100).

Both trackers are held to the same gates, not to identical trajectories:
initialised within 22 frames, >= 40 points after the initial BA, a
consistent map, the next frame tracked, >= 5 further frames tracked,
scale-aligned ATE < 0.05 m (the gate of ``tests/test_pipeline_mono.py``).
Both trackers insert keyframes while they track (neither runs a local
mapper): the port's keyframes are taken at the same frames as the JAX
tracker's.

On the map that the JAX tracker built (loaded into the port through
``MapStore.from_numpy``) the two packages are compared step by step:
``build_ba_problem`` equal; ``run_local_ba`` to poses within 1e-4, points
within 1e-3 and the same detached observations; reference-keyframe
tracking of the next frame (same features on both sides) to the same
match set and a pose within 1e-4; the map queries equal.
"""
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import mapstore as jmapstore
from orb_slam3_detailed_comments_tpu.models import cameras as jcameras
from orb_slam3_detailed_comments_tpu.optim import ba as jba
from orb_slam3_detailed_comments_tpu.pipeline import kernels as jkernels
from orb_slam3_detailed_comments_tpu.pipeline import local_mapping as jlm
from orb_slam3_detailed_comments_tpu.pipeline import tracking as jtracking
from orb_slam3_detailed_comments_tpu_torch.lie import SE3
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import (
    kernels, local_mapping, tracking)
from orb_slam3_detailed_comments_tpu_torch.utils import (
    evaluate_ate, synth_render)

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM, JCAM = cameras.pinhole(**CAM_KW), jcameras.pinhole(**CAM_KW)
N_FRAMES, N_FEAT, MIN_INIT = 26, 512, 50
MAP_KW = dict(max_kf=32, max_pt=2048, n_feat=N_FEAT)
TS = 0.05 * np.arange(N_FRAMES)


def _arrays(m):
    return {k: v.copy() for k, v in vars(m).items()
            if isinstance(v, np.ndarray)}


def _jax_map_from(arrays):
    m = jmapstore.MapStore(jmapstore.MapConfig(**MAP_KW))
    for k, v in arrays.items():
        setattr(m, k, v.copy())
    m.version += 1
    return m


def _prep_to_torch(jp):
    t = lambda a: torch.from_numpy(np.array(a))
    f = jp.feat
    feat = extractor.FrameFeatures(
        t(f.xy), t(f.level), t(f.angle), t(f.score),
        torch.from_numpy(np.array(f.desc).view(np.int32)), t(f.valid))
    return kernels.PreparedFrame(feat, t(jp.xy_ud), t(jp.xyn))


@pytest.fixture(scope="module")
def runs():
    planes = synth_render.default_world(np.random.default_rng(7))
    R, t = synth_render.orbit_trajectory(60)
    frames = [synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0]
              for i in range(N_FRAMES)]
    C = synth_render.camera_centers(R, t)[:N_FRAMES]

    # the JAX tracker; its map and state are snapshotted right after it
    # initialises, and it tracks the next frame's reference-keyframe stage
    # once more by itself for the step-by-step comparison
    jm = jmapstore.MapStore(jmapstore.MapConfig(**MAP_KW))
    jtk = jtracking.Tracker(JCAM, jm, jtracking.TrackingConfig(
        n_features=N_FEAT, min_init_matches=MIN_INIT))
    jax_run = dict(poses=[], init_at=None)
    for i, img in enumerate(frames):
        if jax_run["init_at"] == i - 1 and i > 0:
            jp = jkernels.prepare_frame(jnp.asarray(img, jnp.float32), JCAM,
                                        jtk.orb_cfg)
            assert jtk._track_reference_keyframe(jp, TS[i], i)
            jax_run["ref_kf_stage"] = dict(
                prep=jp, match=jtk.cur_match.copy(),
                R=np.asarray(jtk.cur_T.R).copy(),
                t=np.asarray(jtk.cur_T.t).copy())
        T = jtk.track_monocular(img, float(TS[i]))
        jax_run["poses"].append(T)
        if T is not None and jax_run["init_at"] is None:
            jax_run.update(init_at=i, n_points=jm.n_points,
                           errs=jm.check_invariants(), map=_arrays(jm),
                           ref_kf=jtk.ref_kf,
                           last_R=np.asarray(jtk.last.T_cw.R).copy(),
                           last_t=np.asarray(jtk.last.T_cw.t).copy())
    jax_run["kf_frames"] = sorted(jm.kf_frame_id[jm.kf_valid].tolist())

    m = mapstore.MapStore(mapstore.MapConfig(**MAP_KW), "cpu")
    tk = tracking.Tracker(CAM, m, tracking.TrackingConfig(
        n_features=N_FEAT, min_init_matches=MIN_INIT, frontend="fused"),
        device="cpu")
    torch_run = dict(poses=[], init_at=None, steps=[])
    for i, img in enumerate(frames):
        T = tk.track_monocular(img, float(TS[i]))
        torch_run["poses"].append(T)
        torch_run["steps"].append(tk.n_steps)
        if T is not None and torch_run["init_at"] is None:
            torch_run.update(init_at=i, n_points=m.n_points,
                             errs=m.check_invariants())
    torch_run.update(tracker=tk, map=m,
                     kf_frames=sorted(m.kf_frame_id[m.kf_valid].tolist()))
    return dict(jax=jax_run, torch=torch_run, C=C)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_bootstrap_gates(runs, which):
    run = runs[which]
    i0 = run["init_at"]
    assert i0 is not None and i0 < 22
    assert run["n_points"] >= 40 and run["errs"] == []
    assert run["poses"][i0 + 1] is not None
    tracked = [i for i, T in enumerate(run["poses"]) if T is not None]
    assert len(tracked) >= 7
    est = np.array([-run["poses"][i][:3, :3].T @ run["poses"][i][:3, 3]
                    for i in tracked])
    rmse, n, _ = evaluate_ate.ate_rmse(TS, runs["C"], TS[tracked], est)
    assert n == len(tracked) and rmse < 0.05


def test_both_initialise_alike(runs):
    """Same frame pair and a map of the same size within 10 %."""
    j, t = runs["jax"], runs["torch"]
    assert j["init_at"] == t["init_at"]
    assert abs(j["n_points"] - t["n_points"]) <= 0.1 * j["n_points"]


def test_port_takes_reference_keyframe_then_steady_steps(runs):
    run = runs["torch"]
    i0, steps, tk = run["init_at"], run["steps"], run["tracker"]
    assert steps[i0 + 1] == 0                  # reference KF + local map
    assert steps[i0 + 2] == 1 and steps[i0 + 5] == 4
    # keyframes inserted while tracking, at the JAX tracker's frames
    assert run["map"].n_kf > 2
    assert run["kf_frames"] == runs["jax"]["kf_frames"]
    assert tk.new_keyframes == list(run["map"].kf_ids())
    assert len(tk.trajectory) == len(tk.track_stats) == sum(
        T is not None for T in run["poses"])
    ts_, _, rk, _, R_cr, t_cr, state = tk.trajectory[1]
    assert state == tracking.OK and rk in (0, 1) and R_cr.shape == (3, 3)
    assert (run["map"].pt_found > 1).sum() > 20


@pytest.fixture(scope="module")
def shared(runs):
    """The JAX tracker's map right after initialisation, in both packages."""
    arrays = runs["jax"]["map"]
    return arrays, mapstore.MapStore.from_numpy(
        arrays, mapstore.MapConfig(**MAP_KW), "cpu")


def test_map_round_trip_and_queries(shared):
    arrays, m = shared
    jm = _jax_map_from(arrays)
    back = m.to_numpy()
    for name in ("kf_R", "kf_t", "kf_feat_point", "kf_feat_desc", "pt_xyz",
                 "pt_desc", "pt_ref_kf", "pt_first_kf", "pt_found",
                 "pt_visible", "kf_epoch"):
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)
    assert m.check_invariants() == jm.check_invariants() == []
    ids = m.local_point_ids(np.array([0, 1]))
    np.testing.assert_array_equal(ids, jm.local_point_ids(np.array([0, 1])))
    assert len(ids) == m.n_points
    np.testing.assert_array_equal(m.observers_of_points(ids[:5]),
                                  jm.observers_of_points(ids[:5]))
    np.testing.assert_array_equal(m.observation_counts(),
                                  jm.observation_counts())
    for a, b in zip(m.covisibility(0, 15), jm.covisibility(0, 15)):
        np.testing.assert_array_equal(a, b)
    m2 = copy.deepcopy(m)
    m2.remove_points(ids[:7])
    jm.remove_points(ids[:7])
    np.testing.assert_array_equal(m2.kf_feat_point, jm.kf_feat_point)
    np.testing.assert_array_equal(m2.pt_valid, jm.pt_valid)
    assert m2.check_invariants() == []


def test_build_ba_problem_equal(shared):
    arrays, m = shared
    p_t, meta_t = local_mapping.build_ba_problem(m, [0, 1], [0],
                                                 max_points=512, max_obs=2048)
    p_j, meta_j = jlm.build_ba_problem(_jax_map_from(arrays), [0, 1], [0],
                                       max_points=512, max_obs=2048)
    for k, v in p_t._asdict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(p_j, k)),
                                      err_msg=k)
    assert meta_t["table_depth"] == meta_j["table_depth"] == 4
    assert meta_t["cams"] == meta_j["cams"] and p_t.kf_R.shape[0] == 8
    np.testing.assert_array_equal(meta_t["pt_ids"], meta_j["pt_ids"])


def test_run_local_ba_matches(shared, monkeypatch):
    arrays, m = shared
    monkeypatch.setattr(jba, "USE_PACKED", False)
    m = copy.deepcopy(m)
    jm = _jax_map_from(arrays)
    # disturb the second keyframe and the points alike on both sides
    rng = np.random.default_rng(0)
    dt = rng.normal(0, 0.01, 3).astype(np.float32)
    dX = rng.normal(0, 0.01, m.pt_xyz.shape).astype(np.float32)
    for mm in (m, jm):
        mm.kf_t[1] += dt
        mm.pt_xyz[mm.pt_valid] += dX[mm.pt_valid]
    v0 = m.version
    local_mapping.run_local_ba(m, [0, 1], [0], CAM, iters=20,
                               max_points=512, max_obs=2048)
    jlm.run_local_ba(jm, [0, 1], [0], JCAM, iters=20, max_points=512,
                     max_obs=2048)
    assert m.version > v0
    np.testing.assert_allclose(m.kf_R[:2], jm.kf_R[:2], atol=1e-4)
    np.testing.assert_allclose(m.kf_t[:2], jm.kf_t[:2], atol=1e-4)
    np.testing.assert_array_equal(m.kf_t[0], 0.0)          # held fixed
    np.testing.assert_array_equal(m.pt_valid, jm.pt_valid)
    np.testing.assert_array_equal(m.kf_feat_point, jm.kf_feat_point)
    np.testing.assert_allclose(m.pt_xyz[m.pt_valid], jm.pt_xyz[jm.pt_valid],
                               atol=1e-3)
    # the solve undid most of the disturbance
    assert np.abs(m.kf_t[1] - arrays["kf_t"][1]).max() < 0.5 * np.abs(dt).max()
    assert m.check_invariants() == []


def test_track_reference_keyframe_matches(runs, shared):
    """Same map, same start pose and the same features (the JAX frame's):
    the same match set and a pose within 1e-4."""
    _, m = shared
    j = runs["jax"]
    stage = j["ref_kf_stage"]
    i = j["init_at"] + 1
    tk = tracking.Tracker(CAM, copy.deepcopy(m), tracking.TrackingConfig(
        n_features=N_FEAT), device="cpu")
    tk.ref_kf, tk.state = j["ref_kf"], tracking.OK
    tk.last = tracking.FrameRecord(SE3(j["last_R"], j["last_t"]), None,
                                   float(TS[i - 1]), i - 1)
    assert tk._track_reference_keyframe(_prep_to_torch(stage["prep"]),
                                        float(TS[i]), i)
    np.testing.assert_array_equal(tk.cur_match, stage["match"])
    assert (tk.cur_match >= 0).sum() >= 20
    np.testing.assert_allclose(tk.cur_T.R, stage["R"], atol=1e-4)
    np.testing.assert_allclose(tk.cur_T.t, stage["t"], atol=1e-4)
    # and the local-map stage goes on from there
    assert tk._track_local_map()
    assert (tk.cur_match >= 0).sum() >= (stage["match"] >= 0).sum()


def test_a_tracker_on_a_foreign_map_stays_lost(shared):
    """A non-empty map the tracker neither built nor was started from needs
    relocalisation, which is not ported: frames return None."""
    _, m = shared
    tk = tracking.Tracker(CAM, copy.deepcopy(m), tracking.TrackingConfig(
        n_features=N_FEAT), device="cpu")
    img = np.random.default_rng(1).uniform(0, 255, (240, 376))
    assert tk.track_monocular(img.astype(np.float32), 0.0) is None
    assert tk.state == tracking.LOST and tk.n_steps == 0


def test_ate_rmse_matches_jax_package():
    from orb_slam3_detailed_comments_tpu.utils import evaluate_ate as jate
    rng = np.random.default_rng(2)
    gt = np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0)
    est = 3.7 * gt[::2] @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]) \
        + rng.normal(0, 0.01, (20, 3)) + 5.0
    ts = 0.05 * np.arange(40)
    got = evaluate_ate.ate_rmse(ts, gt, ts[::2], est)
    ref = jate.ate_rmse(ts, gt, ts[::2], est)
    assert got == ref and got[1] == 20 and got[0] < 0.02
    assert abs(got[2] - 1 / 3.7) < 0.01
    assert evaluate_ate.ate_rmse(ts, gt, ts[:2], est[:2])[0] == float("inf")
