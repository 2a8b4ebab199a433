"""The JAX package's six long acceptance runs on the port.

Each case is built by ``chip_smoke.long_case`` (``chip_smoke.py`` phase
15 runs the same function on the card) as its JAX test builds it:

- ``stress``: ``tests/test_pipeline_stress.py::test_long_adversarial_loop``,
  520 monocular frames around the stress box with its degradations;
- ``stress_async``: the same 520 frames with ``async_mapping=True``
  (``test_long_adversarial_loop_async``);
- ``stress_inertial``: the 520-frame ``IMU_MONOCULAR`` gauntlet with a
  visual blackout (``test_long_adversarial_inertial_loop``);
- ``stereo_gauntlet``: 400 stereo frames with ``fix_scale``
  (``tests/test_pipeline_metric_loops.py::
  test_stereo_gauntlet_fixed_scale_loop``);
- ``kb8_loop``: the KB8 stereo-inertial loop, 320 frames through VIBA2
  (``tests/test_pipeline_fisheye.py::
  test_fisheye_stereo_inertial_loop_closure``);
- ``flagship``: the TUM-VI flagship, a non-rectified KB8 pair plus IMU, 45
  frames (``test_fisheye_stereo_inertial_end_to_end``).

Tier 1 holds each case to its JAX test's helpers at two frames: the IMU
windows, frame times and true centres equal; the pinhole frames (the JAX
helpers' OpenCV homography renderer, here ``synth_render.render_frame``)
equal bit for bit but in the motion-blur segment, where ``degrade``'s blur
without OpenCV stays within 1e-3 grey levels (as in
``test_torch_inertial_loops.py``); the KB8 frames within
``KB8_RENDER_TOL``, since each package casts the camera's float32
bearings (up to 5 float32 ulps apart) through its own KB8 unprojection;
and the System's settings equal the test's. The slow tests run each case
through the port's ``System`` on the CPU at its full depth and assert its
JAX test's gates verbatim. Measured on an 8-core CPU, six at once: the
flagship (7 minutes), the stress loop (58) and the KB8 loop (30) pass;
the async stress loop misses its KF-only ATE (0.151 m against 0.04, 52
minutes: its racing global BAs take 5-33 s on a loaded CPU; it holds on
the card); the inertial gauntlet (scale 0.9758, 24 minutes) and the stereo
gauntlet (metric ATE 0.0611 m, 23 minutes) miss as the JAX package does
when its pyramid rounds as the port's (``tests/run_long_sequences.py``,
ROADMAP.md section 3).
"""
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.utils import synth_render as jsr
from orb_slam3_detailed_comments_tpu_torch.pipeline import system
from orb_slam3_detailed_comments_tpu_torch.utils import evaluate_ate

import chip_smoke
import test_pipeline_fisheye as jfish
import test_pipeline_metric_loops as jmetric
import test_pipeline_stress as jstress

torch.set_num_threads(2)
CPU = torch.device("cpu")
# the KB8 frames of the two packages' ray casters, in grey levels (largest
# difference measured 0.0223 over four frames of the two KB8 cases)
KB8_RENDER_TOL = 0.05
BLUR_TOL = 1e-3
TRUE_BG = np.array([-0.002, 0.003, 0.001], np.float32)
BASE = 0.11
# two frames of each case, through its degradation segments
FRAMES = dict(stress=(210, 470), stress_async=(100, 380),
              stress_inertial=(170, 260), stereo_gauntlet=(90, 170),
              kb8_loop=(130, 290), flagship=(0, 30))


def _jax_case(name):
    """(n, frame(i) -> the JAX helpers' image or pair, ts, centres, windows
    or None) of the JAX test's case."""
    n = dict(stress=520, stress_async=520, stress_inertial=520,
             stereo_gauntlet=400, kb8_loop=320, flagship=45)[name]
    if name in ("stress", "stress_async", "stereo_gauntlet"):
        walls = jstress.stress_world(np.random.default_rng(21))
        R, t = jstress.stress_trajectory(n)
        ts, centers, windows = (np.arange(n) * 0.05,
                                jsr.camera_centers(R, t), None)
        if name == "stereo_gauntlet":
            def frame(i):
                left, right = jsr.render_stereo_pair(jstress.CAM, walls, R[i],
                                                     t[i], BASE)
                return (jstress.degrade(left, i, n),
                        jstress.degrade(right, i, n))
        else:
            def frame(i):
                return jstress.degrade(jsr.render_frame(
                    jstress.CAM, walls, R[i], t[i]), i, n)
        return n, frame, ts, centers, windows
    if name == "stress_inertial":
        walls = jstress.stress_world(np.random.default_rng(33))
        traj = jsr.inertial_loop_trajectory(n, imu_per_frame=10,
                                            yaw_burst=(0.62, 0.72, 2.0))
        blank = np.full((jstress.CAM.height, jstress.CAM.width), 85.0,
                        np.float32)

        def frame(i):
            if 0.30 < i / n < 0.36:
                return blank
            return jstress.degrade(jsr.render_frame(
                jstress.CAM, walls, traj["R_cw"][i], traj["t_cw"][i]), i, n)
        return n, frame, traj["ts"], traj["centers"], traj["windows"]
    if name == "kb8_loop":
        walls = jstress.stress_world(np.random.default_rng(29), half=4.0)
        traj = jsr.inertial_loop_trajectory(n, imu_per_frame=12,
                                            true_bg=TRUE_BG)
    else:
        walls = jsr.default_world(np.random.default_rng(23))
        traj = jsr.inertial_trajectory(n, true_bg=TRUE_BG)

    def frame(i):
        R, t = traj["R_cw"][i], traj["t_cw"][i]
        left = jsr.render_frame_raycast(jfish.CAM, walls, R, t)
        c_r = -R.T @ t + R.T @ np.array([BASE, 0.0, 0.0])
        right = jsr.render_frame_raycast(jfish.CAM, walls, R,
                                         (-R @ c_r).astype(np.float32))
        if name == "flagship":
            return left, right
        return jstress.degrade(left, i, n), jstress.degrade(right, i, n)
    return n, frame, traj["ts"], traj["centers"], traj["windows"]


@pytest.mark.parametrize("name,i", [(name, i) for name, pair in
                                    FRAMES.items() for i in pair])
def test_case_equals_the_jax_test(name, i):
    case = chip_smoke.long_case(name)
    n, frame, ts, centers, windows = _jax_case(name)
    assert case["n"] == n
    np.testing.assert_array_equal(case["ts"], ts)
    np.testing.assert_array_equal(case["centers"], centers)
    if windows is None:
        assert case["windows"] is None
    else:
        assert len(case["windows"]) == n
        assert (case["windows"][i] is None) == (windows[i] is None)
        for a, b in zip(case["windows"][i] or (), windows[i] or ()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    mine, ref = case["frame"](i, CPU), frame(i)
    if not isinstance(ref, tuple):
        mine, ref = (mine,), (ref,)
    assert len(mine) == len(ref)
    blur = 0.38 < i / n < 0.46 and name != "flagship"
    tol = (KB8_RENDER_TOL if name in ("kb8_loop", "flagship")
           else BLUR_TOL if blur else 0.0)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() <= tol, np.abs(a - b).max()
    if blur:                             # the blur did blur
        sharp = case["frame"](i - 30, CPU)
        assert not np.array_equal(np.asarray(mine[0]), np.asarray(sharp))


@pytest.mark.parametrize("name", list(FRAMES))
def test_case_settings_equal_the_jax_test(name):
    """The camera, the sensor and the System's keywords of the JAX test."""
    case = chip_smoke.long_case(name)
    kb8 = name in ("kb8_loop", "flagship")
    ref_cam = jfish.CAM if kb8 else jstress.CAM
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(case["cam"], f) == getattr(ref_cam, f), f
    assert tuple(case["cam"].dist) == tuple(float(x) for x in ref_cam.dist)
    sensor, kw = case["sensor"], case["system_kw"]
    want = dict(stress=(system.MONOCULAR, dict(enable_loop_closing=True,
                                               async_mapping=False)),
                stress_async=(system.MONOCULAR, dict(enable_loop_closing=True,
                                                     async_mapping=True)),
                stress_inertial=(system.IMU_MONOCULAR,
                                 dict(enable_loop_closing=True)),
                stereo_gauntlet=(system.STEREO, dict(
                    baseline=BASE, enable_loop_closing=True)),
                kb8_loop=(system.IMU_STEREO, dict(enable_loop_closing=True)),
                flagship=(system.IMU_STEREO, dict(enable_loop_closing=False)))
    assert sensor == want[name][0]
    for k, v in want[name][1].items():
        assert kw[k] == v, k
    if kb8:
        assert kw["camera2"] is case["cam"]
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = BASE
        np.testing.assert_array_equal(kw["T_c1c2"], T)
    else:
        assert "camera2" not in kw


def _keypoints(f):
    return {(float(x), float(y), int(lv)) for (x, y), lv, ok in zip(
        np.asarray(f.xy).tolist(), np.asarray(f.level).tolist(),
        np.asarray(f.valid).tolist()) if ok}


@pytest.mark.parametrize("name", ["stress_inertial", "stereo_gauntlet"])
def test_frame_0_parts_from_jax_only_at_the_pyramid(name, monkeypatch):
    """Where the port's run of a case first parts from the JAX package's:
    frame 0's extraction (OrbConfig(): 1,024 features, 8 levels) keeps a
    few keypoints on one side only, all at resized levels; with the JAX
    package's resize (XLA-CPU's dots, whose rounding the port does not
    copy: ``tests/test_torch_extractor.py::
    test_resize_parts_from_xla_cpu_only_by_the_two_tap_rounding``) in
    place of the port's, the keypoints are the same. Measured: 10 of 1,024
    keypoints on one side only at levels 1-2 (stress_inertial), 4 at level
    1 (stereo_gauntlet's left image)."""
    import jax
    import jax.numpy as jnp
    from orb_slam3_detailed_comments_tpu.ops import extractor as jext
    from orb_slam3_detailed_comments_tpu.ops import pyramid as jpyr
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor, pyramid
    img = chip_smoke.long_case(name)["frame"](0, CPU)
    img = img[0] if isinstance(img, tuple) else img
    ref = _keypoints(jax.jit(lambda im: jext.extract(im, jext.OrbConfig()))(
        jnp.asarray(img)))
    mine = _keypoints(extractor.extract(torch.from_numpy(img),
                                        extractor.OrbConfig()))
    apart = ref ^ mine
    assert 0 < len(apart) <= 16 and min(k[2] for k in apart) >= 1
    resize = {}

    def jax_resize(x, nh, nw):
        if x.dim() == 3:
            return torch.stack([jax_resize(a, nh, nw) for a in x])
        key = (tuple(x.shape), nh, nw)
        if key not in resize:
            resize[key] = jax.jit(
                lambda a: jpyr.resize_bilinear_mm(a, nh, nw))
        return torch.from_numpy(np.array(resize[key](jnp.asarray(
            x.numpy()))))
    monkeypatch.setattr(pyramid, "resize_bilinear", jax_resize)
    assert _keypoints(extractor.extract(torch.from_numpy(img),
                                        extractor.OrbConfig())) == ref


# ------------------------------------------------------ the full-depth runs
def _run(name):
    """The case through the port's System on the CPU; prints its record
    with the values of its gates (chip_smoke.long_gates), which the test
    then asserts as its JAX test does."""
    slam, rec = chip_smoke.long_path(CPU, name, progress=20)
    missed = chip_smoke.long_gates(name, slam, rec)
    print({k: v for k, v in chip_smoke.long_summary(rec).items()
           if k != "expected"}, "missed:", missed)
    return slam, rec, chip_smoke.long_case(name)


def _rows(slam):
    rows = slam.trajectory_tum()
    return (np.array([r[0] for r in rows]),
            np.array([r[1:4] for r in rows]))


def _kf_centres(m):
    kids = m.kf_ids()
    fid = m.kf_frame_id[kids]
    kids = kids[fid >= 0]
    fid = fid[fid >= 0]
    kf_c = np.einsum("nij,nj->ni", np.transpose(m.kf_R[kids], (0, 2, 1)),
                     -m.kf_t[kids])
    return kids, fid, kf_c


@pytest.mark.slow
def test_long_adversarial_loop():
    slam, rec, case = _run("stress")
    n, n_ok, ts = case["n"], rec["tracked"], case["ts"]
    assert n_ok > 0.8 * n, f"tracked {n_ok}/{n}"
    assert len(slam.atlas.maps) == 1, "lost hard enough to spawn a new map"
    assert slam.loop_closer is not None
    assert slam.loop_closer.n_loops_closed >= 1

    est_ts, est_xyz = _rows(slam)
    gt_xyz = case["centers"]
    rmse, npair, scale = evaluate_ate.ate_rmse(ts, gt_xyz, est_ts, est_xyz)
    assert npair > 0.8 * n
    assert rmse < 0.08, f"ATE {rmse:.4f} m over {npair} (scale {scale:.3f})"
    kids, fid, kf_c = _kf_centres(slam.map)
    assert len(kids) >= 60
    _, _, _, aligned = evaluate_ate.align_horn(kf_c, gt_xyz[fid])
    rmse_kf = float(np.sqrt(((aligned - gt_xyz[fid]) ** 2).sum(1).mean()))
    assert rmse_kf < 0.02, f"KF-only ATE {rmse_kf:.4f} m over {len(kids)}"
    assert slam.check_map_consistency() == []


@pytest.mark.slow
def test_long_adversarial_loop_async():
    slam, rec, case = _run("stress_async")      # shutdown() inside
    n, n_ok, ts = case["n"], rec["tracked"], case["ts"]
    assert n_ok > 0.8 * n, f"tracked {n_ok}/{n}"
    assert len(slam.atlas.maps) == 1
    assert slam.loop_closer.n_loops_closed >= 1
    assert (slam.loop_closer.n_gba_runs
            + slam.loop_closer.n_gba_aborted) >= 1

    gt_xyz = case["centers"]
    kids, fid, kf_c = _kf_centres(slam.map)
    assert len(kids) >= 60
    _, _, _, aligned = evaluate_ate.align_horn(kf_c, gt_xyz[fid])
    rmse_kf = float(np.sqrt(((aligned - gt_xyz[fid]) ** 2).sum(1).mean()))
    assert rmse_kf < 0.04, f"async KF-only ATE {rmse_kf:.4f} m"
    assert slam.check_map_consistency() == []
    est_ts, est_xyz = _rows(slam)
    rmse, npair, scale = evaluate_ate.ate_rmse(ts, gt_xyz, est_ts, est_xyz)
    assert npair > 0.8 * n
    assert rmse < 0.15, f"async ATE {rmse:.4f} m over {npair}"


@pytest.mark.slow
def test_long_adversarial_inertial_loop():
    from orb_slam3_detailed_comments_tpu_torch.imu import factors
    from orb_slam3_detailed_comments_tpu_torch.pipeline.inertial import (
        GRAVITY_MAG)
    slam, rec, case = _run("stress_inertial")
    n, n_ok = case["n"], rec["tracked"]
    # the keyframe count ahead of the first frame past u = 0.30 and 0.36
    kf_blackout = [None, None]
    for i in range(n):
        u = i / n
        if kf_blackout[0] is None and u > 0.30:
            kf_blackout[0] = rec["kf_before"][i]
        if kf_blackout[1] is None and u > 0.36:
            kf_blackout[1] = rec["kf_before"][i]
    assert n_ok > 0.8 * n, f"tracked {n_ok}/{n}"
    assert len(slam.atlas.maps) == 1, "lost hard enough to spawn a new map"
    assert slam.map.imu_initialized
    assert kf_blackout[1] > kf_blackout[0], \
        f"no keyframes through blackout ({kf_blackout})"
    assert slam.loop_closer is not None
    assert slam.loop_closer.n_loops_closed >= 1

    est_ts, est_xyz = _rows(slam)
    rmse, npair, scale = evaluate_ate.ate_rmse(
        case["ts"], case["centers"], est_ts, est_xyz)
    assert npair > 0.8 * n
    assert abs(scale - 1.0) < 0.02, f"metric scale {scale:.4f}"
    assert rmse < 0.10, f"ATE {rmse:.4f} m over {npair} (scale {scale:.3f})"
    m = slam.map
    kids, fid, kf_c = _kf_centres(m)
    assert len(kids) >= 60
    _, _, _, aligned = evaluate_ate.align_horn(kf_c, case["centers"][fid])
    rmse_kf = float(np.sqrt(((aligned - case["centers"][fid]) ** 2)
                            .sum(1).mean()))
    assert rmse_kf < 0.03, f"KF-only ATE {rmse_kf:.4f} m over {len(kids)}"

    res = chip_smoke.chain_preintegration_residuals(m, factors, GRAVITY_MAG)
    assert res["edges"] > 0.8 * (res["chain"] - 1)
    assert res["er"] < 0.005, f"median rot residual {res['er']:.5f}"
    assert res["ev"] < 0.02, f"median vel residual {res['ev']:.5f}"
    assert res["ep"] < 0.01, f"median pos residual {res['ep']:.5f}"


@pytest.mark.slow
def test_stereo_gauntlet_fixed_scale_loop():
    slam, rec, case = _run("stereo_gauntlet")
    n, n_ok = case["n"], rec["tracked"]
    n_before, ate_before = rec["n_before"], rec["ate_before"]
    assert n_ok > 0.8 * n, f"tracked {n_ok}/{n}"
    assert len(slam.atlas.maps) == 1, "lost hard enough to spawn a new map"
    assert slam.loop_closer.cfg.fix_scale is True
    assert slam.loop_closer.n_loops_closed >= 1
    assert slam.loop_closer.n_loops_closed > n_before or n_before >= 1
    assert ate_before is not None and ate_before[0] < 0.15, \
        f"pre-loop metric ATE {ate_before[0]:.4f} m"

    rmse, npair, scale = chip_smoke.metric_ate(slam, case)
    assert npair > 0.8 * n
    assert rmse < 0.06, f"post-loop metric ATE {rmse:.4f} m over {npair}"
    assert abs(scale - 1.0) < 0.01, f"scale drift {scale:.4f}"
    kids, fid, kf_c = _kf_centres(slam.map)
    gt_xyz = case["centers"]
    assert len(kids) >= 40
    aligned = jmetric._metric_align(kf_c, gt_xyz[fid])
    rmse_kf = float(np.sqrt(((aligned - gt_xyz[fid]) ** 2).sum(1).mean()))
    assert rmse_kf < 0.04, f"KF-only metric ATE {rmse_kf:.4f} m"
    assert slam.check_map_consistency() == []


@pytest.mark.slow
def test_fisheye_stereo_inertial_loop_closure():
    slam, rec, case = _run("kb8_loop")
    n, n_ok = case["n"], rec["tracked"]
    assert n_ok > 0.8 * n, f"tracked {n_ok}/{n}"
    assert len(slam.atlas.maps) == 1
    assert slam.map.imu_initialized, "IMU never initialized on the KB8 pair"
    assert slam.map.imu_ba1 and slam.map.imu_ba2
    assert slam.loop_closer.cfg.fix_scale is True
    assert slam.loop_closer.n_loops_closed >= 1

    chain = slam.map.temporal_chain()
    bg_est = slam.map.kf_bg[chain[-1]]
    assert np.abs(bg_est - TRUE_BG).max() < 8e-3, bg_est

    est_ts, est_xyz = _rows(slam)
    rmse, npair, _ = evaluate_ate.ate_rmse(
        case["ts"], case["centers"], est_ts, est_xyz, with_scale=False)
    assert npair > 0.7 * n
    assert rmse < 0.25, f"KB8 loop metric ATE {rmse:.4f} m over {npair}"
    _, _, scale = evaluate_ate.ate_rmse(
        case["ts"], case["centers"], est_ts, est_xyz, with_scale=True)
    assert abs(scale - 1.0) < 0.06, f"scale drifted: {scale:.4f}"
    assert slam.check_map_consistency() == []


@pytest.mark.slow
def test_fisheye_stereo_inertial_end_to_end():
    slam, rec, case = _run("flagship")
    n, n_ok = case["n"], rec["tracked"]
    assert n_ok > 0.8 * n, f"tracked {n_ok}/{n}"
    assert slam.map.imu_initialized, "IMU init never ran on the KB8 pair"

    chain = slam.map.temporal_chain()
    bg_est = slam.map.kf_bg[chain[-1]]
    assert np.abs(bg_est - TRUE_BG).max() < 8e-3, bg_est

    est_ts, est_xyz = _rows(slam)
    rmse, npair, _ = evaluate_ate.ate_rmse(
        case["ts"], case["centers"], est_ts, est_xyz, with_scale=False)
    assert npair > 0.7 * n
    assert rmse < 0.05, f"KB8 stereo-inertial metric ATE {rmse:.4f} over {npair}"
    _, _, scale = evaluate_ate.ate_rmse(
        case["ts"], case["centers"], est_ts, est_xyz, with_scale=True)
    assert abs(scale - 1.0) < 0.04, f"metric scale drifted: {scale:.4f}"
