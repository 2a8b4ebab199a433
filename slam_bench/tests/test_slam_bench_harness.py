"""Tests of the benchmark's harness on the CPU: the cells' parts found by
name, the metrics' arithmetic on made-up inputs, the kernels' least work
at the cells' shapes, the import rule, and a rehearsal of whole runs at a
tiny size, sound and with the timed path broken underneath.

Run from the repository root: ``python -m pytest slam_bench/tests -q``.
The tests marked ``cuda`` need the card and skip elsewhere.
"""
from __future__ import annotations

import ast
import copy
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_bench import check, core, profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slam_bench"
TRAFFIC = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
# the fastest program whose window a feed has to fill at run_seconds
FEED_RATE = 40


def tiny_spec(cell: str = "euroc_stereo.explore", frames: int = 90) -> dict:
    """A cell at 376x240 with 512 features and a short, fast path: the
    size at which the CPU runs the port at ~0.1-1 s a frame, with enough
    frames that a window of a few seconds never runs dry on a fast host,
    and keyframe events (so bundle adjustments) inside it."""
    spec = core.load_cell(cell)
    cfg, tr = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    cfg["settings"].update({
        "Camera1.fx": 228.3575, "Camera1.fy": 228.3575, "Camera1.cx": 182.22,
        "Camera1.cy": 128.48, "Camera.width": 376, "Camera.height": 240,
        "ORBextractor.nFeatures": 512})
    tr["frames"] = frames
    tr["path"]["speed_m_per_frame"] = 0.08
    tr["setup"].update(frames=3, min_keyframes=1)
    tr["window"].update(min_s=0.5)
    tr["profile"].update(after_share=0.5, min_frames=1, max_frames=2,
                         min_kf_events=0)
    tr["check"].update(frames=3, ba_events=1)
    spec.update(config=cfg, traffic=tr)
    return spec


# a rehearsal's window that the clock closes: ~25 window frames at the
# CPU's ~0.5 s a frame, so that it holds bundle adjustments also on a host
# that runs it at half that speed (and the 90-pair feed outlasts it)
WINDOW_S = 12.0
# a feed that a rehearsal with a large --seconds runs to its end: enough
# window frames to hold bundle adjustments on any host
FEED_FRAMES = 30


def run_tiny(spec, seed=4_000_000_123, seconds=1e9, traced=False, **kw):
    torch.set_num_threads(4)
    return core.execute(spec, seed, seconds, traced, torch.device("cpu"),
                        time.time(), **kw)


def rehearse(capsys, window_end: str, traced=False):
    """A tiny run whose window the clock closes (``WINDOW_S``) or the feed
    (``FEED_FRAMES`` pairs under a large --seconds), with its result line
    and its diagnostics line."""
    if window_end == "seconds":
        out = run_tiny(tiny_spec(), seconds=WINDOW_S, traced=traced)
    else:
        out = run_tiny(tiny_spec(frames=FEED_FRAMES), traced=traced)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("diagnostics ")]
    diag = json.loads(lines[-1].split(" ", 1)[1])
    assert diag["window_end"] == window_end
    if window_end == "feed":
        assert out["attempted"] == FEED_FRAMES - 3     # tiny_spec's set-up
    return out, diag


# -- parts found by name ----------------------------------------------------

def test_every_cell_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        spec = core.load_cell(w["name"])
        assert spec["config"]["sensor"] in ("MONOCULAR", "STEREO")
        assert spec["traffic"]["frames"] > spec["traffic"]["setup"]["frames"]
        for m in spec["per_layer"]:
            assert callable(core.metric_reader(m["name"]))


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_traffic_file_builds_its_feed(name):
    """Each mix in the folder: the frames render, and the feed runs the
    path once in order at the mix's rate."""
    from slam_bench import traffic_gen
    spec = tiny_spec()
    tr = core.load_json(BENCH / "traffic" / f"{name}.json")
    tr["frames"] = 4
    rcfg = dict(camera=core.render_camera(spec["config"]), sensor="STEREO",
                baseline_m=0.11)
    t = traffic_gen.Traffic(tr, rcfg, 2 ** 31 + 7, torch.device("cpu"))
    assert t.frames.shape == (4, 240, 376) and t.frames.dtype == np.uint8
    assert t.frames_r.shape == t.frames.shape
    items = t.items(stereo=True)
    order = [next(items) for _ in range(4)]
    assert [round(x[2] * tr["rate_hz"]) for x in order] == [0, 1, 2, 3]
    assert t.fed == [0, 1, 2, 3]
    with pytest.raises(StopIteration):
        next(items)


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_feed_holds_a_full_window_at_40_frames_per_s(name):
    """After set-up, each mix's feed holds run_seconds of frames for a
    program at FEED_RATE frames/s, and its window floor lets a window that
    such a feed ends stand."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tr = core.load_json(BENCH / "traffic" / f"{name}.json")
    window_frames = tr["frames"] - tr["setup"]["frames"]
    assert window_frames >= FEED_RATE * bench["run_seconds"]
    assert 0 < tr["window"]["min_s"] <= window_frames / FEED_RATE


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_hall_reaches_past_the_path_by_cull_m(name):
    """The hall runs on for cull_m past the path's last camera, and the
    image corners of every frame of each rig that renders the mix meet
    the back wall inside the hall: no frame sees past either end."""
    from slam_bench import traffic_gen
    tr = core.load_json(BENCH / "traffic" / f"{name}.json")
    w = tr["world"]
    R, t = traffic_gen.sweep_path(int(tr["frames"]), tr["path"])
    C = -np.einsum("nji,nj->ni", R, t)
    assert w["x_to_m"] - C[:, 0].max() >= w["cull_m"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [c for c in bench["workloads"] if c["traffic"] == name]
    for cell in cells:
        cam = core.render_camera(core.load_cell(cell["name"])["config"])
        W, H = cam["width"], cam["height"]
        corners = np.array([[(u - cam["cx"]) / cam["fx"],
                             (v - cam["cy"]) / cam["fy"], 1.0]
                            for u in (0, W - 1) for v in (0, H - 1)])
        rays = np.einsum("kj,nji->nki", corners, R)      # R_cw^T r
        for b in (0.0, cam["baseline_m"]):
            Cb = C + b * R[:, 0, :]                       # along the rig's x
            d = (w["wall_depth_m"] - Cb[:, None, 2]) / rays[..., 2]
            x = Cb[:, None, 0] + d * rays[..., 0]
            assert w["x_from_m"] < x.min() and x.max() < w["x_to_m"], (cell, b)


@pytest.mark.parametrize("name", TRAFFIC)
def test_planes_no_camera_sees_are_left_out_of_the_render_alone(
        name, monkeypatch):
    """Leaving out the planes that may_show rules out changes no pixel, in
    batches of the feed's size spread along the path from its start to
    its end, on either camera of the pair; and it rules some out."""
    from slam_bench import traffic_gen
    cam = core.render_camera(tiny_spec()["config"])
    tr = core.load_json(BENCH / "traffic" / f"{name}.json")
    planes = traffic_gen.hall_world(np.random.default_rng(5), tr["world"])
    tex = [torch.from_numpy(p.texture).reshape(-1) for p in planes]
    rays = traffic_gen.camera_rays(cam, "cpu")
    R, t = traffic_gen.sweep_path(int(tr["frames"]), tr["path"])
    cull = float(tr["world"]["cull_m"])
    may_show = traffic_gen.may_show
    left_out = 0
    for b0 in np.linspace(0, len(R) - 16, 6).astype(int):
        for b in (0.0, 0.11):
            Rb, tb = R[b0:b0 + 16], t[b0:b0 + 16] - np.array([b, 0.0, 0.0])
            left_out += sum(not may_show(p, Rb, tb, cam) for p in planes)
            with monkeypatch.context() as m:
                m.setattr(traffic_gen, "may_show", lambda *a, **k: True)
                every = traffic_gen.render(planes, tex, rays, Rb, tb, cam, cull)
            assert np.array_equal(
                traffic_gen.render(planes, tex, rays, Rb, tb, cam, cull), every)
    assert left_out > 0


def test_the_stereo_config_is_its_source_rectified_as_orb_slam3_does():
    """Camera1 and Stereo.b of the stereo configuration are what ORB-SLAM3's
    Settings::precomputeRectificationMaps makes of the source's raw pair:
    P1 of cv::stereoRectify with CALIB_ZERO_DISPARITY and alpha -1, the
    baseline |t(T_c1_c2)|; every other setting is the source's."""
    cv2 = pytest.importorskip("cv2")
    cfg = core.load_json(BENCH / "configs" / "euroc_stereo.json")
    src, run = cfg["source_settings"], cfg["settings"]

    def cam(i):
        g = lambda k: src[f"Camera{i}.{k}"]
        K = np.array([[g("fx"), 0, g("cx")], [0, g("fy"), g("cy")], [0, 0, 1.0]])
        return K, np.array([[g("k1"), g("k2"), g("p1"), g("p2")]])
    T = np.asarray(src["Stereo.T_c1_c2"], np.float64).reshape(4, 4)
    Ti = np.linalg.inv(T)
    size = (src["Camera.width"], src["Camera.height"])
    (K1, D1), (K2, D2) = cam(1), cam(2)
    P1 = cv2.stereoRectify(K1, D1, K2, D2, size, Ti[:3, :3].copy(),
                           Ti[:3, 3:].copy(), flags=cv2.CALIB_ZERO_DISPARITY,
                           alpha=-1, newImageSize=size)[2]
    assert [run[f"Camera1.{k}"] for k in ("fx", "fy", "cx", "cy")] == \
        pytest.approx([P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2]], abs=1e-9)
    assert run["Stereo.b"] == pytest.approx(np.linalg.norm(T[:3, 3]), abs=1e-12)
    assert all(run[f"Camera1.{k}"] == 0.0 for k in ("k1", "k2", "p1", "p2"))
    changed = {k for k in src if run.get(k) != src[k]}
    assert changed == {k for k in src if k.startswith(("Camera1.", "Camera2."))
                       } | {"Stereo.T_c1_c2"}
    assert set(run) - set(src) == {"Stereo.b"}


def test_the_camera_is_read_under_either_key_set():
    """The legacy keys (Camera.fx, Camera.bf) and the v1.0 ones
    (Camera1.fx, Stereo.b) give the same camera and baseline; a camera
    with a distortion is refused by the renderer."""
    legacy = dict(sensor="STEREO", settings={
        "Camera.fx": 400.0, "Camera.fy": 401.0, "Camera.cx": 300.0,
        "Camera.cy": 200.0, "Camera.bf": 44.0, "Camera.width": 640,
        "Camera.height": 480})
    v1 = dict(sensor="STEREO", settings={
        "Camera1.fx": 400.0, "Camera1.fy": 401.0, "Camera1.cx": 300.0,
        "Camera1.cy": 200.0, "Stereo.b": 0.11, "Camera.width": 640,
        "Camera.height": 480})
    assert check.ref_camera(legacy) == pytest.approx(check.ref_camera(v1))
    assert check.ref_camera(legacy)["baseline_m"] == pytest.approx(0.11)
    v1["settings"]["Camera1.k1"] = -0.28
    with pytest.raises(core.RunFailed):
        core.render_camera(v1)


def test_a_new_config_traffic_and_metric_are_taken_up_without_an_edit(tmp_path):
    """A later change adds a deployment, a mix and a metric as new files and
    entries: the harness finds all three by name, and no file that was
    there changes."""
    shutil.copytree(BENCH, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "slam_bench").rglob("*")
              if p.is_file()}
    cfg = json.loads((BENCH / "configs" / "euroc_stereo.json").read_text())
    cfg["settings"]["ORBextractor.nFeatures"] = 2000
    (tmp_path / "slam_bench" / "configs" / "euroc_stereo_2000.json").write_text(
        json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / "explore.json").read_text())
    tr["path"]["speed_m_per_frame"] = 0.044
    (tmp_path / "slam_bench" / "traffic" / "explore_fast.json").write_text(
        json.dumps(tr))
    (tmp_path / "slam_bench" / "metrics" / "frames_in_window.py").write_text(
        "def read(run):\n    return float(run['n_frames'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][-1], name="euroc_stereo_2000",
                                 file="slam_bench/configs/euroc_stereo_2000.json"))
    bench["workloads"].append(dict(name="euroc_stereo_2000.explore_fast",
                                   config="euroc_stereo_2000",
                                   traffic="explore_fast", chips=1, why="test"))
    bench["per_layer"].append(dict(name="frames_in_window", unit="frames",
                                   better="higher", source="host_clock",
                                   layer="System", moves="frames_per_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = core.load_cell("euroc_stereo_2000.explore_fast", root=tmp_path)
    assert spec["config"]["settings"]["ORBextractor.nFeatures"] == 2000
    assert spec["traffic"]["path"]["speed_m_per_frame"] == 0.044
    assert "frames_in_window" in [m["name"] for m in spec["per_layer"]]
    assert core.metric_reader("frames_in_window", root=tmp_path)(
        dict(n_frames=7)) == 7.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


# -- arithmetic on made-up inputs --------------------------------------------

def test_rate_is_all_frames_over_the_whole_window():
    res = dict(n_frames=50, window_s=20.5, setup_s=31.0)
    e2e = core.end_to_end(res)
    assert e2e["frames_per_s"] == (50 / 20.5, "frames/s")
    assert e2e["setup_s"] == (31.0, "s")


def test_p90_is_over_all_frames_before_the_slice():
    t = [0.3] * 80 + [1.0] * 20
    read = core.metric_reader("frame_ms_p90")
    assert read(dict(frame_s_before_slice=t)) == pytest.approx(
        np.percentile(np.array(t) * 1e3, 90))
    assert read(dict(frame_s_before_slice=t[:4])) is None


def test_idle_share_is_one_minus_the_union_of_intervals():
    # overlapping and nested intervals count once: busy [0, 4) and [6, 7)
    ev = [("a", 0, 3), ("b", 1, 3), ("c", 2, 1), ("d", 6, 1)]
    busy, gaps = profiling.busy_union(ev)
    assert busy == 5 and gaps == [(4, 6)]
    read = core.metric_reader("device_idle_share")
    assert read(dict(slice=dict(busy_s=5e-9, window_s=10e-9))) == \
        pytest.approx(0.5)


def test_span_metrics_average_over_frames_and_events():
    spans = {"pose prediction": [0.2, 0.3], "track local map": [0.1],
             "KF insertion": [0.01, 0.03], "local BA": [0.1, 0.2],
             "PR detection": [0.004, 0.006, 0.1]}
    run = dict(spans=spans, span_frames=4)
    assert core.metric_reader("track_ms")(run) == pytest.approx(150.0)
    assert core.metric_reader("kf_event_ms")(run) == pytest.approx(170.0)
    assert core.metric_reader("pr_detect_ms")(run) == pytest.approx(6.0)
    assert core.metric_reader("kf_event_ms")(dict(spans={}, span_frames=4)) is None


# -- the kernels' least work at the cells' shapes ----------------------------

def test_roofline_counts_at_the_cells_shapes():
    # 752x480, 8 levels at 1.2: 1,132,928 level pixels (20 bytes and 375
    # operations each); phase 3 of chip_smoke.py read 0.00676 and 0.00115 ms
    t, by = profiling.frontend_bound(480, 752, 8, 1.2)
    assert by == "bytes" and t == pytest.approx(1_132_928 * 20 / 3.35e12)
    assert t * 1e3 == pytest.approx(0.00676, abs=5e-6)
    t, by = profiling.cell_topk_bound(480, 752, 8, 1.2)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.00115, abs=5e-6)
    t, by = profiling.gather_patches_bound(1280)
    assert t == pytest.approx(1280 * (12 + 37 * 37 * 4) / 3.35e12)
    rates = dict(int32_ops_per_s=132 * 1.98e9 * 64, popc_per_s=132 * 1.98e9 * 16)
    t, by = profiling.windowed_bound(4096, 1280, rates)
    assert by == "operations"
    assert t == pytest.approx(8 * 4096 * 1280 / rates["int32_ops_per_s"])


def test_roofline_reader_gives_nothing_without_launches():
    read = core.metric_reader("dense_frontend_roofline")
    assert read(dict(slice=dict(kernels={}))) is None
    k = dict(dense_frontend=dict(seconds=2e-4, launches=4, bound_s=4e-5))
    assert read(dict(slice=dict(kernels=k))) == pytest.approx(20.0)


# -- the import rule ---------------------------------------------------------

def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax": 0, "jax.numpy": 0, "jaxlib": 0, "flax.linen": 0,
            "orb_slam3_detailed_comments_tpu": 0,
            "orb_slam3_detailed_comments_tpu.ops": 0,
            "orb_slam3_detailed_comments_tpu_torch": 0,
            "orb_slam3_detailed_comments_tpu_torch.ops": 0,
            "jaxtyping": 0, "numpy": 0}
    assert core.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib", "flax.linen",
         "orb_slam3_detailed_comments_tpu",
         "orb_slam3_detailed_comments_tpu.ops"])


def _imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_harness_and_reference_import_no_jax():
    for path in BENCH.rglob("*.py"):
        names = _imported_top_names(path)
        assert not names & set(core.FORBIDDEN), (path, names)
    # the reference imports nothing of the program either
    for path in (BENCH / "reference").rglob("*.py"):
        assert core.PORT not in _imported_top_names(path), path


# -- rehearsals of whole runs on the CPU --------------------------------------

@pytest.mark.parametrize("window_end", ["seconds", "feed"])
def test_cpu_rehearsal_of_a_stereo_cell_is_correct(capsys, window_end):
    """A window that the clock closes, and one that a feed shorter than
    --seconds closes at its last frame: both correct, the rate every
    window frame over the window's whole length."""
    out, diag = rehearse(capsys, window_end)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(check.LIMITS)
    assert out["checks"]["sample_short"]["value"] == 0
    assert out["attempted"] >= 1
    assert out["metrics"]["frames_per_s"]["value"] == \
        out["attempted"] / diag["window_s"]


@pytest.mark.parametrize("window_end", ["seconds", "feed"])
def test_cpu_rehearsal_of_a_traced_run_reads_the_layers(capsys, window_end):
    """The slice starts inside the window however it ends: in a window
    that the feed ends, at after_share of the feed's window frames."""
    out, diag = rehearse(capsys, window_end, traced=True)
    for name in ("frontend_ms", "track_ms", "device_idle_share",
                 "launches_per_frame"):
        assert name in out["metrics"], name
    assert out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"]
    if window_end == "feed":
        assert diag["traced_frames_before_slice"] == math.ceil(
            0.5 * (FEED_FRAMES - 3))


def test_a_window_the_feed_ends_under_the_floor_fails():
    """A feed that ends before the window's floor gives no result, and the
    message names the most the traffic can measure: its window frames
    over the floor."""
    spec = tiny_spec(frames=8)
    spec["traffic"]["window"]["min_s"] = 3600.0
    with pytest.raises(core.RunFailed,
                       match=f"at most {5 / 3600:.4g} frames/s"):
        run_tiny(spec)


def _break(monkeypatch, fault: str):
    from orb_slam3_detailed_comments_tpu_torch.optim import ba, pose_opt
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
    if fault == "pose_unchanged":
        orig = pose_opt.pose_optimization

        def f(T0, X, uv, w, valid, cam, *a, **kw):
            r = orig(T0, X, uv, w, valid, cam, *a, **kw)
            return r._replace(T_cw=T0)
        monkeypatch.setattr(pose_opt, "pose_optimization", f)
    elif fault == "pose_half_the_observations":
        orig = pose_opt.pose_optimization

        def f(T0, X, uv, w, valid, cam, *a, **kw):
            half = valid.clone()
            half[1::2] = False
            return orig(T0, X, uv, w, half, cam, *a, **kw)
        monkeypatch.setattr(pose_opt, "pose_optimization", f)
    elif fault == "pose_altered":
        orig = pose_opt.pose_optimization

        def f(*a, **kw):
            r = orig(*a, **kw)
            return r._replace(T_cw=r.T_cw._replace(t=r.T_cw.t + 2e-3))
        monkeypatch.setattr(pose_opt, "pose_optimization", f)
    elif fault == "pose_one_place_altered":
        # every second solve, i.e. one of a steady frame's two places
        orig = pose_opt.pose_optimization
        calls = [0]

        def f(*a, **kw):
            r = orig(*a, **kw)
            calls[0] += 1
            if calls[0] % 2:
                return r
            return r._replace(T_cw=r.T_cw._replace(t=r.T_cw.t + 2e-3))
        monkeypatch.setattr(pose_opt, "pose_optimization", f)
    elif fault == "pose_all_outliers":
        orig = pose_opt.pose_optimization

        def f(*a, **kw):
            r = orig(*a, **kw)
            return r._replace(inlier=torch.zeros_like(r.inlier))
        monkeypatch.setattr(pose_opt, "pose_optimization", f)
    elif fault == "solves_unseen":
        # a later program that fuses or renames the solves: the capture
        # no longer sees them
        class Blind(core.Capture):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                for mod, name, orig in self._saved:
                    if name in ("pose_optimization", "ba_solve"):
                        setattr(mod, name, orig)
        monkeypatch.setattr(core, "Capture", Blind)
    elif fault == "keypoint_altered":
        orig = kernels.prepare_frame_stereo

        def f(*a, **kw):
            prep, depth, ur = orig(*a, **kw)
            xy = prep.feat.xy.clone()
            xy[0, 0] += 1.0
            return (prep._replace(feat=prep.feat._replace(xy=xy)), depth, ur)
        monkeypatch.setattr(kernels, "prepare_frame_stereo", f)
    elif fault == "ba_unchanged":
        orig = ba.ba_solve

        def f(prob, *a, **kw):
            r = orig(prob, *a, **kw)
            return r._replace(kf_R=prob.kf_R, kf_t=prob.kf_t,
                              points=prob.points)
        monkeypatch.setattr(ba, "ba_solve", f)


@pytest.mark.parametrize("fault", ["pose_unchanged",
                                   "pose_half_the_observations",
                                   "pose_altered", "pose_one_place_altered",
                                   "pose_all_outliers", "solves_unseen",
                                   "keypoint_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """In a window that the feed closes (the same frames on any host)."""
    _break(monkeypatch, fault)
    out = run_tiny(tiny_spec(frames=FEED_FRAMES))
    assert not out["correct"], out["checks"]


def test_a_bundle_adjustment_left_undone_is_not_correct(monkeypatch):
    """Keyframe events run the local BA in the window; one that returns
    its problem's state fails ba_gap_px."""
    _break(monkeypatch, "ba_unchanged")
    out = run_tiny(tiny_spec(frames=FEED_FRAMES))
    assert out["checks"]["ba_gap_px"]["value"] is not None
    assert not out["correct"], out["checks"]


def test_the_front_end_control_in_bfloat16_is_not_correct():
    """The control's front end (the reference's maps rounded to bfloat16)
    against the reference: keypoints apart and descriptor bits, far above
    the limits (the solves' TF32 control needs the card)."""
    spec = tiny_spec()
    from slam_bench import traffic_gen
    from slam_bench.reference import orb
    rcfg = dict(camera=core.render_camera(spec["config"]), sensor="STEREO",
                baseline_m=spec["config"]["settings"]["Stereo.b"])
    tr = traffic_gen.Traffic(dict(spec["traffic"], frames=2), rcfg, 99,
                             torch.device("cpu"))
    img = torch.from_numpy(tr.frames[1].astype(np.float32))
    oa = check.orb_args(spec["config"])
    got = check.compare_features(orb.extract(img, **oa, lower=torch.bfloat16),
                                 orb.extract(img, **oa))
    assert got["kp_apart"] > 3 * max(check.LIMITS["kp_apart"], 1e-3)
    assert got["desc_bits"] > 3 * check.LIMITS["desc_bits"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_control_fails_every_number_on_the_card(card):
    """The control at the stereo cell's own size on the card (a window
    long enough for a bundle adjustment): the program's run is correct,
    and every number of the control that compares a precision reads
    above its limit."""
    from orb_slam3_detailed_comments_tpu_torch import host_native, native
    native.lib()
    host_native.lib()
    spec = core.load_cell("euroc_stereo.explore")
    spec["traffic"] = dict(spec["traffic"],
                           check=dict(spec["traffic"]["check"], ba_events=1))
    out = core.execute(spec, 5_000_000_001, 25.0, False, card, time.time(),
                       control=True)
    assert out["correct"], out["checks"]
    for k, v in out["control"].items():
        if k in check.LIMITS and k != "sample_short":
            assert v > check.LIMITS[k], (k, v)
