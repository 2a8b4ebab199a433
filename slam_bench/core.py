"""One run of one benchmark cell: set-up, the measured window, the traced
slice, the correctness check and the result line.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``);
each per-layer metric is read by ``metrics/<name>.py``. Nothing here
knows a cell, a configuration or a metric by name.

From the program (the package ``orb_slam3_detailed_comments_tpu_torch``)
the run takes the System under test, its spans (``utils/timing``), its
kernel names and the results of three of its stages, which the
correctness check holds against the plain reference in ``reference/``:
each frame's extraction (``pipeline/kernels.prepare_frame`` or
``prepare_frame_stereo``), each pose solve (``optim/pose_opt.
pose_optimization``) and each bundle adjustment (``optim/ba.ba_solve``).
Capturing a stage keeps references to its inputs and outputs and adds
no device work.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PORT = "orb_slam3_detailed_comments_tpu_torch"
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_detailed_comments_tpu")
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class RunFailed(Exception):
    """A run that cannot give a result: no card, a cell that does not set
    up, traffic that runs dry in set-up or before the window's floor.
    Exits non-zero with no result line."""


def process_start() -> float:
    """This process's start on the wall clock (``time.time``), from
    /proc: its start tick and the system's uptime (10 ms resolution)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])               # field 22, starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - max(age, 0.0)


def host_rss_bytes() -> int:
    """This process's resident set on the host now (VmRSS, /proc)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and per-layer metric
    entries, found by the names that BENCHMARK.json gives."""
    bench_path = root / "BENCHMARK.json"
    if not bench_path.is_file():
        raise RunFailed(f"{bench_path} is missing")
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunFailed(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "slam_bench" / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name])]
    return dict(cell=cell, config=cfg, traffic=traffic, end_to_end=e2e,
                per_layer=layer)


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of metrics/<name>.py."""
    path = root / "slam_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def render_camera(cfg: dict) -> dict:
    """The camera the traffic is rendered through: camera 1 of the
    settings, an ideal pinhole (the generator renders no distortion)."""
    from .check import ref_camera
    s = cfg["settings"]
    cam = ref_camera(cfg)
    if any(cam[k] for k in ("k1", "k2", "p1", "p2")):
        raise RunFailed("the traffic renders undistorted frames only; the "
                        "configuration's camera 1 has a distortion")
    cam["width"], cam["height"] = int(s["Camera.width"]), int(s["Camera.height"])
    return cam


def settings_yaml(settings: dict) -> str:
    """OpenCV-YAML text of a settings dict (numbers, strings)."""
    lines = ["%YAML:1.0", "---"]
    for k, v in settings.items():
        lines.append(f"{k}: " + (f'"{v}"' if isinstance(v, str) else repr(v)))
    return "\n".join(lines) + "\n"


def build_system(cfg: dict, dev):
    """The System as the dataset entry points build it: the settings file
    through ``utils.config.load_settings`` and ``System.from_settings``."""
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import MapConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system as S
    from orb_slam3_detailed_comments_tpu_torch.utils import config as C
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "settings.yaml"
        path.write_text(settings_yaml(cfg["settings"]))
        s = C.load_settings(str(path))
    cap = cfg["map_capacity"]
    mcfg = MapConfig(max_kf=int(cap["max_kf"]), max_pt=int(cap["max_pt"]),
                     n_feat=int(math.ceil(s.n_features / 128.0)) * 128,
                     n_levels=s.n_levels, scale=s.scale_factor)
    sensor = {"MONOCULAR": S.MONOCULAR, "STEREO": S.STEREO}[cfg["sensor"]]
    return S.System.from_settings(s, sensor, map_cfg=mcfg, device=dev)


def card_info(index: int = 0) -> dict:
    import torch
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(index),
               count=1)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        lim, clk = (x.strip() for x in smi.stdout.strip().split(","))
        out["power_limit_w"] = float(lim)
        out["sm_clock_max_mhz"] = float(clk)
    except (OSError, ValueError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


class Capture:
    """Wraps the program's stages for the run: in every run keeps each
    extraction's, pose solve's and bundle adjustment's inputs and outputs
    (tagged with the frame being tracked); in a traced run also records
    every span with its host interval and, inside the profiled slice
    only, times each extraction between two synchronizes and keeps the
    windowed search's shapes. ``restore`` undoes it."""

    def __init__(self, stereo: bool, traced: bool, sync):
        from orb_slam3_detailed_comments_tpu_torch.ops import hamming
        from orb_slam3_detailed_comments_tpu_torch.optim import ba, pose_opt
        from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
        from orb_slam3_detailed_comments_tpu_torch.utils import timing
        self.frame = 0           # the feed index of the frame being tracked
        self.fed = 0             # extractions so far (= feed index + 1)
        self.window = False      # inside the measured window
        self.preps: dict = {}    # feed index -> extraction result
        self.pose_calls: list = []   # (frame, args, kwargs, result)
        self.ba_calls: list = []     # (frame, args, kwargs, result)
        self.frontend_s: list = []
        self.spans: list = []        # (name, t0, t1) perf_counter seconds
        self.windowed: list = []     # (Q, K) of each windowed search
        self.in_slice = False        # inside the profiled slice
        self._saved = []

        def patch(mod, name, make):
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, make(orig))

        ext = "prepare_frame_stereo" if stereo else "prepare_frame"

        def wrap_extract(orig):
            def run(*a, **kw):
                if self.in_slice:
                    sync()
                    t0 = time.perf_counter()
                    out = orig(*a, **kw)
                    sync()
                    self.frontend_s.append(time.perf_counter() - t0)
                else:
                    out = orig(*a, **kw)
                self.preps[self.fed] = out
                self.fed += 1
                return out
            return run

        def wrap_keep(store):
            def make(orig):
                def run(*a, **kw):
                    out = orig(*a, **kw)
                    store.append((self.frame, a, kw, out))
                    return out
                return run
            return make

        patch(kernels, ext, wrap_extract)
        patch(pose_opt, "pose_optimization", wrap_keep(self.pose_calls))
        patch(ba, "ba_solve", wrap_keep(self.ba_calls))
        if traced:
            def wrap_span(orig):
                from contextlib import contextmanager

                @contextmanager
                def span(stage):
                    t0 = time.perf_counter()
                    with orig(stage):
                        yield
                    if self.window:
                        self.spans.append((stage, t0, time.perf_counter()))
                return span

            def wrap_windowed(orig):
                def run(*a, **kw):
                    if self.in_slice:
                        self.windowed.append((int(a[0].shape[0]),
                                              int(a[7].shape[0])))
                    return orig(*a, **kw)
                return run
            patch(timing, "span", wrap_span)
            patch(hamming, "hamming_best2_windowed", wrap_windowed)

    def restore(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()


def slice_record(prof, t_a: float, t_b: float, n_frames: int,
                 spans: list, windowed: list, cfg: dict, rates: dict,
                 dev) -> dict:
    """What the profiled slice says: busy and window seconds, device
    operations by name, launches a frame, each hand-written kernel's time,
    launches and least time, and the idle time by the host's stage."""
    from . import profiling as P
    ev = P.device_events(prof, dev.type)
    if not ev:
        return None
    busy_ns, gaps = P.busy_union(ev)
    by_name: dict = {}
    for name, _, d in ev:
        s = by_name.setdefault(name, [0, 0])
        s[0] += d
        s[1] += 1
    n_kernels = sum(1 for name, _, _ in ev
                    if not name.lower().startswith(("memcpy", "memset")))
    # the device clock laid onto the host's: the slice's first operation
    # starts when the host starts the slice (after a synchronize)
    t0_ns = ev[0][1]
    spans = [s for s in spans if s[2] >= t_a and s[1] <= t_b]
    idle: dict = {}
    for g0, g1 in gaps:
        mid = t_a + ((g0 + g1) / 2 - t0_ns) * 1e-9
        inner = "outside the port's spans"
        best = None
        for name, s0, s1 in spans:
            if s0 <= mid <= s1 and (best is None or s1 - s0 < best):
                inner, best = name, s1 - s0
        idle[inner] = idle.get(inner, 0.0) + (g1 - g0) * 1e-9
    s = cfg["settings"]
    h, w = int(s["Camera.height"]), int(s["Camera.width"])
    L, sc = int(s["ORBextractor.nLevels"]), float(s["ORBextractor.scaleFactor"])
    n_feat = int(math.ceil(int(s["ORBextractor.nFeatures"]) / 128.0)) * 128
    per_call = {"dense_frontend": P.frontend_bound(h, w, L, sc)[0],
                "cell_topk": P.cell_topk_bound(h, w, L, sc)[0],
                "gather_patches": P.gather_patches_bound(n_feat)[0]}
    kernels = {}
    for k, sym in P.KERNEL_SYMBOLS.items():
        t = sum(v[0] for n, v in by_name.items() if sym in n) * 1e-9
        c = sum(v[1] for n, v in by_name.items() if sym in n)
        if c == 0:
            continue
        if k in per_call:
            bound = per_call[k] * c
        elif (k == "hamming_best2_windowed" and len(windowed) == c
              and rates is not None):
            bound = sum(P.windowed_bound(q, kk, rates)[0] for q, kk in windowed)
        else:
            bound = None
        kernels[k] = dict(seconds=t, launches=c, bound_s=bound)
    window_s = t_b - t_a
    return dict(
        window_s=window_s, busy_s=busy_ns * 1e-9, n_frames=n_frames,
        launches=n_kernels,
        device_ops=sorted(([n[:120], v[0] * 1e-9] for n, v in by_name.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda x: -x[1])[:10],
        kernels=kernels)


def run(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = measure(args, t_start)
    except RunFailed as e:
        print(f"slam_bench: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print("slam_bench: the run loaded " + ", ".join(found),
              file=sys.stderr, flush=True)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def measure(args, t_start: float) -> dict:
    """The run on the card: refuses to run without one."""
    spec = load_cell(args.workload)
    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / "build" / "slam_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch
    if not torch.cuda.is_available():
        raise RunFailed("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(spec["cell"]["chips"]):
        raise RunFailed(f"the cell needs {spec['cell']['chips']} cards, "
                        f"{torch.cuda.device_count()} found")
    torch.set_num_threads(2)
    dev = torch.device("cuda:0")
    from orb_slam3_detailed_comments_tpu_torch import host_native, native
    native.lib()           # nvcc only where build/torch_kernels is stale
    host_native.lib()
    out = execute(spec, args.seed, args.seconds, bool(args.trace), dev,
                  t_start)
    out["device"].update(card_info())
    return out


def end_to_end(res: dict) -> dict:
    """{metric: (value, unit)}: every frame the System returned over the
    window's whole length, and the set-up."""
    return dict(frames_per_s=(res["n_frames"] / res["window_s"], "frames/s"),
                setup_s=(res["setup_s"], "s"))


def synchronizer(dev):
    import torch
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def execute(spec: dict, seed: int, seconds: float, traced: bool, dev,
            t_start: float, control: bool = False) -> dict:
    """Traffic, set-up, window, check and the result's fields, on dev (the
    card; the CPU only in the folder's own rehearsal test)."""
    import torch
    from . import check as check_mod
    from . import traffic_gen
    cfg, traffic = spec["config"], spec["traffic"]
    stereo = cfg["sensor"] == "STEREO"
    camera = render_camera(cfg)
    rcfg = dict(camera=camera, sensor=cfg["sensor"],
                baseline_m=camera["baseline_m"])
    tr = traffic_gen.Traffic(traffic, rcfg, seed, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    slam = build_system(cfg, dev)
    cap = Capture(stereo, traced, synchronizer(dev))
    try:
        res = drive(slam, tr, cap, traffic, seconds, traced, stereo, cfg, dev)
    finally:
        cap.restore()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    res["setup_s"] = res["t_setup_end"] - t_start
    ate, scale = check_mod.trajectory_error(res, tr, not stereo)
    diag = dict(setup_frames=res["n_setup"], window_frames=res["n_frames"],
                lost=res["n_lost"], keyframes_setup=res["n_kf_setup"],
                keyframes_end=res["n_kf_end"], points=int(slam.map.n_points),
                window_bas=len(cap.ba_calls) - res["ba_first"],
                window_s=res["window_s"], window_end=res["window_end"],
                traffic_texture_s=tr.texture_s, traffic_render_s=tr.render_s,
                host_rss_after_setup_bytes=res["rss_setup"],
                traced_frames_before_slice=len(res.get("frame_s_before_slice", [])),
                traced_kf_events=res.get("kf_events"),
                trajectory_rms_m=ate, trajectory_scale=scale)
    # the program's state goes before the reference runs
    del slam
    if cuda:
        torch.cuda.empty_cache()
    got = check_mod.run_checks(cap, tr, res, cfg, traffic, seed, diag=diag)
    ctrl = None
    if control:
        ctrl_diag = {}
        ctrl = check_mod.run_checks(cap, tr, res, cfg, traffic, seed,
                                    control=True, diag=ctrl_diag)
        ctrl.update(ctrl_diag)
    checks = check_mod.judged(got, cfg)
    print("diagnostics " + json.dumps(diag), file=sys.stderr, flush=True)
    device = dict(memory_peak_bytes=peak)
    out = dict(correct=check_mod.correct(checks),
               attempted=res["n_frames"], failed=res["n_lost"])
    metrics = {}
    if not traced:
        e2e = end_to_end(res)
        for m in spec["end_to_end"]:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = dict(value=v, unit=unit)
    else:
        sl = res["slice"]
        if sl is None:
            raise RunFailed("the profiler saw no device operation in the "
                            "traced slice")
        device["busy_s"] = sl["busy_s"]
        device["window_s"] = sl["window_s"]
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(res)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        out["breakdown"] = dict(device_ops=sl["device_ops"],
                                idle_gaps=sl["idle_gaps"])
    out["metrics"] = metrics
    out["device"] = device
    if ctrl is not None:
        out["control"] = ctrl
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    return out


def drive(slam, tr, cap, traffic: dict, seconds: float, traced: bool,
          stereo: bool, cfg: dict, dev) -> dict:
    """Set-up through the System until the traffic's set-up condition
    holds, then the closed-loop window: every frame as soon as the System
    has returned the last one, for ``seconds`` of the host clock or until
    the feed ends, whichever comes first. A window that the feed ends
    before the traffic's ``window.min_s`` fails."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.pipeline.tracking import OK
    from . import profiling as P
    sync = synchronizer(dev)
    activity = (torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU)
    it = (slam.track_stereo_iter if stereo else slam.track_monocular_iter)(
        tr.items(stereo))
    su = traffic["setup"]
    n = 0
    for _ in it:
        n += 1
        cap.frame = n
        if n >= int(su["frames"]):
            break
    else:
        raise RunFailed("the traffic ran out in set-up")
    if slam.map.n_kf < int(su["min_keyframes"]) or slam.tracker.state != OK:
        raise RunFailed(f"set-up: {slam.map.n_kf} keyframes and tracker state "
                        f"{slam.tracker.state} after {n} frames; "
                        f"{su['min_keyframes']} keyframes and tracking wanted")
    sync()
    t_setup_end = time.time()
    rss_setup = host_rss_bytes()
    n_setup = n
    # the frames the feed holds for the window, and the shortest window
    # that a feed ending early may give
    feed_frames = len(tr.frames) - n_setup
    min_s = float(traffic["window"]["min_s"])
    n_kf0 = int(slam.map.n_kf)
    from orb_slam3_detailed_comments_tpu_torch.utils import timing
    timing.reset()
    pf = traffic["profile"]
    after = float(pf["after_share"])
    rates = P.int_rates() if traced and dev.type == "cuda" else None
    prof = None
    slice_at = None
    slice_out = None
    times = []
    poses = []
    lost = 0
    cap.window = True
    t0 = time.perf_counter()
    t_prev = t0
    n_win = 0
    ba_before = len(cap.ba_calls)
    for pose in it:
        t = time.perf_counter()
        times.append(t - t_prev)
        t_prev = t
        n_win += 1
        cap.frame = n_setup + n_win
        lost += pose is None
        poses.append(pose)
        if traced:
            # the slice starts late in the window: the profiler slows every
            # frame after it starts, also once it has stopped, so the layers
            # are read from the frames before it. It starts at after_share
            # of the window's clock or of the feed's window frames,
            # whichever comes first, so inside a window that the feed ends
            if prof is None and slice_out is None and (
                    t - t0 >= after * seconds or n_win >= after * feed_frames):
                sync()
                cap.windowed.clear()
                cap.in_slice = True
                ev0 = sum(1 for s in cap.spans if s[0] == "KF insertion")
                prof = P.profiled_session([activity])
                slice_at = (n_win, time.perf_counter())
            elif prof is not None:
                k = n_win - slice_at[0]
                evs = sum(1 for s in cap.spans if s[0] == "KF insertion") - ev0
                if (k >= int(pf["max_frames"]) or (
                        k >= int(pf["min_frames"])
                        and evs >= int(pf["min_kf_events"]))):
                    sync()
                    t_b = time.perf_counter()
                    prof.stop()
                    cap.in_slice = False
                    slice_out = (prof, slice_at, (n_win, t_b))
                    prof = None
        if t - t0 >= seconds:
            window_end = "seconds"
            break
    else:
        # the feed ended first: the window closes at its last frame
        window_end = "feed"
        if n_win == 0 or t_prev - t0 < min_s:
            raise RunFailed(
                f"the feed ended after {n_win} window frames in "
                f"{t_prev - t0:.1f} s, under the window's floor of "
                f"{min_s:g} s: the traffic measures at most "
                f"{feed_frames / min_s:.4g} frames/s ({feed_frames} window "
                f"frames over {min_s:g} s)")
    window_s = t_prev - t0
    cap.window = False
    it.close()
    if prof is not None:
        # the window closed inside the slice: the slice ends with it
        sync()
        prof.stop()
        cap.in_slice = False
        if n_win - slice_at[0] < int(pf["min_frames"]):
            raise RunFailed("the window closed before the profiled slice "
                            "held its frames")
        slice_out = (prof, slice_at, (n_win, time.perf_counter()))
    sync()
    res = dict(t_setup_end=t_setup_end, n_setup=n_setup, n_frames=n_win,
               n_lost=lost, window_s=window_s, window_end=window_end,
               rss_setup=rss_setup, frame_s=times,
               n_kf_setup=n_kf0, n_kf_end=int(slam.map.n_kf),
               ba_first=ba_before, poses=poses,
               spans={k: timing.samples(k) for k in timing.stats()},
               span_frames=n_win,
               frontend_s=list(cap.frontend_s), slice=None)
    if traced:
        if slice_out is None:
            raise RunFailed("the window closed before the profiled slice")
        prof, (a, t_a), (b, t_b) = slice_out
        res["slice_frames"] = (a, b)
        res["frame_s_before_slice"] = times[:a]
        res["spans"] = {}
        for name, s0, s1 in cap.spans:
            if s1 <= t_a:
                res["spans"].setdefault(name, []).append(s1 - s0)
        res["span_frames"] = a
        res["kf_events"] = len(res["spans"].get("KF insertion", ()))
        res["slice"] = slice_record(prof, t_a, t_b, b - a, cap.spans,
                                    cap.windowed, cfg, rates, dev)
    return res

