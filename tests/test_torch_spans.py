"""The port's spans (``utils/timing``) on the CPU, at the small size of
``test_torch_system_facade.py`` (376x240, 512 features).

A stereo System over 8 rendered pairs through ``track_stereo_iter``, run
once under the benchmark's own span capture (``slam_bench.core.Capture``,
traced) with a recorder of the span tree and a recorder in place of
``torch.cuda.nvtx``: each steady frame opens one "Track total" holding one
"pose prediction" with its two "projection search" and "pose GN", one
"local keyframes", one "track inputs" and the packed fetch's "host sync";
children never outlast their parent; one "ORB extraction" a frame, on the
monocular iterator too, under that frame's id; the capture sees every
span; the NVTX ranges pair up and nest under ``frame <id>``. And the
frame and span rules alone, and the five per-layer metrics that read the
spans, on hand-built runs.
"""
import contextlib

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import system
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render, timing
from slam_bench import core

torch.set_num_threads(2)

CAM = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376,
                      height=240)
N_FEAT, N_PAIRS, N_MONO = 512, 8, 3
NEW_SPANS = ("Track total", "track inputs", "projection search", "pose GN",
             "local keyframes", "New KF decision", "ORB extraction",
             "Stereo matching", "host sync")


class Nvtx:
    """Stands in for ``torch.cuda.nvtx``: records pushes and pops."""

    def __init__(self):
        self.events = []

    def range_push(self, name):
        self.events.append(name)

    def range_pop(self):
        self.events.append(None)


class Tree:
    """Every span opened while installed, as [stage, parent index, frame,
    seconds]; the seconds are the registry's own, taken in closing order."""

    def __init__(self):
        self.nodes = []
        self._open = []
        self._closed = []

    def wrap(self, orig):
        @contextlib.contextmanager
        def span(stage):
            i = len(self.nodes)
            self.nodes.append([stage, self._open[-1] if self._open else None,
                               timing.current_frame(), None])
            self._open.append(i)
            try:
                with orig(stage):
                    yield
            finally:
                self._open.pop()
                self._closed.append(i)
        return span

    def take_seconds(self):
        left = {k: list(timing.samples(k)) for k in timing.stats()}
        for i in self._closed:
            self.nodes[i][3] = left[self.nodes[i][0]].pop(0)

    def children(self, i):
        return [j for j, n in enumerate(self.nodes) if n[1] == i]

    def below(self, i):
        out = []
        for j in self.children(i):
            out += [j] + self.below(j)
        return out


@contextlib.contextmanager
def recorded(stereo):
    """Tree and NVTX recorders on the module's spans, under the
    benchmark's traced capture; all restored on exit."""
    cap = core.Capture(stereo, True, lambda: None)
    cap.window = True
    tree, nvtx = Tree(), Nvtx()
    capture_span, nvtx_was = timing.span, timing._NVTX
    timing.span = tree.wrap(capture_span)
    timing._NVTX = nvtx
    timing.reset()
    try:
        yield tree, nvtx, cap
        timing.frame(None)
        tree.take_seconds()
    finally:
        timing.span = capture_span
        cap.restore()
        timing._NVTX = nvtx_was
        timing.frame(None)
        timing.reset()


def _system(sensor, **kw):
    return system.System(
        CAM, sensor, map_cfg=mapstore.MapConfig(max_kf=32, max_pt=4096,
                                                n_feat=N_FEAT),
        orb_cfg=extractor.OrbConfig(n_features=N_FEAT),
        enable_loop_closing=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def stereo_run():
    planes = synth_render.default_world(np.random.default_rng(9))
    R, t = synth_render.orbit_trajectory(40)
    cpu = torch.device("cpu")
    pairs = [(synth_render.render_image(CAM, planes, R[i], t[i], cpu),
              synth_render.render_image(
                  CAM, planes, R[i],
                  synth_render.stereo_right_t(R[i], t[i], 0.11), cpu),
              0.05 * i) for i in range(N_PAIRS)]
    slam = _system(system.STEREO, baseline=0.11)
    with recorded(True) as (tree, nvtx, cap):
        poses = list(slam.track_stereo_iter(iter(pairs)))
    return dict(tree=tree, nvtx=nvtx, cap=cap, poses=poses, slam=slam)


@pytest.fixture(scope="module")
def mono_run():
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(60)
    frames = [(synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0],
               0.05 * i) for i in range(N_MONO)]
    slam = _system(system.MONOCULAR)
    with recorded(False) as (tree, nvtx, cap):
        list(slam.track_monocular_iter(iter(frames)))
    return dict(tree=tree, nvtx=nvtx)


def test_each_steady_frame_holds_the_step_tree(stereo_run):
    tree = stereo_run["tree"]
    assert all(p is not None for p in stereo_run["poses"])
    tops = [i for i, n in enumerate(tree.nodes) if n[0] == "Track total"]
    assert [tree.nodes[i][2] for i in tops] == list(range(N_PAIRS))
    assert all(tree.nodes[i][1] is None for i in tops)
    # frame 0 initialises the map, frame 1 (no velocity yet) tracks the
    # reference keyframe: the steady step runs from frame 2
    for i in tops[2:]:
        pred = [j for j in tree.children(i)
                if tree.nodes[j][0] == "pose prediction"]
        assert len(pred) == 1
        names = [tree.nodes[j][0] for j in tree.below(pred[0])]
        for stage, n in (("projection search", 2), ("pose GN", 2),
                         ("local keyframes", 1), ("track inputs", 1)):
            assert names.count(stage) == n, (stage, names)
        # the packed fetch sits right under the prediction, the packed
        # upload under its inputs
        direct = [tree.nodes[j][0] for j in tree.children(pred[0])]
        assert "host sync" in direct
        inputs = [j for j in tree.children(pred[0])
                  if tree.nodes[j][0] == "track inputs"]
        assert "host sync" in [tree.nodes[j][0]
                               for j in tree.below(inputs[0])]
    assert len(stereo_run["slam"].tracker.trajectory) == N_PAIRS


def test_children_do_not_outlast_their_parent(stereo_run):
    tree = stereo_run["tree"]
    for i, (stage, _, _, seconds) in enumerate(tree.nodes):
        inner = sum(tree.nodes[j][3] for j in tree.children(i))
        assert inner <= seconds + 1e-9, (stage, inner, seconds)
    total = {k: sum(n[3] for n in tree.nodes if n[0] == k)
             for k in ("pose GN", "projection search", "pose prediction",
                       "track local map")}
    assert 0 < total["pose GN"] + total["projection search"] \
        <= total["pose prediction"] + total["track local map"]


@pytest.mark.parametrize("which", ["stereo", "mono"])
def test_one_extraction_a_frame_under_its_frame_id(stereo_run, mono_run,
                                                   which):
    tree = (stereo_run if which == "stereo" else mono_run)["tree"]
    n = N_PAIRS if which == "stereo" else N_MONO
    ext = [nd for nd in tree.nodes if nd[0] == "ORB extraction"]
    assert [nd[2] for nd in ext] == list(range(n))
    assert all(nd[1] is None for nd in ext)
    stereo = [nd for nd in tree.nodes if nd[0] == "Stereo matching"]
    assert len(stereo) == (n if which == "stereo" else 0)
    # each image's upload is a host sync inside the extraction
    i0 = tree.nodes.index(ext[0])
    assert [tree.nodes[j][0] for j in tree.children(i0)].count(
        "host sync") == (2 if which == "stereo" else 1)


def test_the_benchmark_capture_sees_every_span(stereo_run):
    cap = stereo_run["cap"]
    names = {s[0] for s in cap.spans}
    assert set(NEW_SPANS) <= names, set(NEW_SPANS) - names
    assert len(cap.spans) == len(stereo_run["tree"].nodes)
    assert len(cap.preps) == N_PAIRS
    assert len(cap.pose_calls) == 2 * (N_PAIRS - 1)


def test_nvtx_ranges_pair_up_and_nest_under_frames(stereo_run):
    tree, events = stereo_run["tree"], stereo_run["nvtx"].events
    stack, pushed = [], []
    for e in events:
        if e is None:
            assert stack, "a pop without its push"
            stack.pop()
            continue
        if e.startswith("frame "):
            assert not stack, f"{e} opened inside {stack}"
        else:
            assert stack and stack[0].startswith("frame "), e
            pushed.append((e, int(stack[0].split()[1])))
        stack.append(e)
    assert stack == []
    assert pushed == [(n[0], n[2]) for n in tree.nodes]


def test_frame_and_span_rules(monkeypatch):
    nvtx = Nvtx()
    monkeypatch.setattr(timing, "_NVTX", nvtx)
    timing.reset()
    try:
        timing.frame(3)
        timing.frame(3)
        with timing.span("a"):
            timing.frame(4)        # inside a span: the ranges wait
            assert timing.current_frame() == 4
        timing.frame(4)
        timing.frame(5)
        with pytest.raises(ValueError):
            with timing.span("b"):
                raise ValueError
        timing.enable(False)
        timing.frame(6)
        with timing.span("c"):
            pass
        timing.enable(True)
        timing.frame(None)
        assert nvtx.events == ["frame 3", "a", None, None, "frame 4", None,
                               "frame 5", "b", None, None]
        assert [len(timing.samples(k)) for k in "abc"] == [1, 1, 0]
        assert timing.current_frame() is None
    finally:
        timing.enable(True)
        timing.frame(None)
        timing.reset()


def test_a_process_without_cuda_leaves_nvtx_alone(monkeypatch):
    def refuse(*a):
        raise AssertionError("torch.cuda.nvtx touched")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    monkeypatch.setattr(timing, "_NVTX", None)
    try:
        timing.frame(1)
        with timing.span("a"):
            pass
        timing.frame(None)
        assert timing._NVTX is False
    finally:
        timing.reset()


RUN = dict(spans={"pose GN": [0.1, 0.2], "projection search": [0.01, 0.03],
                  "ORB extraction": [0.02, 0.04],
                  "host sync": [0.001, 0.002, 0.003],
                  "pose prediction": [0.2, 0.3]}, span_frames=2)


@pytest.mark.parametrize("name, stage, value", [
    ("pose_gn_ms", "pose GN", 150.0),
    ("projection_search_ms", "projection search", 20.0),
    ("extraction_dispatch_ms", "ORB extraction", 30.0),
    ("host_syncs_per_frame", "host sync", 1.5),
    ("host_sync_ms", "host sync", 3.0)])
def test_metric_reads_its_span(name, stage, value):
    read = core.metric_reader(name)
    assert read(RUN) == pytest.approx(value, rel=1e-12)
    without = dict(RUN, spans={k: v for k, v in RUN["spans"].items()
                               if k != stage})
    assert read(without) is None
    assert read(dict(RUN, span_frames=0)) is None
