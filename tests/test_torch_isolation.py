"""The port stands alone: it imports neither JAX nor the JAX package (nor
PyYAML or OpenCV, which the card's machine lacks; the host surfaces too:
the host library, dataset readers, viewers, ROS layer and dataset entry
points), its entry points refuse
to run on a missing card unless asked for the CPU, and its kernel wrappers
count only launches on the card, exactly also when several threads count.
"""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu_torch import native
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels, tracking

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PKG = "orb_slam3_detailed_comments_tpu_torch"


def test_port_imports_no_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / PKG).rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert len(mods) > 20
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'orb_slam3_detailed_comments_tpu'"
        " or k.startswith('orb_slam3_detailed_comments_tpu.')"
        " or k in ('yaml', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_need_the_card_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = cameras.pinhole(229.0, 228.5, 188.0, 120.0, 376, 240)
    cfg = mapstore.MapConfig(max_kf=4, max_pt=256, n_feat=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapstore.MapStore(cfg)
    m = mapstore.MapStore(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracking.Tracker(cam, m)
    with pytest.raises(ValueError):
        # the map's device and the tracker's must agree
        tracking.Tracker(cam, m, device="meta")
    tk = tracking.Tracker(cam, m, device="cpu")
    assert tk.device.type == "cpu"


def test_launch_counters_stay_zero_on_cpu():
    native.reset_launches()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (240, 376)).astype(np.float32))
    prep = kernels.prepare_frame(img, cameras.pinhole(229.0, 228.5, 188.0,
                                                      120.0, 376, 240),
                                 extractor.OrbConfig(n_features=256), "xla")
    assert prep.feat.desc.shape == (256, 8)
    fused = kernels.prepare_frame(img, cameras.pinhole(229.0, 228.5, 188.0,
                                                       120.0, 376, 240),
                                  extractor.OrbConfig(n_features=256))
    assert fused.feat.desc.shape == (256, 8)
    assert native.launches == {k: 0 for k in native.launches}
    assert set(native.launches) == {"cell_topk", "gather_patches",
                                    "hamming_best2", "hamming_best2_windowed",
                                    "dense_frontend"}


def test_every_kernel_source_is_registered():
    """Each csrc/*.cu is built, and each C entry has its signature."""
    sources = sorted(p.name for p in native.CSRC.glob("*.cu"))
    assert sources == sorted(native.SOURCES)
    entries = set()
    for p in native.CSRC.glob("*.cu"):
        for line in p.read_text().splitlines():
            if line.startswith('extern "C" int '):
                entries.add(line.split()[3].split("(")[0])
    assert entries == set(native._SIGNATURES)


@pytest.mark.parametrize("module", [
    "ops.frontend", "ops.triangulate", "optim.ba", "models.twoview",
    "pipeline.local_mapping", "utils.evaluate_ate", "pipeline.system",
    "mapping.atlas", "utils.timing", "lie.sim3", "placerec.vocab",
    "placerec.keyframe_db", "placerec.pnp", "placerec.sim3_solver",
    "optim.pose_graph", "optim.schur_pcg", "pipeline.loop_closing",
    "imu.preintegration", "imu.factors", "imu.inertial_init", "optim.jac",
    "optim.vi_ba", "pipeline.inertial", "utils.config",
    "utils.serialization", "utils.verbose", "utils.counters",
    "comm", "parallel.batch_extract", "parallel.dist_ba", "tools",
    "tools.eval_vocab", "tools.train_vocab", "tools.profile_stages",
    "tools.make_dataset_configs"])
def test_new_modules_import_alone_without_jax(module):
    code = (f"import sys, importlib\n"
            f"importlib.import_module('{PKG}.{module}')\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'orb_slam3_detailed_comments_tpu' not in sys.modules\n"
            "assert 'yaml' not in sys.modules and 'cv2' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


HOST_SURFACES = [
    "host_native", "host_native.plain", "utils.png", "utils.datasets",
    "utils.clahe", "viz.drawers", "viz.viewer_ar", "viz.webviewer",
    "ros.transport", "ros.nodes", "examples.runner", "examples.mono_euroc",
    "examples.mono_tum", "examples.mono_kitti", "examples.mono_tum_vi",
    "examples.mono_inertial_euroc", "examples.mono_inertial_tum_vi",
    "examples.stereo_euroc", "examples.stereo_kitti",
    "examples.stereo_tum_vi", "examples.stereo_inertial_euroc",
    "examples.stereo_inertial_tum_vi", "examples.rgbd_tum",
    "examples.synthetic_demo", "examples.ros.common",
    "examples.ros.ros_mono", "examples.ros.ros_mono_ar",
    "examples.ros.ros_mono_inertial", "examples.ros.ros_rgbd",
    "examples.ros.ros_stereo", "examples.ros.ros_stereo_inertial"]


@pytest.fixture(scope="module")
def host_surface_imports():
    """Each host-surface module imported on its own in one interpreter:
    before each import every module of the port is dropped from
    sys.modules (torch stays loaded, which is allowed), and what the
    import pulled in is checked. Returns {module: forbidden modules}."""
    code = (
        "import sys, importlib, json\n"
        f"mods = {HOST_SURFACES!r}\n"
        "bad = {}\n"
        "for m in mods:\n"
        f"    for k in [k for k in sys.modules if k.startswith('{PKG}')]:\n"
        "        del sys.modules[k]\n"
        f"    importlib.import_module('{PKG}.' + m)\n"
        "    bad[m] = [k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k == 'orb_slam3_detailed_comments_tpu'"
        " or k.startswith('orb_slam3_detailed_comments_tpu.')"
        " or k in ('yaml', 'cv2')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", HOST_SURFACES)
def test_host_surfaces_import_alone_without_jax(module,
                                                host_surface_imports):
    """The host library, dataset readers, viewers, ROS layer and entry
    points import without jax, the JAX package, cv2 or yaml."""
    assert host_surface_imports[module] == []


def test_vocabulary_path_needs_no_jax_import():
    """The bundled vocabulary is the JAX package's data file, read by path:
    loading it imports neither JAX nor the JAX package."""
    code = (f"import sys\n"
            f"from {PKG}.placerec import vocab\n"
            "v = vocab.load()\n"
            "assert v.n_words == 10 ** 6\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'orb_slam3_detailed_comments_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_resolving_to_the_card_turns_tf32_off(monkeypatch):
    from orb_slam3_detailed_comments_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert device.resolve(None).type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("which", ["launches", "searches"])
def test_counters_are_exact_under_threads(which):
    """8 threads x 10,000 increments of one name each and of one shared
    name: every count exact (the launch counters and place recognition's
    search counters are bumped from the tracker, the mapping worker and
    the global-BA thread)."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    counts = native.launches if which == "launches" else loop_closing.SEARCHES
    names = list(counts)
    saved = dict(counts)
    counts.reset()
    try:
        def work(i):
            for _ in range(10_000):
                counts.bump(names[0])
                counts.bump(names[i % len(names)])

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        want = {n: 0 for n in names}
        want[names[0]] += 80_000
        for i in range(8):
            want[names[i % len(names)]] += 10_000
        assert dict(counts) == want
    finally:
        counts.update(saved)
