"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to run on a missing card unless asked for the CPU, and
its kernel wrappers count only launches on the card.
"""
import subprocess
import sys
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
        " or k.startswith('orb_slam3_detailed_comments_tpu.')]\n"
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
    "optim.pose_graph", "optim.schur_pcg", "pipeline.loop_closing"])
def test_new_modules_import_alone_without_jax(module):
    code = (f"import sys, importlib\n"
            f"importlib.import_module('{PKG}.{module}')\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'orb_slam3_detailed_comments_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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
