"""The port's tools (``torch:tools/``) against the JAX package's scripts.

- The texture domains are bit-equal to ``utils/synth_render``'s and draw
  from the rng in the same order.
- ``eval_vocab.eval_world`` makes the JAX tool's worlds and poses, and the
  tool's block extraction agrees with ``extractor.extract`` of the JAX
  package on the same images, to ``test_torch_extractor``'s bounds.
- ``retrieval_metrics`` equals ``scripts/eval_vocab.retrieval_metrics``
  on the same descriptor sets and an equal vocabulary (top1 equal, the
  margin within 1e-6 relative).
- ``train_vocab``'s train phase gives the JAX tool's centroids and idf
  from one cached descriptor file; each package loads the other's file.
- ``make_dataset_configs`` writes the JAX emitter's key lines.
- The domain-shift gate of ``tests/test_placerec.py`` held on the port
  (slow).
"""
import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.ops import brief as jbrief
from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.placerec import vocab as jvocab
from orb_slam3_detailed_comments_tpu.utils import synth_render as jsr
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import brief, extractor
from orb_slam3_detailed_comments_tpu_torch.placerec import vocab
from orb_slam3_detailed_comments_tpu_torch.tools import (
    eval_vocab, make_dataset_configs, profile_stages, train_vocab)
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHIFTED = ["natural_1f", "lit", "specular"]


def _script(name):
    """scripts/<name>.py of the JAX package, as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_texture_domains_are_the_same():
    assert list(synth_render.TEXTURE_DOMAINS) == list(jsr.TEXTURE_DOMAINS)


@pytest.mark.parametrize("size", [64, 97])
@pytest.mark.parametrize("name", ["blob"] + SHIFTED)
def test_texture_domain_bit_equal(name, size):
    """The same texture bit for bit from the same rng, and the rng left in
    the same state (the draws are the same, in the same order)."""
    r_t, r_j = np.random.default_rng(size), np.random.default_rng(size)
    a = synth_render.TEXTURE_DOMAINS[name](r_t, size)
    b = jsr.TEXTURE_DOMAINS[name](r_j, size)
    assert a.dtype == b.dtype and a.shape == (size, size)
    np.testing.assert_array_equal(a, b)
    assert r_t.integers(1 << 62) == r_j.integers(1 << 62)


@pytest.mark.parametrize("domain", ["default"] + SHIFTED)
def test_eval_world_draws_as_the_jax_tool(domain, monkeypatch):
    """Two worlds of the JAX tool's ``render_eval_set`` (its renderer and
    extractor stubbed out to record what they are given) against
    ``eval_world``: the same planes and textures, bit for bit, and the same
    poses within 1e-6 (the JAX package's ``orbit_trajectory`` takes its
    rotations from a float32 ``so3.exp``, the port's from float64)."""
    js = _script("eval_vocab")
    seen = []

    def record(cam, planes, R_cw, t_cw):
        seen.append((planes, R_cw, t_cw))
        return np.zeros((2, 2), np.float32)

    monkeypatch.setattr(jsr, "render_frame", record)
    stub = lambda im: SimpleNamespace(desc=np.zeros((1, 8), np.uint32),
                                      valid=np.zeros(1, bool))
    fn_j = None if domain == "default" else jsr.TEXTURE_DOMAINS[domain]
    fn_t = (None if domain == "default"
            else synth_render.TEXTURE_DOMAINS[domain])
    js.render_eval_set(None, stub, 2, 8, 50_000, fn_j)
    assert len(seen) == 16
    for w in range(2):
        planes, R, t = eval_vocab.eval_world(50_000 + w, fn_t, 8)
        for i in range(8):
            pj, Rj, tj = seen[8 * w + i]
            np.testing.assert_allclose(R[i], Rj, rtol=0, atol=1e-6)
            np.testing.assert_allclose(t[i], tj, rtol=0, atol=1e-6)
            assert len(planes) == len(pj)
            for a, b in zip(planes, pj):
                for f in ("origin", "e1", "e2", "texture"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f))


@pytest.fixture(scope="module")
def tool_block():
    """The tool's extraction (752x480, 1024 features, as the tool runs) of
    the first two frames of held-out world 50,000 under the gate's 8-frame
    orbit: one block of 2 on the CPU."""
    def first_two(seed):
        planes, R, t = eval_vocab.eval_world(seed, None, 8)
        return planes, R[:2], t[:2]

    cfg = extractor.OrbConfig(n_features=eval_vocab.N_FEATURES)
    blocks = list(eval_vocab.frame_blocks(
        cameras.pinhole(**eval_vocab.CAM_KW), cfg, first_two, [50_000], CPU))
    assert len(blocks) == 1
    return cfg, blocks[0]


@pytest.mark.parametrize("which", [0, 1])
def test_tool_extraction_matches_jax(tool_block, which):
    """``test_torch_extractor.py::test_extract_matches_jax``'s bounds, the
    tool's batched fused extraction against the JAX tool's
    ``extractor.extract`` on the same image."""
    cfg, (imgs, f) = tool_block
    cfg_j = jext.OrbConfig(n_features=eval_vocab.N_FEATURES)
    assert tuple(cfg) == tuple(cfg_j)
    img = imgs[which].numpy()
    f_j = jext.extract(jnp.asarray(img), cfg_j)
    xy, lv, ok = (f.xy[which].numpy(), f.level[which].numpy(),
                  f.valid[which].numpy())
    same = ((xy == np.asarray(f_j.xy)).all(1)
            & (lv == np.asarray(f_j.level)) & (ok == np.asarray(f_j.valid)))
    assert same.mean() >= 0.995, f"{(~same).sum()} of {len(same)} differ"
    assert int(ok.sum()) > 800
    s = same & ok
    ang_t, ang_j = f.angle[which].numpy()[s], np.asarray(f_j.angle)[s]
    dang = np.abs(np.angle(np.exp(1j * (ang_t - ang_j))))
    assert dang.max() < 1e-4
    bins_same = (brief.angle_bin(torch.from_numpy(ang_t)).numpy()
                 == np.asarray(jbrief.angle_bin(jnp.asarray(ang_j))))
    desc_t = f.desc[which].numpy().view(np.uint32)[s]
    desc_j = np.asarray(f_j.desc)[s]
    np.testing.assert_array_equal(desc_t[bins_same], desc_j[bins_same])
    assert bins_same.mean() >= 0.99


def _descriptor_sets(rng, n_worlds=5, frames=6, n=160, base=400):
    """Frames of worlds whose descriptors are noisy views of a sliding
    window of the world's own set: neighbouring frames share the most."""
    descs, valids = [], []
    for _ in range(n_worlds):
        world = rng.integers(0, 1 << 32, (base, 8), dtype=np.uint64)
        for i in range(frames):
            d = world[i * 40:i * 40 + n].astype(np.uint32)
            flip = (rng.random((n, 8, 32)) < 0.02)
            d = d ^ np.packbits(flip, axis=-1, bitorder="little").view(
                np.uint32).reshape(n, 8)
            descs.append(d)
            valids.append(rng.random(n) > 0.05)
    return (descs, valids, np.repeat(np.arange(n_worlds), frames),
            np.tile(np.arange(frames), n_worlds))


def test_retrieval_metrics_equal_jax():
    descs, valids, world_of, idx = _descriptor_sets(np.random.default_rng(5))
    train = np.concatenate([d[v] for d, v in zip(descs, valids)])
    voc_t = vocab.train(train, k=8, levels=3, seed=0)
    voc_j = jvocab.train(train, k=8, levels=3, seed=0)
    for a, b in zip(voc_t.centroids, voc_j.centroids):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    top1_t, margin_t = eval_vocab.retrieval_metrics(
        voc_t, [torch.from_numpy(d.view(np.int32)) for d in descs],
        [torch.from_numpy(v) for v in valids], world_of, idx)
    top1_j, margin_j = _script("eval_vocab").retrieval_metrics(
        voc_j, descs, valids, world_of, idx)
    assert top1_t == top1_j
    assert abs(margin_t - margin_j) <= 1e-6 * abs(margin_j)


def test_train_phase_matches_jax(tmp_path, monkeypatch):
    """VOCAB_PHASE=train on one cached descriptor file: the JAX tool's
    ``_train_and_save`` and the port's ``main`` save the same centroids
    and idf, and each package loads the other's file."""
    descs = np.random.default_rng(11).integers(
        0, 1 << 32, (4000, 8), dtype=np.uint64).astype(np.uint32)
    cache = tmp_path / "desc.npy"
    np.save(cache, descs)
    out_j, out_t = tmp_path / "jax.npz", tmp_path / "port.npz"
    _script("train_vocab")._train_and_save(np.load(cache), 2, str(out_j),
                                           time.time())
    monkeypatch.setenv("VOCAB_PHASE", "train")
    monkeypatch.setenv("VOCAB_DESC_CACHE", str(cache))
    assert train_vocab.main(["2", "0", str(out_t), "--device", "cpu"]) == 0
    zj, zt = np.load(out_j), np.load(out_t)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zj[k], zt[k])
    by_port, by_jax = vocab.load(out_j, CPU), jvocab.load(str(out_t))
    assert (by_port.k, by_port.levels) == (by_jax.k, by_jax.levels) == (10, 2)
    for a, b in zip(by_port.centroids, by_jax.centroids):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    np.testing.assert_array_equal(by_port.idf, np.asarray(by_jax.idf))


def test_default_out_lies_outside_the_jax_package():
    jax_pkg = (REPO / "orb_slam3_detailed_comments_tpu").resolve()
    for p in (train_vocab.DEFAULT_OUT, train_vocab.DEFAULT_CACHE,
              make_dataset_configs.DEFAULT_OUT):
        assert p.resolve().is_relative_to(REPO / "build")
        assert not p.resolve().is_relative_to(jax_pkg)
    with pytest.raises(SystemExit, match="bundled vocabulary"):
        train_vocab.run(2, 1, str(vocab.DEFAULT_PATH), "all", "unused", CPU)


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "examples" / "config").glob("*.yaml")))
def test_make_dataset_configs_writes_the_jax_key_lines(name, tmp_path):
    src = REPO / "examples" / "config" / name
    _script("make_dataset_configs").emit(str(src), str(tmp_path / "j.yaml"),
                                         "note")
    make_dataset_configs.emit(str(src), str(tmp_path / "t.yaml"), "note")
    keys = lambda p: [ln for ln in p.read_text().splitlines()
                      if not ln.startswith("#")]
    assert keys(tmp_path / "t.yaml") == keys(tmp_path / "j.yaml")
    assert len(keys(tmp_path / "t.yaml")) > 20


def test_make_dataset_configs_main_reads_canonical_files(tmp_path):
    assert make_dataset_configs.main(
        [str(REPO / "examples" / "config"), str(tmp_path),
         "--device", "cpu"]) == 0
    assert (sorted(p.name for p in tmp_path.glob("*.yaml"))
            == sorted(name for _, name, _ in make_dataset_configs.JOBS))


@pytest.mark.parametrize("tool, argv", [
    (eval_vocab, ["voc.npz"]), (train_vocab, ["2", "1"]),
    (profile_stages, ["2"]), (make_dataset_configs, [])],
    ids=["eval_vocab", "train_vocab", "profile_stages",
         "make_dataset_configs"])
def test_tools_need_the_card_unless_cpu_asked(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


@pytest.mark.slow
def test_vocab_domain_shift_gate_on_the_port():
    """``tests/test_placerec.py::test_vocab_domain_shift_gate``'s case and
    gates on the port, on the CPU: the three shifted domains, 10 worlds x
    8 frames each from seed 50,000, the bundled vocabulary; top1 >= 0.88
    and margin >= 3.0 in each domain."""
    cam = cameras.pinhole(**eval_vocab.CAM_KW)
    cfg = extractor.OrbConfig(n_features=1024)
    voc = vocab.load(device=CPU)
    shifted = {k: fn for k, fn in synth_render.TEXTURE_DOMAINS.items()
               if k != "blob"}
    assert len(shifted) >= 3, sorted(shifted)
    results = {}
    for name, fn in shifted.items():
        data = eval_vocab.render_eval_set(cam, cfg, n_worlds=10,
                                          frames_per_world=8, seed0=50_000,
                                          texture_fn=fn, device=CPU)
        results[name] = eval_vocab.retrieval_metrics(voc, *data)
    for name, (top1, margin) in results.items():
        assert top1 >= 0.88, f"domain {name}: top1 {top1:.3f} < 0.88"
        assert margin >= 3.0, f"domain {name}: margin {margin:.2f} < 3.0"
