"""The port's frame-batched extraction against per-frame extraction and
against the JAX package's, on the CPU: ``ops/extractor.extract_batch``,
``pipeline/kernels.prepare_frames``, ``parallel/batch_extract`` and
``System.track_monocular_batch`` (the mirrors of ``tests/test_parallel.py``'s
``test_batch_extract_sharded_matches_single`` and
``test_batch_ingest_matches_online_tracking``).

The sharded cases run in 4 ``gloo`` processes (``tests/torch_dist_cases.py``,
started once for the file), the JAX package on ``Mesh(jax.devices()[:4])``.

Tolerances. A batch's frames equal their own per-frame extraction bit for
bit in every field (``extract_batch`` at B = 1, 2, 3 and 8, and through the
process group: the JAX test's exact ``desc`` / ``valid`` and 1e-5 on
``xy``, here exact). Against the JAX package's batch extractor, whose
default is its ``"xla"`` front end where the port's is ``"fused"``:
``xy`` / ``level`` / ``valid`` equal on all but at most 1 slot a frame and
>= 97 % of the descriptors equal (``tests/test_torch_frontend.py``'s whole
-extractor gates: the moment maps sum in another order, and an angle on a
bin boundary may flip its descriptor). Batch ingestion: the same frames
tracked as online, poses within 1e-5 (the JAX test's gates), on 14 frames
of world seed 3's orbit at 376x240 with 512 features, where the JAX test's
20 frames at 320x240 with 1024 features take minutes on the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.parallel import batch_extract as jbe
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import (extractor, frontend,
                                                       patches, topk)
from orb_slam3_detailed_comments_tpu_torch.parallel import batch_extract
from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

import torch_dist_cases

torch.set_num_threads(2)

WORLD = 4
CAM = cameras.pinhole(fx=200.0, fy=200.0, cx=96.0, cy=64.0, width=192,
                      height=128, k1=0.05, p1=1e-3)
CFG = dict(n_features=128, n_levels=3)
SYS_CAM = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376,
                          height=240)
N_INGEST = 14


@pytest.fixture(scope="module")
def imgs():
    """test_batch_extract_sharded_matches_single's 8 frames."""
    planes = synth_render.default_world(np.random.default_rng(42),
                                        tex_size=400)
    R, t = synth_render.orbit_trajectory(8)
    return np.stack([synth_render.render_frame_raycast(CAM, planes, R[i],
                                                       t[i])[0]
                     for i in range(8)])


@pytest.fixture(scope="module")
def runs(imgs, tmp_path_factory):
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(60)
    frames = np.stack([synth_render.render_frame_raycast(SYS_CAM, planes,
                                                         R[i], t[i])[0]
                       for i in range(N_INGEST)])
    inp = dict(cfg=CFG, imgs=imgs, sys_cam=tuple(SYS_CAM), frames=frames,
               ts=np.arange(N_INGEST) * 0.05,
               track_cfg=dict(n_features=512, min_init_matches=50),
               map_cfg=dict(max_kf=32, max_pt=2048, n_feat=512))
    return torch_dist_cases.run_cases(
        WORLD, "batch_extract_cases", inp,
        tmp_path_factory.mktemp("batch_extract"))


def _equal(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert torch.equal(x, y), (what, f)


@pytest.mark.parametrize("B", [1, 2, 3, 8])
def test_extract_batch_equals_extract(imgs, B):
    """B frames at once equal B calls of extract, bit for bit (at 3
    levels a patch gather's table holds 5 frames, at 8 levels 2)."""
    cfg = extractor.OrbConfig(**CFG)
    batch = extractor.extract_batch(torch.from_numpy(imgs[:B]), cfg)
    for i in range(B):
        _equal(type(batch)(*[x[i] for x in batch]),
               extractor.extract(torch.from_numpy(imgs[i]), cfg), i)


@pytest.mark.parametrize("B", [2, 8])
def test_prepare_frames_equal_prepare_frame(imgs, B):
    """The undistortion too, on a distorted camera, at the default 8
    levels."""
    cfg = extractor.OrbConfig(n_features=256)
    for i, p in enumerate(kernels.unbatch(kernels.prepare_frames(
            torch.from_numpy(imgs[:B]), CAM, cfg))):
        r = kernels.prepare_frame(torch.from_numpy(imgs[i]), CAM, cfg)
        _equal(p.feat, r.feat, i)
        assert torch.equal(p.xy_ud, r.xy_ud) and torch.equal(p.xyn, r.xyn)


def test_extract_batch_calls_each_kernel_entry_once_a_table(imgs,
                                                            monkeypatch):
    """8 frames of 8 levels: dense_frontend_levels and cell_topk_levels
    once for all 64 levels (the card launches each once for every 16),
    gather_patches_levels once for every 2 frames."""
    calls = dict(dense=[], topk=[], patches=[])
    for mod, name, key in ((frontend, "dense_frontend_levels", "dense"),
                           (topk, "cell_topk_levels", "topk"),
                           (patches, "gather_patches_levels", "patches")):
        orig = getattr(mod, name)

        def counted(levels, *a, _orig=orig, _key=key, **kw):
            calls[_key].append(len(list(levels)))
            return _orig(levels, *a, **kw)

        monkeypatch.setattr(mod, name, counted)
    extractor.extract_batch(torch.from_numpy(imgs),
                            extractor.OrbConfig(n_features=256))
    assert calls == dict(dense=[64], topk=[64], patches=[16] * 4)


def test_prepare_frames_pads_the_last_block(imgs):
    """5 frames in blocks of 2 on one process: 3 blocks, the last padded
    with its frame and the padding dropped."""
    cfg = extractor.OrbConfig(**CFG)
    out = batch_extract.prepare_frames(CAM, cfg, imgs[:5], device="cpu")
    assert len(out) == 5
    for i, p in enumerate(out):
        r = kernels.prepare_frame(torch.from_numpy(imgs[i]), CAM, cfg)
        _equal(p.feat, r.feat, i)
        assert torch.equal(p.xyn, r.xyn)


def test_batch_extract_sharded_matches_single(runs):
    """The group's batch extractor gives every frame exactly its own
    extraction."""
    out = runs[0]
    for i, ref in enumerate(out["single"]):
        for f, v in ref.items():
            np.testing.assert_array_equal(out["sharded"][f][i], v,
                                          err_msg=f"frame {i} {f}")


def test_batch_extract_matches_jax(runs, imgs):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), (jbe.FRAME_AXIS,))
    got = runs[0]["sharded"]
    ref = jbe.make_batch_extractor(mesh, jext.OrbConfig(**CFG))(
        jnp.asarray(imgs))
    for i in range(imgs.shape[0]):
        same = ((got["valid"][i] == np.asarray(ref.valid[i]))
                & (got["level"][i] == np.asarray(ref.level[i]))
                & np.all(got["xy"][i] == np.asarray(ref.xy[i]), -1))
        assert (~same).sum() <= 1, i
        d = np.all(got["desc"][i].view(np.uint32)
                   == np.asarray(ref.desc[i]).view(np.uint32), -1)
        assert d[same].mean() >= 0.97, (i, d[same].mean())


def test_every_rank_has_the_same_batch(runs):
    for r in range(1, WORLD):
        for f, v in runs[0]["sharded"].items():
            np.testing.assert_array_equal(runs[r]["sharded"][f], v)


def test_batch_ingest_matches_online_tracking(runs):
    """System.track_monocular_batch (blocks of 8 frames a process over 4
    processes, one block, padded; rank 0 tracks, the others serve) gives
    the online trajectory."""
    online, batch = runs[0]["online"], runs[0]["batch"]
    assert len(batch) == N_INGEST
    assert sum(x is not None for x in online) >= N_INGEST // 2
    for i, (x, y) in enumerate(zip(online, batch)):
        assert (x is None) == (y is None), i
        if x is not None:
            np.testing.assert_allclose(x, y, atol=1e-5, err_msg=str(i))
    # the sequence is one job that every other rank served
    assert [runs[r]["served"] for r in range(1, WORLD)] == [1] * 3
