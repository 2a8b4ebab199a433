"""The port's frame-wide keypoint selection and patch gather against the JAX
package, on the CPU.

``topk.cell_topk_levels``, ``fast.select_levels`` and
``patches.gather_patches_levels`` take every pyramid level of a frame in
one call (one kernel launch each on the card). On CPU tensors they run
their plain versions, which these tests hold to the JAX package's
per-level functions: ``pallas_topk.cell_topk`` in interpret mode and
``lax.top_k`` on the cell matrix that ``select_grid_topk`` builds,
``fast.select_from_nms_score`` level by level, ``brief.extract_patches``
level by level and ``pallas_patches.gather_patches_atlas`` in interpret
mode. The card's kernels are held against the same plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Tolerance everywhere
here: exact equality of values, indices, coordinates, masks and patches.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.ops import brief as jbrief
from orb_slam3_detailed_comments_tpu.ops import fast as jfast
from orb_slam3_detailed_comments_tpu.ops import pallas_patches, pallas_topk
from orb_slam3_detailed_comments_tpu_torch.ops import (
    brief, extractor, fast, frontend, layout, patches, pyramid, topk)

torch.set_num_threads(2)

MARGIN = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def frame_layout(h, w, n_levels):
    cfg = extractor.OrbConfig(n_levels=n_levels)
    return (pyramid.level_shapes(h, w, n_levels, cfg.scale),
            layout.content_dims(cfg, h, w))


def synth_image(rng, h, w, n_blobs=120):
    """Textured synthetic image with corner-rich structure, integer-valued."""
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        bh, bw = rng.integers(4, 16), rng.integers(4, 16)
        img[y:y + bh, x:x + bw] = rng.uniform(0, 255)
    img += rng.normal(0, 2.0, size=(h, w)).astype(np.float32)
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


def planted_maps(rng, shapes):
    """NMS-like score maps with negative scores (NMS keeps them) and scores
    in the border strip and in the rows and columns past the content, which
    the mask must zero. Level 0's cells (1, 1), (1, 2) and (2, 1) lie
    inside the mask: three tied maxima, a cell of negative scores with two
    tied maxima, an all-zero cell. The last level is all negative."""
    maps = []
    for h, w in shapes:
        s = np.where(rng.uniform(size=(h, w)) < 0.08,
                     rng.integers(1, 120, (h, w)), 0).astype(np.float32)
        neg = rng.uniform(size=(h, w)) < 0.03
        s[neg] = -rng.integers(1, 60, int(neg.sum())).astype(np.float32)
        s[:, -1] = 90.0                                # past the content
        s[h - 1, :] = 91.0
        maps.append(s)
    s = maps[0]
    s[32:64, 32:64] = 0.0
    s[40, 40] = s[40, 50] = s[41, 33] = 77.0
    s[32:64, 64:96] = -rng.integers(2, 60, (32, 32)).astype(np.float32)
    s[35, 70] = s[60, 66] = -1.0
    s[64:96, 32:64] = 0.0
    maps[-1] = -np.abs(maps[-1]) - 1.0
    return maps


def jax_cells(score, content, margin, cell=32):
    """The cell matrix of orb_slam3_detailed_comments_tpu/ops/fast.py
    select_from_nms_score + select_grid_topk (:112-117)."""
    s = jnp.where(jfast.border_mask(score.shape, content, margin),
                  jnp.asarray(score), 0.0)
    h, w = s.shape
    s = jnp.pad(s, ((0, (-h) % cell), (0, (-w) % cell)))
    H, W = s.shape
    return s.reshape(H // cell, cell, W // cell, cell).transpose(
        0, 2, 1, 3).reshape(-1, cell * cell)


@pytest.mark.parametrize("h,w,n_levels,k", [(120, 160, 3, 8),
                                            (120, 160, 4, 4),
                                            (240, 320, 4, 8)])
def test_cell_topk_levels_plain_matches_pallas_and_lax(h, w, n_levels, k):
    shapes, contents = frame_layout(h, w, n_levels)
    maps = planted_maps(np.random.default_rng(h + k), shapes)
    vals, idx = topk.cell_topk_levels([_t(m) for m in maps], contents,
                                      MARGIN, k)
    cells = jnp.concatenate([jax_cells(m, c, MARGIN)
                             for m, c in zip(maps, contents)])
    assert vals.shape == idx.shape == (cells.shape[0], k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    for ref in (pallas_topk.cell_topk(cells, k, interpret=True),
                jax.lax.top_k(cells, k)):
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1]))
    # the planted cells: three tied maxima, tied negative maxima, all zero
    ncx = -(-shapes[0][1] // 32)
    assert list(idx[ncx + 1, :3].numpy()) == [8 * 32 + 8, 8 * 32 + 18,
                                              9 * 32 + 1]
    assert list(vals[ncx + 2, :2].numpy()) == [-1.0, -1.0]
    assert list(idx[ncx + 2, :2].numpy()) == [3 * 32 + 6, 28 * 32 + 2]
    assert (vals[2 * ncx + 1] == 0).all()
    assert list(idx[2 * ncx + 1].numpy()) == list(range(k))


def test_cell_topk_levels_masks_like_select_from_nms_score():
    """Level by level, the plain version's cells are the JAX package's."""
    shapes, contents = frame_layout(120, 160, 4)
    maps = planted_maps(np.random.default_rng(3), shapes)
    for m, c in zip(maps, contents):
        np.testing.assert_array_equal(
            topk.level_cells(_t(m), c, MARGIN).numpy(),
            np.asarray(jax_cells(m, c, MARGIN)))


def test_matrix_entry_equals_levels_on_its_view():
    """cell_topk on [C, 1024] is cell_topk_levels on the [32 C, 32] view
    with no mask, -inf rows included."""
    rng = np.random.default_rng(9)
    x = np.where(rng.uniform(size=(37, 1024)) < 0.08,
                 rng.integers(7, 100, (37, 1024)), 0).astype(np.float32)
    x[2, :] = -np.inf
    x[3, :] = -np.inf
    x[3, [7, 700]] = 3.0
    x[4, [5, 900]] = 42.0
    a = topk.cell_topk(_t(x), 8)
    b = topk.cell_topk_levels([_t(x).view(32 * 37, 32)], [(32 * 37, 32)], 0, 8)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.numpy(), q.numpy())
    assert list(a[1][3, :2].numpy()) == [7, 700]


def test_levels_entries_raise_past_their_tables():
    """cell_topk_levels takes any number of levels (the kernel one launch a
    MAX_LEVELS of them, the rows as from one table); gather_patches_levels
    still refuses more images than its table holds."""
    maps = [torch.full((32, 32), float(i)) for i in range(topk.MAX_LEVELS + 1)]
    v, i = topk.cell_topk_levels(maps, [(32, 32)] * len(maps), 0, 8)
    assert v.shape == (topk.MAX_LEVELS + 1, 8)
    assert v[:, 0].tolist() == [float(i) for i in range(len(maps))]
    assert topk.cell_topk_levels(maps[1:], [(32, 32)] * topk.MAX_LEVELS,
                                 0, 8)[0].shape == (topk.MAX_LEVELS, 8)
    with pytest.raises(ValueError, match="content"):
        topk.cell_topk_levels(maps[:2], [(32, 32)], 0, 8)
    level = torch.zeros(3, dtype=torch.int32)
    rc = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="images"):
        patches.gather_patches_levels(maps, level, rc, 5)
    assert patches.gather_patches_levels(maps[1:], level, rc,
                                         5).shape == (3, 5, 5)


def _score_maps(img, n_levels):
    levels = pyramid.build_pyramid(_t(img), n_levels, 1.2)
    return [frontend.dense_frontend(l)[0] for l in levels]


@pytest.mark.parametrize("n_features,k", [(256, 8), (256, 4), (300, 8)],
                         ids=["full", "short-top-level", "3-levels"])
def test_select_levels_matches_jax_per_level(n_features, k):
    """Against fast.select_from_nms_score of the JAX package, level by
    level. With k = 4, three levels of a 120x160 frame have fewer
    candidates than their budgets (the top one 9 cells, 36 candidates, for
    a budget of 48)."""
    n_levels = 3 if n_features == 300 else 4
    cfg = extractor.OrbConfig(n_features=n_features, n_levels=n_levels,
                              k_per_cell=k)
    img = synth_image(np.random.default_rng(21), 120, 160)
    maps = _score_maps(img, n_levels)
    lay = layout.frame_layout(cfg, 120, 160, torch.device("cpu"))
    contents, budgets = lay.contents, list(lay.budgets)
    assert contents == tuple(layout.content_dims(cfg, 120, 160))
    assert budgets == layout.level_budgets(cfg)
    got = fast.select_levels(maps, lay)
    assert got.yx.shape == (sum(budgets), 2) and got.yx.dtype == torch.int32
    short = 0
    for lv, (m, c, n, yx, sc, ok) in enumerate(zip(
            maps, contents, budgets, got.yx.split(budgets),
            got.score.split(budgets), got.valid.split(budgets))):
        ref = jfast.select_from_nms_score(jnp.asarray(m.numpy()), c, n,
                                          cell=32, k_per_cell=k,
                                          min_th=cfg.min_th,
                                          margin=cfg.margin)
        np.testing.assert_array_equal(yx.numpy(), np.asarray(ref.yx))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(ref.score))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref.valid))
        own = fast.select_from_nms_score(m, c, n, k_per_cell=k,
                                         min_th=cfg.min_th, margin=cfg.margin)
        for a, b in zip((yx, sc, ok), own):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert ok.any()
        short += int(np.prod([-(-d // 32) for d in m.shape])) * k < n
    assert short == (3 if k == 4 else 0)


def test_frame_layout_is_built_once_and_held_to_its_maps():
    """One layout a (config, frame size, device), shared by the extractor
    and select_levels; maps of another frame size are refused."""
    cfg = extractor.OrbConfig(n_features=256, n_levels=4)
    lay = layout.frame_layout(cfg, 120, 160, torch.device("cpu"))
    assert layout.frame_layout(cfg, 120, 160, torch.device("cpu")) is lay
    assert lay.shapes == tuple(pyramid.level_shapes(120, 160, 4, cfg.scale))
    n = sum(lay.budgets)
    assert lay.level.shape == lay.cut.shape == lay.base.shape == (n,)
    np.testing.assert_array_equal(
        lay.level.numpy(), np.repeat(np.arange(4), lay.budgets))
    maps = _score_maps(synth_image(np.random.default_rng(2), 128, 160), 4)
    with pytest.raises(ValueError, match="layout"):
        fast.select_levels(maps, lay)


def _level_images(rng, shapes):
    return [rng.uniform(0, 255, s).astype(np.float32) for s in shapes]


def test_gather_patches_levels_plain_matches_jax_extract_patches():
    """Each keypoint's 37x37 window from its own level, at patch_corners'
    corners with the level's content looked up per keypoint, keypoints
    past the content and the image included: equal to JAX
    brief.extract_patches level by level."""
    rng = np.random.default_rng(4)
    shapes, contents = frame_layout(120, 160, 4)
    imgs = _level_images(rng, shapes)
    budgets = [40, 30, 20, 12]
    yx, lv = [], []
    for l, ((h, w), n) in enumerate(zip(shapes, budgets)):
        p = np.stack([rng.integers(-5, h + 5, n), rng.integers(-5, w + 5, n)], 1)
        p[:2] = [[-3, -8], [h + 4, w + 9]]
        yx.append(p.astype(np.int32))
        lv.append(np.full(n, l, np.int32))
    yx_all, lv_all = np.concatenate(yx), np.concatenate(lv)
    dims = np.array(contents, np.int32)[lv_all]
    rc = brief.patch_corners(_t(yx_all), brief.PATCH_R,
                             (_t(dims[:, 0]), _t(dims[:, 1])))
    got = patches.gather_patches_levels([_t(i) for i in imgs], _t(lv_all), rc,
                                        brief.PATCH_W)
    assert got.shape == (sum(budgets), brief.PATCH_W, brief.PATCH_W)
    for g, img, p, c in zip(got.split(budgets), imgs, yx, contents):
        ref = jbrief.extract_patches(jnp.asarray(img), jnp.asarray(p), c)
        np.testing.assert_array_equal(g.reshape(len(p), -1).numpy(),
                                      np.asarray(ref))
        np.testing.assert_array_equal(
            g.reshape(len(p), -1).numpy(),
            brief.extract_patches(_t(img), _t(p), c).numpy())


def test_gather_patches_levels_takes_lax_dynamic_slice_corners():
    """Raw corners, negative and past the far edge, in each level image:
    placed as lax.dynamic_slice places them (gather_patches_atlas_xla on
    the level image as its own atlas)."""
    rng = np.random.default_rng(5)
    shapes, _ = frame_layout(120, 160, 4)
    imgs = _level_images(rng, shapes)
    rc, lv = [], []
    for l, (h, w) in enumerate(shapes):
        r = np.stack([rng.integers(-50, h + 20, 16),
                      rng.integers(-60, w + 20, 16)], 1)
        r[:3] = [[-4, -9], [h - 2, w - 1], [-h - 7, 3]]
        rc.append(r.astype(np.int32))
        lv.append(np.full(16, l, np.int32))
    got = patches.gather_patches_levels(
        [_t(i) for i in imgs], _t(np.concatenate(lv)),
        _t(np.concatenate(rc)), 31, 33)
    for g, img, r in zip(got.split(16), imgs, rc):
        ref = pallas_patches.gather_patches_atlas_xla(jnp.asarray(img),
                                                      jnp.asarray(r), 31, 33)
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref))


def test_one_image_table_is_the_atlas_gather():
    """The "xla" front end's case: one atlas, the one-image table, equal to
    the Pallas kernel in interpret mode on corners inside the atlas and to
    its lax.dynamic_slice form on corners outside it."""
    rng = np.random.default_rng(6)
    shapes, _ = frame_layout(120, 160, 4)
    lv_np = _level_images(rng, shapes)
    atlas_j, offs = pallas_patches.build_atlas([jnp.asarray(a) for a in lv_np],
                                               160)
    atlas, offs_t = patches.build_atlas([_t(a) for a in lv_np], 160)
    assert offs_t == offs
    rc = np.concatenate([np.stack([rng.integers(0, s[0] - 37, 24) + o,
                                   rng.integers(0, s[1] - 37, 24)], 1)
                         for s, o in zip(shapes, offs)])
    rc = np.concatenate([rc, [[atlas.shape[0] - 3, atlas.shape[1] - 5],
                              [-4, -9]]]).astype(np.int32)
    one = patches.gather_patches_levels(
        [atlas], torch.zeros(len(rc), dtype=torch.int32), _t(rc), 37)
    np.testing.assert_array_equal(
        one.numpy(), patches.gather_patches(atlas, _t(rc), 37).numpy())
    ref = pallas_patches.gather_patches_atlas(atlas_j, jnp.asarray(rc[:-2]),
                                              37, interpret=True)
    np.testing.assert_array_equal(one[:-2].numpy(), np.asarray(ref))
    ref_xla = pallas_patches.gather_patches_atlas_xla(atlas_j,
                                                      jnp.asarray(rc), 37)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref_xla))


@pytest.mark.parametrize("fe", extractor.FRONTENDS)
def test_extractor_selects_and_gathers_once_a_frame(monkeypatch, fe):
    """Both front ends select all levels in one cell_topk_levels call; the
    fused one gathers all patches in one gather_patches_levels call."""
    calls = []
    for mod, name in ((topk, "cell_topk_levels"),
                      (patches, "gather_patches_levels"),
                      (patches, "gather_patches")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    img = _t(synth_image(np.random.default_rng(16), 120, 160))
    f = extractor.extract(img, extractor.OrbConfig(n_features=128,
                                                   n_levels=3), fe)
    assert f.desc.shape == (128, 8) and bool(f.valid.any())
    want = (["cell_topk_levels", "gather_patches_levels"] if fe == "fused"
            else ["cell_topk_levels", "gather_patches", "gather_patches"])
    assert calls == want
