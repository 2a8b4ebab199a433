"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built from csrc/ with nvcc on first use) and skip elsewhere. The machine
with the card has no JAX, so run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality of values and indices, at the shapes of the
752x480, 1024-feature main path plus constructed ties and gated rows
(``cell_topk``, ``gather_patches`` and ``dense_frontend`` also over tables
of 1, 16 and 17 levels, the last in two launches; ``cell_topk`` at cells
16, 24, 48 and 64,
with ``chip_smoke.score_maps_case`` and ``chip_smoke.corners_case``), and
for the best-2 searches also from 1 x 1 to 64 x 5000 with ties planted
across and within the kernel's lanes (``chip_smoke.tie_case``).
``dense_frontend``: score and blur exactly equal, each moment map within
5.0 absolute (moments of order 1e5 summed in another order).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam3_detailed_comments_tpu_torch import native
from orb_slam3_detailed_comments_tpu_torch.ops import (
    frontend, hamming, patches, pyramid, topk)

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _same(a, b):
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("rows", [360, 35, 1])
def test_cell_topk_kernel_equals_plain(dev, rng, rows):
    x = np.where(rng.uniform(size=(rows, 1024)) < 0.08,
                 rng.integers(7, 100, (rows, 1024)), 0).astype(np.float32)
    x[0, :] = 0.0
    if rows > 3:
        x[1, [5, 900]] = 42.0
        x[2, :] = -np.inf
        x[3, :] = -np.inf
        x[3, [7, 700]] = 3.0
    xc = torch.from_numpy(x).to(dev)
    before = native.launches["cell_topk"]
    v, i = topk.cell_topk(xc, 8)
    assert native.launches["cell_topk"] == before + 1
    vp, ip = topk.cell_topk_plain(xc, 8)
    _same(v, vp)
    _same(i, ip)


def _main_path_layout():
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor, layout
    orb = extractor.OrbConfig()
    return (orb, pyramid.level_shapes(480, 752, orb.n_levels, orb.scale),
            layout.content_dims(orb, 480, 752))


def test_cell_topk_levels_kernel_equals_plain(dev, rng):
    """The frame's one launch over the 8 level maps of a 752x480 frame
    (all-zero, tied, negative and -inf cells, scores past the content),
    then tables of 1 and 16 levels; 17 levels take two launches."""
    orb, shapes, contents = _main_path_layout()
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    maps = chip_smoke.score_maps_case(rng, shapes, f)
    k, margin = orb.k_per_cell, orb.margin
    for m, c in ((maps, contents), (maps[-1:], contents[-1:]),
                 (maps * 2, contents * 2)):
        before = native.launches["cell_topk"]
        v, i = topk.cell_topk_levels(m, c, margin, k)
        assert native.launches["cell_topk"] == before + 1
        vp, ip = topk.cell_topk_levels_plain(m, c, margin, k)
        _same(v, vp)
        _same(i, ip)
    ncx = -(-shapes[0][1] // 32)
    v, i = topk.cell_topk_levels(maps, contents, margin, k)
    assert i[ncx + 3, :3].tolist() == [33, 600, 992]
    assert i[ncx + 4].tolist() == list(range(k))
    assert bool(torch.isinf(v[ncx + 4]).all())
    before = native.launches["cell_topk"]
    m17, c17 = maps * 2 + maps[:1], contents * 2 + contents[:1]
    v, i = topk.cell_topk_levels(m17, c17, margin, k)
    assert native.launches["cell_topk"] == before + 2
    vp, ip = topk.cell_topk_levels_plain(m17, c17, margin, k)
    _same(v, vp)
    _same(i, ip)


@pytest.mark.parametrize("cell", [16, 48, 64, 80, 24])
def test_cell_topk_levels_other_cells_equal_cpu(dev, rng, cell):
    """OrbConfig(cell=16) and the other cells: the kernel for 16 (in
    registers) and 48, 64 and 80 (the scan kernel), the plain version for
    24 (area not a multiple of 128, the JAX package's rule), equal to the
    CPU's result over 8 and 17 levels."""
    orb, shapes, contents = _main_path_layout()
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    maps = chip_smoke.score_maps_case(rng, shapes, f)
    k, margin = orb.k_per_cell, orb.margin
    for m, c in ((maps, contents), (maps * 2 + maps[:1],
                                    contents * 2 + contents[:1])):
        before = native.launches["cell_topk"]
        v, i = topk.cell_topk_levels(m, c, margin, k, cell)
        want = -(-len(m) // topk.MAX_LEVELS) if cell != 24 else 0
        assert native.launches["cell_topk"] == before + want
        vc, ic = topk.cell_topk_levels([x.cpu() for x in m], c, margin, k,
                                       cell)
        _same(v, vc)
        _same(i, ic)
    C = 37
    x = f(np.where(rng.uniform(size=(C, cell * cell)) < 0.08,
                   rng.integers(7, 100, (C, cell * cell)), 0).astype(
                       np.float32))
    for a, b in zip(topk.cell_topk(x, k), topk.cell_topk(x.cpu(), k)):
        _same(a, b)


@pytest.mark.parametrize("area", [128, 384, 2304, 200])
def test_cell_topk_matrix_rows_equal_cpu(dev, rng, area):
    """cell_topk on [C, A] rows that are not a square of 16 or 32: one
    launch of the scan kernel for A of 128 m (1 x A cells, or the
    [48 C, 48] view for 2304), none for 200; equal to the CPU, ties and
    -inf rows included."""
    C = 53
    x = np.where(rng.uniform(size=(C, area)) < 0.08,
                 rng.integers(7, 100, (C, area)), 0).astype(np.float32)
    x[1, [5, area - 1]] = 42.0
    x[2, :] = -np.inf
    x = torch.from_numpy(x).to(dev)
    before = native.launches["cell_topk"]
    got = topk.cell_topk(x, 8)
    assert native.launches["cell_topk"] == before + (area % 128 == 0)
    for a, b in zip(got, topk.cell_topk(x.cpu(), 8)):
        _same(a, b)


def test_gather_patches_levels_kernel_equals_plain(dev, rng):
    """The frame's one launch: 1024 37x37 windows from the 8 level images
    at patch_corners' corners, some outside the image; then tables of 1 and
    16 images in one launch and of 17 in two, each as one table gives."""
    from orb_slam3_detailed_comments_tpu_torch.ops import brief, layout
    orb, shapes, contents = _main_path_layout()
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    imgs = [f(np.round(rng.uniform(0, 255, s)).astype(np.float32))
            for s in shapes]
    level, rc = chip_smoke.corners_case(rng, shapes, contents,
                                        layout.level_budgets(orb), f)
    alt = level + 8 * (torch.arange(level.shape[0], device=dev) % 2).to(
        torch.int32)
    pw = brief.PATCH_W
    for im, lv in ((imgs, level), (imgs[:1], torch.zeros_like(level)),
                   (imgs * 2, alt)):
        before = native.launches["gather_patches"]
        got = patches.gather_patches_levels(im, lv, rc, pw)
        assert native.launches["gather_patches"] == before + 1
        _same(got, patches.gather_patches_levels_plain(im, lv, rc, pw))
    lv17 = torch.where(torch.arange(level.shape[0], device=dev) % 3 == 0,
                       torch.full_like(level, 16), alt)
    before = native.launches["gather_patches"]
    got = patches.gather_patches_levels(imgs * 2 + imgs[:1], lv17, rc, pw)
    assert native.launches["gather_patches"] == before + 2
    _same(got, patches.gather_patches_levels_plain(imgs * 2 + imgs[:1], lv17,
                                                   rc, pw))


@pytest.mark.parametrize("ph", [31, 37])
def test_gather_patches_kernel_equals_plain(dev, rng, ph):
    atlas = torch.from_numpy(
        rng.uniform(0, 255, (2296, 896)).astype(np.float32)).to(dev)
    rc = np.stack([rng.integers(0, 2296 - ph, 1024),
                   rng.integers(0, 752 - ph, 1024)], 1).astype(np.int32)
    rc[:3] = [[-4, -9], [2290, 890], [0, 0]]        # clamped corners
    rcc = torch.from_numpy(rc).to(dev)
    _same(patches.gather_patches(atlas, rcc, ph),
          patches.gather_patches_plain(atlas, rcc, ph))


def _desc(rng, n, dev):
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(d.view(np.int32)).to(dev)


@pytest.mark.parametrize("Q,K", [(1024, 1024), (4096, 1024), (1000, 1000)])
def test_windowed_best2_kernel_equals_plain(dev, rng, Q, K):
    da, db = _desc(rng, Q, dev), _desc(rng, K, dev)
    db[7] = da[0]
    db[9] = da[0]                                    # tie: i1 = 7, d2 == d1
    f = lambda a: torch.from_numpy(a).to(dev)
    q_uv = f(rng.uniform(0, 752, (Q, 2)).astype(np.float32))
    t_xy = f(rng.uniform(0, 752, (K, 2)).astype(np.float32))
    t_xy[7] = t_xy[9] = q_uv[0]
    q_r = f(rng.uniform(4, 60, Q).astype(np.float32))
    q_r[1] = 0.0                                     # all-gated row
    q_lv = f(rng.integers(0, 8, Q).astype(np.int32))
    t_lv = f(rng.integers(0, 8, K).astype(np.int32))
    t_lv[7] = t_lv[9] = q_lv[0]
    lo = torch.full((Q,), -1, dtype=torch.int32, device=dev)
    hi = torch.ones(Q, dtype=torch.int32, device=dev)
    qv = f(rng.uniform(size=Q) < 0.9)
    qv[0] = True
    tv = f(rng.uniform(size=K) < 0.9)
    tv[7] = tv[9] = True
    args = (da, q_uv, q_lv, q_r, lo, hi, qv, db, t_xy, t_lv, tv)
    out = hamming.hamming_best2_windowed(*args)
    ref = hamming.hamming_best2_windowed_plain(*args)
    for a, b in zip(out, ref):
        _same(a, b)
    assert int(out[1][0]) == 7 and int(out[0][0]) == 0 == int(out[2][0])
    assert int(out[0][1]) == hamming.BIG and int(out[1][1]) == 0


@pytest.mark.parametrize("Q,K", [(1024, 1024), (1000, 1000)])
def test_best2_kernel_equals_plain(dev, rng, Q, K):
    da, db = _desc(rng, Q, dev), _desc(rng, K, dev)
    db[3] = db[8] = da[0]
    vb = torch.from_numpy(rng.uniform(size=K) < 0.9).to(dev)
    vb[3] = vb[8] = True
    out = hamming.hamming_best2(da, db, vb)
    ref = hamming.hamming_best2_plain(da, db, vb)
    for a, b in zip(out, ref):
        _same(a, b)
    out = hamming.hamming_best2(da, db, torch.zeros_like(vb))
    assert bool((out[0] == hamming.BIG).all()) and bool((out[1] == 0).all())


@pytest.mark.parametrize("Q,K", chip_smoke.TIE_SHAPES)
def test_best2_kernels_equal_plain_on_ties(dev, rng, Q, K):
    """Both searches where a lane merge could go wrong: equal minima in
    neighbouring lanes, in one lane's successive steps, two equal best, a
    row with every target gated out, a row whose only target is the last."""
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = chip_smoke.tie_case(rng, Q, K, f)
    before = dict(native.launches)
    out = hamming.hamming_best2_windowed(*args)
    ref = hamming.hamming_best2_windowed_plain(*args)
    for a, b in zip(out, ref):
        _same(a, b)
    if Q > 4 and K > 100:
        assert int(out[0][0]) == 0 == int(out[2][0])          # a tie at 0
        assert int(out[0][2]) == 8 == int(out[2][2])          # two equal best
        assert (int(out[0][3]), int(out[1][3])) == (hamming.BIG, 0)
        assert (int(out[1][4]), int(out[2][4])) == (K - 1, hamming.BIG)
    plain_args = (args[0], args[7], args[10])
    for a, b in zip(hamming.hamming_best2(*plain_args),
                    hamming.hamming_best2_plain(*plain_args)):
        _same(a, b)
    assert native.launches["hamming_best2_windowed"] == \
        before["hamming_best2_windowed"] + 1
    assert native.launches["hamming_best2"] == before["hamming_best2"] + 1


def test_best2_kernel_takes_a_misaligned_descriptor_view(dev, rng):
    """Descriptors that start 4 bytes into an allocation: the kernel stages
    them with scalar loads instead of 16-byte ones."""
    K = 300
    flat = torch.from_numpy(rng.integers(
        0, 2 ** 32, K * 8 + 1, dtype=np.uint64).astype(np.uint32).view(
            np.int32)).to(dev)
    db = flat[1:].view(K, 8)
    assert db.data_ptr() % 16 != 0 and db.is_contiguous()
    da = _desc(rng, 40, dev)
    vb = torch.ones(K, dtype=torch.bool, device=dev)
    for a, b in zip(hamming.hamming_best2(da, db, vb),
                    hamming.hamming_best2_plain(da, db, vb)):
        _same(a, b)


def test_matching_launches_the_kernels_at_any_shape(dev, rng):
    """match_nn and search_by_projection on card tensors launch the best-2
    kernels whatever Q and K are (no shape falls back to a dense search)."""
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor, matching
    Q, K = 1000, 1000
    da, db = _desc(rng, Q, dev), _desc(rng, K, dev)
    v = torch.ones(K, dtype=torch.bool, device=dev)
    before = dict(native.launches)
    matching.match_nn(da, v, db, v, mutual=True)
    assert native.launches["hamming_best2"] == before["hamming_best2"] + 2
    f = lambda a: torch.from_numpy(a).to(dev)
    xy = f(rng.uniform(0, 752, (K, 2)).astype(np.float32))
    feat = extractor.FrameFeatures(
        xy, f(rng.integers(0, 8, K).astype(np.int32)),
        torch.zeros(K, device=dev), torch.zeros(K, device=dev), db, v)
    matching.search_by_projection(xy[:Q], v[:Q], da, feat.level[:Q], feat, 4.0)
    assert (native.launches["hamming_best2_windowed"]
            == before["hamming_best2_windowed"] + 1)


@pytest.mark.parametrize("shape", pyramid.level_shapes(480, 752)
                         + [(37, 53), (33, 1), (1, 70)])
def test_dense_frontend_kernel_equals_plain(dev, rng, shape):
    """Every level shape of a 752x480 frame, shapes below one tile and
    single-row / single-column images."""
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    img[: shape[0] // 2, : shape[1] // 3] = 40.0        # a flat region
    x = torch.from_numpy(img).to(dev)
    before = native.launches["dense_frontend"]
    got = frontend.dense_frontend(x)
    assert native.launches["dense_frontend"] == before + 1
    ref = frontend.dense_frontend_plain(x)
    _same(got[0], ref[0])
    _same(got[1], ref[1])
    for g, r in zip(got[2:], ref[2:]):
        assert float((g - r).abs().max()) < 5.0


@pytest.mark.parametrize("axis,at", [(1, 40), (0, 20), (1, 95), (0, 33)])
def test_dense_frontend_kernel_equals_plain_on_a_step_edge(dev, axis, at):
    """Halves of 0 and 255 with the edge off the 64-pixel tiles' centres:
    the moments' conditioning constant (a tile's centre pixel) is then 255
    away from the pixels on the edge's other side."""
    img = torch.zeros((96, 160), device=dev)
    img.narrow(axis, at, img.shape[axis] - at).fill_(255.0)
    for x in (img, 255.0 - img):
        got = frontend.dense_frontend(x)
        ref = frontend.dense_frontend_plain(x)
        _same(got[0], ref[0])
        _same(got[1], ref[1])
        for g, r in zip(got[2:], ref[2:]):
            assert float((g - r).abs().max()) < 5.0


def _level_like(rng, shape, dev):
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    img[: shape[0] // 2, : shape[1] // 3] = 40.0        # a flat region
    return torch.from_numpy(img).to(dev)


def test_dense_frontend_levels_kernel_equals_plain(dev, rng):
    """All levels of a 752x480 frame and four shapes below one tile in one
    launch, each level against the plain version."""
    shapes = pyramid.level_shapes(480, 752) + [(37, 53), (33, 64), (64, 31),
                                               (8, 200)]
    levels = [_level_like(rng, s, dev) for s in shapes]
    before = native.launches["dense_frontend"]
    out = frontend.dense_frontend_levels(levels)
    assert native.launches["dense_frontend"] == before + 1
    assert len(out) == len(levels)
    for lvl, got in zip(levels, out):
        ref = frontend.dense_frontend_plain(lvl)
        _same(got[0], ref[0])
        _same(got[1], ref[1])
        for g, r in zip(got[2:], ref[2:]):
            assert g.shape == lvl.shape and g.is_contiguous()
            assert float((g - r).abs().max()) < 5.0


def test_dense_frontend_levels_takes_17_levels(dev, rng):
    """17 levels: two launches (16 + 1), each level's maps equal to the
    plain version (score and blur exactly, moments within 5.0) as one table
    would give them; levels on different devices still raise."""
    shapes = [(int(240 / 1.1 ** l), int(320 / 1.1 ** l)) for l in range(17)]
    lv = [_level_like(rng, s, dev) for s in shapes]
    before = native.launches["dense_frontend"]
    with pytest.raises(ValueError, match="devices"):
        frontend.dense_frontend_levels([lv[0], lv[1].cpu()])
    out = frontend.dense_frontend_levels(lv)
    assert native.launches["dense_frontend"] == before + 2
    assert len(out) == 17
    for lvl, got in zip(lv, out):
        ref = frontend.dense_frontend_plain(lvl)
        _same(got[0], ref[0])
        _same(got[1], ref[1])
        for g, r in zip(got[2:], ref[2:]):
            assert float((g - r).abs().max()) < 5.0


def test_dense_frontend_rejects_what_the_kernel_does_not_take(dev):
    with pytest.raises(TypeError):
        frontend.dense_frontend(torch.zeros((8, 8), dtype=torch.float64,
                                            device=dev))
    with pytest.raises(ValueError):
        frontend.dense_frontend(torch.zeros((4, 8, 8), device=dev))
    with pytest.raises(ValueError):
        frontend.dense_frontend(torch.zeros((16, 16), device=dev)[:, ::2])


def test_fused_extractor_launches_each_kernel_once_a_frame(dev, rng):
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor
    img = torch.from_numpy(np.round(rng.uniform(0, 255, (480, 752))).astype(
        np.float32)).to(dev)
    before = dict(native.launches)
    f = extractor.extract(img, extractor.OrbConfig())
    # one launch each for all 8 levels
    for name in ("dense_frontend", "cell_topk", "gather_patches"):
        assert native.launches[name] == before[name] + 1
    g = extractor.extract(img.cpu(), extractor.OrbConfig())
    torch.cuda.synchronize()
    same = ((f.xy.cpu() == g.xy).all(1) & (f.valid.cpu() == g.valid))
    assert float(same.float().mean()) >= 0.995
