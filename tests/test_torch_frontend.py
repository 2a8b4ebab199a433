"""The port's fused ORB front end against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode; the port runs the
plain version of its CUDA kernel (``ops/frontend.dense_frontend_plain``).

Tolerances. ``score`` and ``blur`` are exact over the whole image: the score
is subtractions, min and max; the blur adds its taps in the same order and
rounds half to even. The moment maps sum the same values in another order:
within 5.0 absolute on moments of order 1e5 (the JAX test's own tolerance,
``tests/test_frontend.py``), measured 0.25. They are compared 16 pixels
inside the image: in the outermost 15 columns the JAX kernel clamps the
column coordinate inside its weight, the port weights by the plain offset,
and no keypoint lives there (``margin`` 16). Whole extractor at 240x320,
256 features, 4 levels: ``valid`` / ``xy`` / ``level`` equal on all but at
most 1 slot, angles within 1e-3 rad, >= 97 % of descriptors equal (an
angle on a bin boundary may flip its descriptor); measured: all slots and
all descriptors equal, angles within 1.0e-5 rad.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.ops import brief as jbrief
from orb_slam3_detailed_comments_tpu.ops import pallas_frontend
from orb_slam3_detailed_comments_tpu_torch.ops import (
    brief, extractor, frontend, pyramid)

torch.set_num_threads(2)


def synth_image(rng, h, w, n_blobs=120):
    """Textured synthetic image with corner-rich structure, integer-valued."""
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        bh, bw = rng.integers(4, 16), rng.integers(4, 16)
        img[y:y + bh, x:x + bw] = rng.uniform(0, 255)
    img += rng.normal(0, 2.0, size=(h, w)).astype(np.float32)
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    img = synth_image(np.random.default_rng(11), 120, 160)
    ref = [np.asarray(a) for a in pallas_frontend.dense_frontend(
        jnp.asarray(img), interpret=True)]
    got = [a.numpy() for a in frontend.dense_frontend(torch.from_numpy(img))]
    return img, ref, got


@pytest.mark.parametrize("which", [0, 1], ids=["score", "blur"])
def test_score_and_blur_equal_everywhere(maps, which):
    _, ref, got = maps
    assert got[which].shape == ref[which].shape == (120, 160)
    np.testing.assert_array_equal(got[which], ref[which])
    assert np.abs(ref[which]).max() > 0


@pytest.mark.parametrize("which", [2, 3], ids=["m10", "m01"])
def test_moment_maps_within_tolerance(maps, which):
    _, ref, got = maps
    sl = np.s_[16:-16, 16:-16]
    assert np.abs(got[which] - ref[which])[sl].max() < 5.0
    assert np.abs(ref[which])[sl].max() > 1e4
    assert np.isfinite(got[which]).all()


def test_moments_equal_the_patch_form():
    """The dense maps equal the per-keypoint patch moments (the form of the
    default front end) at interior points: angle within 1e-3 rad where the
    moments do not vanish."""
    rng = np.random.default_rng(12)
    img = torch.from_numpy(synth_image(rng, 120, 160))
    _, _, m10, m01 = frontend.dense_frontend(img)
    yx = torch.from_numpy(np.stack([rng.integers(16, 104, 200),
                                    rng.integers(16, 144, 200)], 1)
                          .astype(np.int32))
    raw = brief.extract_patches(img, yx, (120, 160), radius=brief.HALF_PATCH)
    _, _, wx, wy = brief._tables_on(img.device)
    p10, p01 = raw @ wx, raw @ wy
    flat = yx[:, 0].long() * 160 + yx[:, 1].long()
    np.testing.assert_allclose(m10.reshape(-1)[flat].numpy(), p10.numpy(),
                               atol=5.0)
    np.testing.assert_allclose(m01.reshape(-1)[flat].numpy(), p01.numpy(),
                               atol=5.0)
    strong = torch.hypot(p10, p01) >= 5e3
    assert int(strong.sum()) > 50
    d = brief.angle_from_maps(m10, m01, yx) - torch.atan2(p01, p10)
    d = torch.atan2(torch.sin(d), torch.cos(d)).abs()
    assert float(d[strong].max()) < 1e-3


@pytest.mark.parametrize("shape", [(37, 53), (33, 64), (64, 31)])
def test_small_and_constant_images(shape):
    """Shapes below one tile and a constant image: finite maps, zero score
    and zero moments on the constant image."""
    const = torch.full(shape, 77.0)
    score, blur, m10, m01 = frontend.dense_frontend(const)
    assert score.shape == shape
    assert float(score.abs().max()) == 0.0
    np.testing.assert_array_equal(blur.numpy(), np.full(shape, 77.0))
    assert float(m10.abs().max()) < 1e-2 and float(m01.abs().max()) < 1e-2
    rnd = torch.from_numpy(np.round(np.random.default_rng(3).uniform(
        0, 255, shape)).astype(np.float32))
    ref = pallas_frontend.dense_frontend(jnp.asarray(rnd.numpy()),
                                         interpret=True)
    got = frontend.dense_frontend(rnd)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_angle_from_maps_and_extract_patches_match_jax():
    rng = np.random.default_rng(13)
    img = synth_image(rng, 120, 160)
    m10 = rng.normal(0, 1e4, (120, 160)).astype(np.float32)
    m01 = rng.normal(0, 1e4, (120, 160)).astype(np.float32)
    yx = np.stack([rng.integers(-3, 125, 300), rng.integers(-3, 165, 300)],
                  1).astype(np.int32)
    np.testing.assert_allclose(
        brief.angle_from_maps(torch.from_numpy(m10), torch.from_numpy(m01),
                              torch.from_numpy(yx)).numpy(),
        np.asarray(jbrief.angle_from_maps(jnp.asarray(m10), jnp.asarray(m01),
                                          jnp.asarray(yx))), atol=1e-6)
    np.testing.assert_array_equal(
        brief.extract_patches(torch.from_numpy(img), torch.from_numpy(yx),
                              (117, 155)).numpy(),
        np.asarray(jbrief.extract_patches(jnp.asarray(img), jnp.asarray(yx),
                                          (117, 155))))


@pytest.fixture(scope="module")
def extracted():
    img = synth_image(np.random.default_rng(14), 240, 320)
    cfg = dict(n_features=256, n_levels=4)
    f_j = jext._extract_impl(jnp.asarray(img), jext.OrbConfig(**cfg), 240,
                             320, frontend="pallas_interpret")
    # the port's default front end is the fused one
    f_t = extractor.extract(torch.from_numpy(img), extractor.OrbConfig(**cfg))
    f_x = extractor._extract_impl(torch.from_numpy(img),
                                  extractor.OrbConfig(**cfg), 240, 320,
                                  frontend="xla")
    return f_j, f_t, f_x


def test_fused_extractor_matches_jax(extracted):
    f_j, f_t, _ = extracted
    same = ((f_t.xy.numpy() == np.asarray(f_j.xy)).all(1)
            & (f_t.level.numpy() == np.asarray(f_j.level))
            & (f_t.valid.numpy() == np.asarray(f_j.valid)))
    assert (~same).sum() <= 1
    v = same & f_t.valid.numpy()
    assert v.sum() > 200
    dang = np.abs(np.angle(np.exp(1j * (f_t.angle.numpy()[v]
                                        - np.asarray(f_j.angle)[v]))))
    assert dang.max() < 1e-3
    eq = (f_t.desc.numpy().view(np.uint32)[v]
          == np.asarray(f_j.desc)[v]).all(1)
    assert eq.mean() >= 0.97


def test_fused_and_default_front_ends_agree(extracted):
    """Inside the port the fused front end (the default) and the ``"xla"``
    one (the default of the JAX package) select the same keypoints; angles
    within 1e-3 rad, >= 97 % of descriptors equal."""
    _, f_t, f_x = extracted
    np.testing.assert_array_equal(f_t.valid.numpy(), f_x.valid.numpy())
    v = f_x.valid.numpy()
    np.testing.assert_array_equal(f_t.xy.numpy()[v], f_x.xy.numpy()[v])
    np.testing.assert_array_equal(f_t.level.numpy()[v], f_x.level.numpy()[v])
    dang = np.abs(np.angle(np.exp(1j * (f_t.angle.numpy()[v]
                                        - f_x.angle.numpy()[v]))))
    assert dang.max() < 1e-3
    assert (f_t.desc.numpy()[v] == f_x.desc.numpy()[v]).all(1).mean() >= 0.97


def test_default_front_end_is_the_fused_one():
    import inspect
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        kernels, tracking)
    assert extractor.FRONTENDS[0] == "fused"
    for fn in (extractor.extract, extractor._extract_impl,
               kernels.prepare_frame):
        assert inspect.signature(fn).parameters["frontend"].default == "fused"
    assert tracking.TrackingConfig().frontend == "fused"


def test_levels_entry_equals_plain_per_level():
    """``dense_frontend_levels`` on the CPU is the plain version level by
    level, on the level shapes of a 120x160 frame (none a multiple of the
    kernel's 64-pixel tile) and in the order given."""
    img = torch.from_numpy(synth_image(np.random.default_rng(15), 120, 160))
    levels = pyramid.build_pyramid(img, 4, 1.2)
    out = frontend.dense_frontend_levels(levels)
    assert len(out) == 4
    for lvl, maps in zip(levels, out):
        ref = frontend.dense_frontend_plain(lvl)
        assert len(maps) == 4
        for g, r in zip(maps, ref):
            assert g.shape == lvl.shape
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    one = frontend.dense_frontend(levels[2])
    for g, r in zip(one, out[2]):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert frontend.dense_frontend_levels([]) == []


def test_levels_entry_rejects_what_the_kernel_does_not_take():
    """More levels than the kernel's table holds are taken (on the card one
    launch a table): 17 integer-valued level images, 240x320 down by 1.1
    a level, equal the JAX kernel's maps level by level (score and blur exactly, the moments within 5.0, 16
    pixels in, where both weight alike; tests/test_torch_cuda.py holds the
    card's two launches against the plain version). Levels on different
    devices still raise."""
    n = frontend.MAX_LEVELS + 1
    rng = np.random.default_rng(17)
    lv = [torch.from_numpy(synth_image(rng, int(240 / 1.1 ** l),
                                       int(320 / 1.1 ** l), n_blobs=40))
          for l in range(n)]
    out = frontend.dense_frontend_levels(lv)
    assert len(out) == n
    for lvl, maps in zip(lv, out):
        for g, r in zip(maps, frontend.dense_frontend_plain(lvl)):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
        ref = [np.asarray(a) for a in pallas_frontend.dense_frontend(
            jnp.asarray(lvl.numpy()), interpret=True)]
        np.testing.assert_array_equal(maps[0].numpy(), ref[0])
        # the blur's half-to-even rounding: 1 pixel of these 17 images
        # (4 of 600k pixels in all) sits on a tie that the two packages
        # sum to either side
        d = np.abs(maps[1].numpy() - ref[1])
        assert d.max() <= 1.0 and (d > 0).sum() <= 1
        if min(lvl.shape) > 40:
            for g, r in zip(maps[2:], ref[2:]):
                assert np.abs(g.numpy()[16:-16, 16:-16]
                              - r[16:-16, 16:-16]).max() < 5.0
    with pytest.raises(ValueError, match="devices"):
        frontend.dense_frontend_levels(
            [torch.zeros((8, 8)), torch.zeros((8, 8), device="meta")])


def test_fused_extractor_calls_the_levels_entry_once(monkeypatch):
    calls = []
    real = frontend.dense_frontend_levels
    monkeypatch.setattr(frontend, "dense_frontend_levels",
                        lambda lv: calls.append(len(lv)) or real(lv))
    img = torch.from_numpy(synth_image(np.random.default_rng(16), 120, 160))
    extractor.extract(img, extractor.OrbConfig(n_features=128, n_levels=3))
    assert calls == [3]
    extractor.extract(img, extractor.OrbConfig(n_features=128, n_levels=3),
                      "xla")
    assert calls == [3]


def test_unknown_front_end_raises():
    with pytest.raises(ValueError, match="frontend"):
        extractor.extract(torch.zeros((64, 64)), frontend="pallas")


def test_level_shapes_are_the_kernel_shapes():
    """The fused front end is called on the padded level shapes; most
    widths are no multiple of the kernel's 64-pixel tile."""
    shapes = pyramid.level_shapes(480, 752)
    assert shapes[0] == (480, 752) and len(shapes) == 8
    assert sum(w % 64 != 0 for _, w in shapes) >= 5
    assert list(frontend._U_MAX) == list(jbrief._U_MAX)
    # the 709 taps of the circular patch
    assert sum(2 * int(frontend._U_MAX[abs(d)]) + 1
               for d in range(-15, 16)) == 709
