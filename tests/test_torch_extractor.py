"""The port's ORB extractor against the JAX package's, on rendered frames,
both on the ``"xla"`` front end (JAX's default path; the port's default,
``"fused"``, is held to JAX's fused path in ``tests/test_torch_frontend.py``).

Exact where the arithmetic is exact: FAST scores and NMS (min/max), the
rBRIEF pattern and its rotated tables, the descriptor of given patches and
angles (integer differences), the per-cell selection (ties first-index).
Toleranced where float sums are taken in another order: the pyramid's
interpolation products (1e-3 in 0..255 intensities), and the orientation
moments (angle within 1e-4 rad). A keypoint whose angle sits on one of the
30 bin boundaries may then land in the other bin and change its descriptor;
on the frames here every slot's angle bin agreed. Whole-frame tolerance:
xy / level / valid equal on >= 99.5% of slots. Measured with torch 2.x on
the CPU: 1 of 512 slots differs on each of the two frames, the largest
angle difference is 3.4e-6 rad, and no descriptor differs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.ops import brief as jbrief
from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.ops import fast as jfast
from orb_slam3_detailed_comments_tpu.ops import pyramid as jpyr
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import brief, extractor, fast, pyramid
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM = cameras.pinhole(229.0, 228.5, 188.0, 120.0, 376, 240)


@pytest.fixture(scope="module")
def frames():
    planes = synth_render.default_world(np.random.default_rng(3))
    R, t = synth_render.orbit_trajectory(40)
    return [synth_render.render_frame_raycast(CAM, planes, R[i], t[i])[0]
            for i in (0, 25)]


def test_pattern_and_tables_bit_identical():
    np.testing.assert_array_equal(brief._make_pattern(31), jbrief.PATTERN)
    np.testing.assert_array_equal(brief._make_bin_patterns(),
                                  jbrief._BIN_PATTERNS)
    np.testing.assert_array_equal(brief._WX, jbrief._WX)
    np.testing.assert_array_equal(brief._WY, jbrief._WY)


def test_pyramid_blur_fast_nms(frames):
    img = frames[0]
    lv_t = pyramid.build_pyramid(torch.from_numpy(img))
    lv_j = jpyr.build_pyramid(jnp.asarray(img))
    assert [tuple(a.shape) for a in lv_t] == [a.shape for a in lv_j]
    for a, b in zip(lv_t, lv_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    # from the same level image, blur / FAST / NMS agree
    for lvl in (np.asarray(lv_j[0]), np.asarray(lv_j[3])):
        x = torch.from_numpy(lvl.copy())
        np.testing.assert_allclose(pyramid.gaussian_blur(x).numpy(),
                                   np.asarray(jpyr.gaussian_blur(lvl)),
                                   atol=1e-4)
        s = fast.fast_score(x)
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(jfast.fast_score(lvl)))
        np.testing.assert_array_equal(fast.nms3x3(s).numpy(),
                                      np.asarray(jfast.nms3x3(s.numpy())))


def test_select_grid_topk_exact(frames):
    lvl = np.asarray(jpyr.build_pyramid(jnp.asarray(frames[0]))[1])
    sc = np.asarray(jfast.nms3x3(jfast.fast_score(lvl)))
    k_t = fast.select_from_nms_score(torch.from_numpy(sc), (200, 313), 148,
                                     k_per_cell=8)
    k_j = jfast.select_from_nms_score(jnp.asarray(sc), (200, 313), 148,
                                      k_per_cell=8)
    for a, b in zip(k_t, k_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_describe_patches_exact_and_angle_close(rng):
    blur = np.round(rng.uniform(0, 255, (300, brief.PATCH_W ** 2))
                    ).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ref = np.asarray(jbrief.describe_patches(jnp.asarray(blur),
                                             jnp.asarray(ang)))
    got = brief.describe_patches(torch.from_numpy(blur), torch.from_numpy(ang))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    raw = rng.uniform(0, 255, (300, 31 * 31)).astype(np.float32)
    np.testing.assert_allclose(
        brief.ic_angle_patches(torch.from_numpy(raw)).numpy(),
        np.asarray(jbrief.ic_angle_patches(jnp.asarray(raw))), atol=1e-4)


@pytest.mark.parametrize("which", [0, 1])
def test_extract_matches_jax(frames, which):
    cfg_t = extractor.OrbConfig(n_features=512)
    cfg_j = jext.OrbConfig(n_features=512)
    assert tuple(cfg_t) == tuple(cfg_j)
    img = frames[which]
    f_t = extractor.extract(torch.from_numpy(img), cfg_t, frontend="xla")
    f_j = jext._extract_impl(jnp.asarray(img), cfg_j, *img.shape,
                             frontend="xla")
    same = ((f_t.xy.numpy() == np.asarray(f_j.xy)).all(1)
            & (f_t.level.numpy() == np.asarray(f_j.level))
            & (f_t.valid.numpy() == np.asarray(f_j.valid)))
    assert same.mean() >= 0.995, f"{(~same).sum()} of {len(same)} slots differ"
    assert int(f_t.valid.sum()) > 400
    s = same & f_t.valid.numpy()
    ang_t, ang_j = f_t.angle.numpy()[s], np.asarray(f_j.angle)[s]
    dang = np.abs(np.angle(np.exp(1j * (ang_t - ang_j))))
    assert dang.max() < 1e-4
    bins_same = (brief.angle_bin(torch.from_numpy(ang_t)).numpy()
                 == np.asarray(jbrief.angle_bin(jnp.asarray(ang_j))))
    desc_t = f_t.desc.numpy().view(np.uint32)[s]
    desc_j = np.asarray(f_j.desc)[s]
    np.testing.assert_array_equal(desc_t[bins_same], desc_j[bins_same])
    assert bins_same.mean() >= 0.99


def _resize_mm(img, nh, nw):
    """The pyramid's former resize: two interpolation-matrix products,
    whose two-term row sums the CPU and the card's BLAS round in other
    orders."""
    rh = torch.from_numpy(pyramid._resize_matrix(nh, img.shape[0]))
    rw = torch.from_numpy(pyramid._resize_matrix(nw, img.shape[1]))
    return (rh @ img) @ rw.T


def _exact(x):
    return x == x.astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("shape", [(400, 627), (333, 522), (200, 313),
                                   (120, 188)],
                         ids=["480->400", "480->333", "240->200", "2:1"])
def test_fixed_order_resize_equals_the_matrix_form_where_exact(shape):
    """``resize_bilinear`` (two taps per output, in a fixed order of
    separately rounded operations) against torch's matrix-product form on
    the CPU: bit-equal wherever the matrix form's two-tap sums are exact
    (every row sum and column sum exactly representable in float32; all of
    the dyadic 2:1 downsize), and measured bit-equal on every pixel of
    these four resizes (torch's CPU BLAS adds the low tap's rounded
    product and the high tap's product with one rounding, as
    ``_two_tap`` does). The JAX package's matrix form on XLA-CPU rounds
    some passes otherwise, by the dot's shape:
    ``test_resize_parts_from_xla_cpu_only_by_the_two_tap_rounding``."""
    rng = np.random.default_rng(31)
    src = (480, 752) if shape[0] > 300 else (240, 376)
    img = np.round(rng.uniform(0, 255, src)).astype(np.float32)
    nh, nw = shape
    new = pyramid.resize_bilinear(torch.from_numpy(img), nh, nw).numpy()
    old = _resize_mm(torch.from_numpy(img), nh, nw).numpy()
    rh = pyramid._resize_matrix(nh, src[0]).astype(np.float64)
    rw = pyramid._resize_matrix(nw, src[1]).astype(np.float64)
    rows = rh @ img.astype(np.float64)
    full = rows.astype(np.float32).astype(np.float64) @ rw.T
    reads = rw != 0
    ok = _exact(full) & (~reads[None, :, :] | _exact(rows)[:, None, :]).all(2)
    if shape == (120, 188):
        assert ok.all()
    assert ok.sum() >= 20
    np.testing.assert_array_equal(new[ok], old[ok])
    np.testing.assert_array_equal(new, old)


def _two_tap_forms(a, b, w_lo, w_hi):
    """The three roundings of w_lo a + w_hi b in float32: a fused
    multiply-add with the low tap's rounded product first, one with the
    high tap's first, and two rounded products added."""
    p_lo, p_hi = (a * w_lo).astype(np.float32), (b * w_hi).astype(np.float32)
    f64 = lambda x: x.astype(np.float64)
    return ((f64(p_lo) + f64(b) * f64(w_hi)).astype(np.float32),
            (f64(p_hi) + f64(a) * f64(w_lo)).astype(np.float32),
            (p_lo + p_hi).astype(np.float32))


@pytest.mark.parametrize("base", [(480, 752), (240, 376)],
                         ids=["752x480", "376x240"])
def test_resize_parts_from_xla_cpu_only_by_the_two_tap_rounding(base):
    """The seven resizes of a pyramid, each pass on the same input in both
    packages (the vertical pass on the port's previous level, the
    horizontal pass on the port's vertical result; JAX's
    ``resize_bilinear_mm`` with an identity for the other pass): at every
    output the JAX package's value is one of the three roundings of the
    same two taps (``_two_tap_forms``), and the port's is the first, a
    fused multiply-add with the low tap first, on every device.

    XLA-CPU picks the rounding by the dot's shape. Measured on a random
    integer 752x480 image: 480x752 -> 400x627 vertically two roundings
    (the fused form parts from it on 11.8 % of the outputs), horizontally
    the fused low-first form but on 0.002 %; 400x627 -> 333x522 and
    278x435 -> 231x363 the fused form vertically and two roundings
    horizontally; 333x522 -> 278x435 and 231x363 -> 193x302 two roundings
    vertically; at 376x240, 240x376 -> 200x313 the fused form in both
    passes (0 apart). So every level past the first parts from JAX's by
    1-3 float32 ulps at some pixels, which can move a FAST knife-edge: an
    emitter choice of one CPU build, not the resize's semantics; the port
    keeps one rounding on the CPU and the card instead."""
    rng = np.random.default_rng(5)
    H, W = base
    cur = torch.from_numpy(np.round(rng.uniform(0, 255, base))
                           .astype(np.float32))
    parted = []
    for lv in range(1, 8):
        nh, nw = int(round(H / 1.2 ** lv)), int(round(W / 1.2 ** lv))
        ch, cw = cur.shape
        x = cur.numpy()
        lo, hi, wl, wh = (t.numpy() for t in pyramid._taps_on(
            nh, ch, torch.device("cpu")))
        fused, _, _ = forms = _two_tap_forms(x[lo], x[hi], wl[:, None],
                                             wh[:, None])
        jax_v = np.asarray(jpyr.resize_bilinear_mm(jnp.asarray(x), nh, cw))
        assert np.logical_or.reduce([jax_v == f for f in forms]).all()
        rows = pyramid._two_tap(cur[lo], cur[hi],
                                torch.from_numpy(wl)[:, None],
                                torch.from_numpy(wh)[:, None])
        np.testing.assert_array_equal(rows.numpy(), fused)
        lo, hi, wl, wh = (t.numpy() for t in pyramid._taps_on(
            nw, cw, torch.device("cpu")))
        r = rows.numpy()
        fused, _, _ = forms = _two_tap_forms(r[:, lo], r[:, hi],
                                             wl[None, :], wh[None, :])
        jax_h = np.asarray(jpyr.resize_bilinear_mm(jnp.asarray(r), nh, nw))
        assert np.logical_or.reduce([jax_h == f for f in forms]).all()
        cur = pyramid.resize_bilinear(cur, nh, nw)
        np.testing.assert_array_equal(cur.numpy(), fused)
        parted.append(float((jax_v != rows.numpy()).mean()))
    if base == (480, 752):
        # the first resize's vertical pass: two roundings in JAX's dot
        assert parted[0] > 0.05
