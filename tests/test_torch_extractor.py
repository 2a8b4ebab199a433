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
