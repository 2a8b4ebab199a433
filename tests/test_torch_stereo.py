"""The port's stereo and RGB-D frame programs against the JAX package's, on
the CPU at 376x240 (fx 229) with 512 features.

The JAX functions run as the JAX package's own tests run them on the CPU:
their SAD windows come from ``pallas_patches.gather_patches``, which takes
the ``gather_patches_atlas_xla`` path off the TPU.

The rectified and RGB-D programs are held on the JAX package's features,
handed to the port's ``prepare_frame`` and ``extract`` (the two
extractors are not bit-identical: ``test_torch_extractor.py``), so that
what is compared is the matching and the depth; the fisheye program runs
each package's own extractor.

Tolerances: ``stereo_match``'s valid sets equal on >= 99 % of the rows,
``u_right`` within 1e-3 px and depth within 1e-4 relative where both are
valid (the SADs are sums of 121 absolute differences, summed in another
order); ``epipolar_sad_refine``'s ok sets equal on >= 99 %, the slide
within 1e-3 px on >= 99 % of the rows both keep (two SADs within
summation noise of each other may pick neighbouring slides);
``prepare_frame_rgbd`` exact; ``prepare_frame_stereo_fisheye``'s matched
``idx`` equal on >= 99 % of the features either package matched, depth
within 1e-3 relative or, for points past ~1 km, inverse depth within 1e-6
per metre (there the float32 DLT's homogeneous w is at its rounding floor
in both packages).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.ops import stereo as jstereo
from orb_slam3_detailed_comments_tpu.pipeline import kernels as jk
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor, stereo
from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

torch.set_num_threads(2)

CAM_KW = dict(fx=229.0, fy=228.5, cx=188.0, cy=120.0, width=376, height=240)
CAM, JCAM = cameras.pinhole(**CAM_KW), jcam.pinhole(**CAM_KW)
KB8_KW = dict(fx=190.0, fy=190.0, cx=188.0, cy=120.0, width=376, height=240,
              k1=0.0034, k2=0.0008, k3=-0.0007, k4=0.0001)
BASELINE = 0.11
BF = BASELINE * CAM.fx
MIN_Z = max(BF / CAM.fx * 2.0, 0.3)
ORB, JORB = extractor.OrbConfig(n_features=512), jext.OrbConfig(n_features=512)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _feat(f):
    return extractor.FrameFeatures(*(_t(a) for a in f))


@pytest.fixture
def shared_extraction(monkeypatch, pair):
    """The port's prepare_frame and extract return the JAX package's
    features of the pair's images."""
    jp, fr = pair["prep"], pair["feat_r"]
    left = torch.from_numpy(pair["left"])

    def prepare_frame(img, cam, cfg, frontend="fused"):
        assert torch.equal(img, left)
        return kernels.PreparedFrame(_feat(jp.feat), _t(jp.xy_ud),
                                     _t(jp.xyn))

    def extract(img, cfg, frontend="fused"):
        assert torch.equal(img, torch.from_numpy(pair["right"]))
        return _feat(fr)

    monkeypatch.setattr(kernels, "prepare_frame", prepare_frame)
    monkeypatch.setattr(extractor, "extract", extract)


@pytest.fixture(scope="module")
def pair():
    planes = synth_render.default_world(np.random.default_rng(9))
    R, t = synth_render.orbit_trajectory(40)
    left, right = synth_render.render_stereo_pair(CAM, planes, R[0], t[0],
                                                  BASELINE)
    prep = jk.prepare_frame(jnp.asarray(left), JCAM, JORB)
    feat_r = jext.extract(jnp.asarray(right), JORB)
    return dict(left=left, right=right, prep=prep, feat_r=feat_r,
                planes=planes, R=R, t=t)


def _match_args(p, rows=slice(None)):
    """stereo_match's arguments for both packages from the JAX features."""
    f, r = p["prep"].feat, p["feat_r"]
    j = (p["prep"].xy_ud[rows], f.level[rows], f.desc[rows], f.valid[rows],
         r.xy, r.level, r.desc, r.valid, jnp.asarray(p["left"]),
         jnp.asarray(p["right"]))
    return j, tuple(_t(a) for a in j)


def _agree(jm, tm, min_valid=200):
    vj, vt = np.array(jm.valid), tm.valid.numpy()
    assert vj.sum() > min_valid
    assert (vj == vt).mean() >= 0.99
    both = vj & vt
    np.testing.assert_allclose(tm.u_right.numpy()[both],
                               np.array(jm.u_right)[both], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.depth.numpy()[both],
                               np.array(jm.depth)[both], rtol=1e-4)
    return vj, vt


def test_stereo_match_matches_jax(pair):
    j, t = _match_args(pair)
    jm = jstereo.stereo_match(*j, BF, min_z=MIN_Z)
    tm = stereo.stereo_match(*t, BF, min_z=MIN_Z)
    vj, vt = _agree(jm, tm)
    # a row that is not ok enters the JAX median as NaN, so the median is
    # NaN and the SAD cut keeps every coarse match: the port must not cut
    # either
    assert not vj.all()
    np.testing.assert_array_equal(vt, vj)


def test_sad_cut_fires_when_every_row_is_ok(pair):
    """Only the rows that matched, an even number of them: no NaN enters
    the median, which is then the mean of the two middle SADs, and the
    2.1 x median cut drops rows in both packages alike."""
    j, t = _match_args(pair)
    ok = np.array(jstereo.stereo_match(*j, BF, min_z=MIN_Z).valid)
    rows = np.where(ok)[0]
    rows = rows[:len(rows) // 2 * 2]
    j, t = _match_args(pair, rows)
    jm = jstereo.stereo_match(*j, BF, min_z=MIN_Z)
    tm = stereo.stereo_match(*t, BF, min_z=MIN_Z)
    vj, vt = _agree(jm, tm, min_valid=100)
    assert vj.sum() < len(rows), "the cut should drop some rows"
    np.testing.assert_array_equal(vt, vj)


@pytest.mark.parametrize("x", [
    [1.0, np.nan, 3.0, 2.0], [1.0, 4.0, 3.0, 2.0], [5.0, 1.0, 3.0],
    [7.25], list(np.random.default_rng(0).uniform(0, 900, 64))])
def test_nan_median_is_jnp_median(x):
    x = np.asarray(x, np.float32)
    got = stereo.nan_median(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.array(jnp.median(jnp.asarray(x))))


def test_epipolar_sad_refine_matches_jax(pair):
    """The same keypoints, slide directions and masks in both packages:
    right keypoints 0.7 px off their left ones along a tilted direction."""
    rng = np.random.default_rng(4)
    xy_l = np.array(pair["prep"].feat.xy)
    n = xy_l.shape[0]
    ang = rng.uniform(-0.3, 0.3, n)
    e_dir = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    xy_r = (xy_l - 12.0 * e_dir + rng.normal(0, 0.7, (n, 2))).astype(
        np.float32)
    valid = np.array(pair["prep"].feat.valid) & (rng.uniform(size=n) < 0.9)
    args = (pair["left"], pair["left"], xy_l, xy_r, e_dir, valid)
    dj, okj = (np.array(a) for a in jstereo.epipolar_sad_refine(
        *(jnp.asarray(a) for a in args)))
    dt, okt = (a.numpy() for a in stereo.epipolar_sad_refine(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
    assert okj.sum() > 100
    assert (okj == okt).mean() >= 0.99
    both = okj & okt
    assert (np.abs(dt[both] - dj[both]) <= 1e-3).mean() >= 0.99


def test_prepare_frame_stereo_matches_jax(pair, shared_extraction):
    """The rectified program on the shared features against the JAX
    matcher called as the JAX program calls it (min_z = max(2 baselines,
    0.3 m), the left keypoints undistorted, the right ones raw)."""
    j, _ = _match_args(pair)
    jm = jstereo.stereo_match(*j, BF, min_z=MIN_Z, n_levels=8, scale=1.2)
    _, td, tu = kernels.prepare_frame_stereo(
        torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"]), CAM,
        BF, ORB)
    vj, vt = np.array(jm.depth) > 0, td.numpy() > 0
    assert vj.sum() > 200
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(td.numpy(), np.array(jm.depth), rtol=1e-4)
    np.testing.assert_allclose(tu.numpy(), np.array(jm.u_right), rtol=0,
                               atol=1e-3)


def test_prepare_frame_rgbd_exact(pair, shared_extraction):
    depth = synth_render.render_depth(CAM, pair["planes"], pair["R"][0],
                                      pair["t"][0])
    depth[::7, ::5] = 0.0                  # holes, as a depth camera has
    depth[100:110, 50:60] = 0.03           # and returns below 5 cm
    jp, jz, ju = jk.prepare_frame_rgbd(jnp.asarray(pair["left"]),
                                       jnp.asarray(depth), JCAM, BF, JORB)
    _, tz, tu = kernels.prepare_frame_rgbd(
        torch.from_numpy(pair["left"]), torch.from_numpy(depth), CAM, BF, ORB)
    assert (np.array(jz) > 0).sum() > 300 and (np.array(jz) == 0).sum() > 10
    np.testing.assert_array_equal(tz.numpy(), np.array(jz))
    np.testing.assert_array_equal(tu.numpy(), np.array(ju))


def test_prepare_frame_stereo_fisheye_matches_jax():
    cam, jc = cameras.fisheye_kb8(**KB8_KW), jcam.fisheye_kb8(**KB8_KW)
    planes = synth_render.default_world(np.random.default_rng(17))
    R, t = synth_render.orbit_trajectory(40)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -BASELINE                 # right camera at +x of the left
    left = synth_render.render_frame_raycast(cam, planes, R[0], t[0])[0]
    right = synth_render.render_frame_raycast(
        cam, planes, R[0], (t[0] + T_rl[:3, 3]).astype(np.float32))[0]
    _, jd, ji = jk.prepare_frame_stereo_fisheye(
        jnp.asarray(left), jnp.asarray(right), jc, jc,
        jnp.asarray(T_rl[:3, :3]), jnp.asarray(T_rl[:3, 3]), JORB)
    _, td, ti = kernels.prepare_frame_stereo_fisheye(
        torch.from_numpy(left), torch.from_numpy(right), cam, cam,
        torch.from_numpy(T_rl[:3, :3]), torch.from_numpy(T_rl[:3, 3]), ORB,
        frontend="xla")
    jd, ji, td, ti = np.array(jd), np.array(ji), td.numpy(), ti.numpy()
    vj, vt = jd > 0, td > 0
    assert vj.sum() > 150 and (vj == vt).mean() >= 0.99
    either = vj | vt
    assert (ji[either] == ti[either]).mean() >= 0.99
    both = vj & vt
    rel = np.abs(td[both] - jd[both]) / jd[both]
    inv = np.abs(1.0 / td[both] - 1.0 / jd[both])
    assert ((rel < 1e-3) | (inv < 1e-6)).all(), (rel.max(), inv.max())


def test_render_depth_is_the_hit_z(pair):
    """render_depth is the camera-frame z of each pixel's ray-cast hit, 0
    where the ray misses; render_stereo_pair's right image is the frame
    rendered one baseline along the camera's +x."""
    planes, R, t = pair["planes"], pair["R"][3], pair["t"][3]
    depth = synth_render.render_depth(CAM, planes, R, t)
    rng = np.random.default_rng(1)
    uv = np.stack([rng.integers(0, 376, 500), rng.integers(0, 240, 500)],
                  1).astype(np.float64)
    _, X, hit = synth_render.raycast(CAM, planes, R, t, uv)
    z = (X @ R.T.astype(np.float64) + t)[:, 2]
    got = depth[uv[:, 1].astype(int), uv[:, 0].astype(int)]
    np.testing.assert_allclose(got[hit], z[hit], rtol=1e-6)
    assert (got[~hit] == 0).all() and hit.mean() > 0.9
    # the direction of the shift: the back wall moves left in the right eye
    _, right = synth_render.render_stereo_pair(CAM, planes, R, t, BASELINE)
    t_r = t - np.array([BASELINE, 0, 0], np.float32)
    ref = synth_render.render_frame_raycast(CAM, planes, R, t_r)[0]
    np.testing.assert_allclose(right, ref, rtol=0, atol=1e-3)


def test_kb8_pose_jacobian_keeps_the_points_dtype():
    """The fisheye rig's pose optimisation multiplies the KB8 Jacobian
    with float32 residuals: the Jacobian must be float32 too, and equal
    the JAX package's jacfwd."""
    cam, jc = cameras.fisheye_kb8(**KB8_KW), jcam.fisheye_kb8(**KB8_KW)
    X = np.random.default_rng(2).uniform([-1, -1, 2], [1, 1, 6],
                                         (50, 3)).astype(np.float32)
    J = cameras.project_jac(cam, torch.from_numpy(X))
    assert J.dtype == torch.float32
    ref = np.array(jax.vmap(jax.jacfwd(lambda p: jcam.project(jc, p)))(
        jnp.asarray(X)))
    np.testing.assert_allclose(J.numpy(), ref, rtol=1e-4, atol=1e-3)
