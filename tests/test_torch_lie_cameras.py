"""The port's SO(3)/SE(3) and camera models against the JAX package.

Same numpy inputs (seeded) through both. Tolerances: 1e-5 on rotations,
translations, rays and Jacobian entries relative to their scale; 1e-3 px on
projections.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3, se3 as jse3, so3 as jso3
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu_torch.lie import SE3, se3, so3
from orb_slam3_detailed_comments_tpu_torch.models import cameras

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rotvecs(rng, n):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[0] = 0.0                                   # identity
    w[1] = [1e-5, -2e-5, 3e-6]                   # Taylor branch
    w[2] = [np.pi - 1e-4, 0.0, 0.0]              # near pi
    w[3] = [0.0, 3.1, 0.2]
    return w


def test_so3_exp_log_hat(rng):
    w = _rotvecs(rng, 64)
    R = so3.exp(_t(w)).numpy()
    np.testing.assert_allclose(R, np.asarray(jso3.exp(jnp.asarray(w))),
                               atol=1e-5)
    np.testing.assert_allclose(so3.log(_t(R)).numpy(),
                               np.asarray(jso3.log(jnp.asarray(R))),
                               atol=1e-4)
    np.testing.assert_array_equal(so3.hat(_t(w)).numpy(),
                                  np.asarray(jso3.hat(jnp.asarray(w))))
    np.testing.assert_allclose(so3.left_jacobian(_t(w)).numpy(),
                               np.asarray(jso3.left_jacobian(jnp.asarray(w))),
                               atol=1e-5)


def test_se3_ops(rng):
    xi = rng.normal(scale=0.5, size=(16, 6)).astype(np.float32)
    xj = rng.normal(scale=0.5, size=(16, 6)).astype(np.float32)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    A, B = se3.exp(_t(xi)), se3.exp(_t(xj))
    JA, JB = jse3.exp(jnp.asarray(xi)), jse3.exp(jnp.asarray(xj))
    for mine, ref in ((A, JA), (A.compose(B), JA.compose(JB)),
                      (A.inverse(), JA.inverse()),
                      (A.normalized(), JA.normalized())):
        np.testing.assert_allclose(mine.R.numpy(), np.asarray(ref.R), atol=1e-5)
        np.testing.assert_allclose(mine.t.numpy(), np.asarray(ref.t), atol=1e-5)
    np.testing.assert_allclose(A.apply(_t(x)).numpy(),
                               np.asarray(JA.apply(jnp.asarray(x))), atol=1e-5)
    I = SE3.identity((2,))
    assert I.R.shape == (2, 3, 3) and float(I.t.abs().sum()) == 0.0


CAMS = [
    ("pinhole", dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752,
                     height=480)),
    ("pinhole", dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                     width=752, height=480, k1=-0.28340811, k2=0.07395907,
                     p1=0.00019359, p2=1.76187114e-05)),
    ("fisheye_kb8", dict(fx=190.97, fy=190.97, cx=254.93, cy=256.90,
                         width=512, height=512, k1=0.0034823894,
                         k2=0.000715034, k3=-0.0020532361,
                         k4=0.00020293673)),
]


@pytest.mark.parametrize("kind,kw", CAMS)
def test_camera_models(rng, kind, kw):
    cam = getattr(cameras, kind)(**kw)
    jc = getattr(jcam, kind)(**kw)
    assert tuple(cam) == tuple(jc)
    pc = np.concatenate([rng.uniform(-2, 2, (256, 2)),
                         rng.uniform(1.0, 8.0, (256, 1))], 1).astype(np.float32)
    uv = cameras.project(cam, _t(pc)).numpy()
    np.testing.assert_allclose(uv, np.asarray(jcam.project(jc, jnp.asarray(pc))),
                               atol=1e-3)
    pix = np.stack([rng.uniform(0, cam.width, 256),
                    rng.uniform(0, cam.height, 256)], 1).astype(np.float32)
    for name in ("unproject", "unproject_bearing"):
        np.testing.assert_allclose(
            getattr(cameras, name)(cam, _t(pix)).numpy(),
            np.asarray(getattr(jcam, name)(jc, jnp.asarray(pix))),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        cameras.undistort_points(cam, _t(pix)).numpy(),
        np.asarray(jcam.undistort_points(jc, jnp.asarray(pix))), atol=1e-3)
    np.testing.assert_array_equal(
        cameras.in_image(cam, _t(uv), 3.0).numpy(),
        np.asarray(jcam.in_image(jc, jnp.asarray(uv), 3.0)))
    J = cameras.project_jac(cam, _t(pc)).numpy()
    Jr = np.asarray(jcam.project_jac(jc, jnp.asarray(pc)))
    np.testing.assert_allclose(J, Jr, rtol=1e-5, atol=1e-5 * np.abs(Jr).max())
