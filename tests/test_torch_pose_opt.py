"""The port's motion-only pose optimization against the JAX package's.

The port replaces the JAX version's early-exit while_loop by a sticky done
flag on the device (no host sync per iteration); the result must be the
same. Tolerance: pose within 1e-4 (rotation entries and translation in
metres), inlier masks equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.optim import pose_opt as jpo
from orb_slam3_detailed_comments_tpu_torch.lie import SE3, so3
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.optim import pose_opt, reproj

torch.set_num_threads(2)

KW = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752,
          height=480, k1=-0.28340811, k2=0.07395907, p1=0.00019359,
          p2=1.76187114e-05)


def _problem(seed, M=400, outliers=0.15, noise=0.7):
    rng = np.random.default_rng(seed)
    cam = cameras.pinhole(**KW)
    R = so3.exp(torch.tensor([0.05, -0.1, 0.02])).numpy()
    t = np.array([0.1, -0.05, 0.3], np.float32)
    X = np.concatenate([rng.uniform(-3, 3, (M, 2)), rng.uniform(3, 9, (M, 1))],
                       1).astype(np.float32)
    Xw = ((X - t) @ R).astype(np.float32)        # camera -> world
    uv = cameras.project(cam, torch.from_numpy(X)).numpy()
    uv = uv + rng.normal(0, noise, uv.shape)
    bad = rng.uniform(size=M) < outliers
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    uv = uv.astype(np.float32)
    level = rng.integers(0, 8, M)
    inv_s2 = (1.0 / 1.2 ** (2 * level)).astype(np.float32)
    valid = rng.uniform(size=M) < 0.95
    dR = so3.exp(torch.tensor([0.01, 0.02, -0.015])).numpy()
    R0 = (dR @ R).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.04])).astype(np.float32)
    return cam, R0, t0, Xw, uv, inv_s2, valid, R, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization_matches_jax(seed):
    cam, R0, t0, Xw, uv, w, valid, R, t = _problem(seed)
    ref = jpo.pose_optimization(JSE3(jnp.asarray(R0), jnp.asarray(t0)),
                                jnp.asarray(Xw), jnp.asarray(uv),
                                jnp.asarray(w), jnp.asarray(valid),
                                jcam.pinhole(**KW))
    f = torch.from_numpy
    got = pose_opt.pose_optimization(SE3(f(R0), f(t0)), f(Xw), f(uv), f(w),
                                     f(valid), cam)
    np.testing.assert_allclose(got.T_cw.R.numpy(), np.asarray(ref.T_cw.R),
                               atol=1e-4)
    np.testing.assert_allclose(got.T_cw.t.numpy(), np.asarray(ref.T_cw.t),
                               atol=1e-4)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    assert int(got.n_inliers) == int(ref.n_inliers)
    # and it really solved the problem
    assert np.abs(got.T_cw.t.numpy() - t).max() < 0.01


def test_huber_weight():
    chi2 = torch.tensor([0.0, 5.991, 6.0, 100.0])
    w = reproj.huber_weight(chi2, reproj.CHI2_MONO).numpy()
    np.testing.assert_allclose(w, [1.0, 1.0, np.sqrt(5.991 / 6.0),
                                   np.sqrt(5.991 / 100.0)], rtol=1e-6)
