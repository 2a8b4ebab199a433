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

import chip_smoke
from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.optim import pose_opt as jpo
from orb_slam3_detailed_comments_tpu_torch import native
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


def test_cpu_dispatch_takes_the_twin():
    """On the CPU pose_optimization is the plain twin, bit for bit, and
    launches nothing."""
    native.reset_launches()
    cam, R0, t0, Xw, uv, w, valid, _, _ = _problem(4)
    f = torch.from_numpy
    args = (SE3(f(R0), f(t0)), f(Xw), f(uv), f(w), f(valid), cam)
    got = pose_opt.pose_optimization(*args)
    ref = pose_opt.pose_optimization_plain(*args)
    for a, b in zip((got.T_cw.R, got.T_cw.t, got.inlier, got.n_inliers),
                    (ref.T_cw.R, ref.T_cw.t, ref.inlier, ref.n_inliers)):
        assert torch.equal(a, b)
    assert native.launches["pose_gn"] == 0


@pytest.mark.parametrize("kind", ["radtan", "kb8"])
def test_batch_on_cpu_equals_single_solves(kind):
    """pose_optimization_batch on the CPU (the twin under vmap) gives each
    frame's own solve."""
    cam = (cameras.pinhole(**KW) if kind == "radtan"
           else cameras.fisheye_kb8(**chip_smoke.KB8_KW))
    rng = np.random.default_rng(11)
    cases = [chip_smoke.pose_problem(rng, cam, 150)[:6] for _ in range(3)]
    R0, t0, X, uv, w, valid = (torch.from_numpy(np.stack(a))
                               for a in zip(*cases))
    got = pose_opt.pose_optimization_batch(SE3(R0, t0), X, uv, w, valid, cam)
    for f in range(3):
        one = pose_opt.pose_optimization(SE3(R0[f], t0[f]), X[f], uv[f],
                                         w[f], valid[f], cam)
        np.testing.assert_allclose(got.T_cw.R[f].numpy(),
                                   one.T_cw.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(got.T_cw.t[f].numpy(),
                                   one.T_cw.t.numpy(), atol=1e-6)
        assert torch.equal(got.inlier[f], one.inlier)
        assert int(got.n_inliers[f]) == int(one.n_inliers)


def test_pose_gn_signature_matches_its_source():
    """The ctypes argument list of slam_pose_gn against the extern "C"
    declaration in csrc/pose_gn.cu, read as text: one entry a parameter, a
    pointer for each pointer and an int for each int."""
    text = (native.CSRC / "pose_gn.cu").read_text()
    decl = text[text.index('extern "C" int slam_pose_gn('):]
    params = [p.strip() for p in
              decl[decl.index("(") + 1:decl.index(")")].split(",")]
    want = [native._P if "*" in p else native._I for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert native._SIGNATURES["slam_pose_gn"] == want
