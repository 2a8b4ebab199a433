"""The port's Sim(3), the rest of SO(3)/SE(3) and the pose graph against
the JAX package.

Same seeded numpy inputs through both packages. Tolerances: 1e-5 on the
Lie maps' matrices and vectors (1e-4 on logs near pi); the pose graphs'
optimised states within 2e-3 of JAX's (float32 GN trajectories over 12-20
iterations, the port summing its normal equations in float64), and every
gate of ``tests/test_pose_graph.py`` on the port's own result.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import (se3 as jse3, sim3 as jsim3,
                                                  so3 as jso3)
from orb_slam3_detailed_comments_tpu.optim import pose_graph as jpg
from orb_slam3_detailed_comments_tpu_torch.lie import Sim3, se3, sim3, so3
from orb_slam3_detailed_comments_tpu_torch.optim import pose_graph

from test_pose_graph import centers, make_loop_problem

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rotvecs(rng, n):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-5, -2e-5, 3e-6]
    w[2] = [0.0, 3.1, 0.2]
    return w


@pytest.mark.parametrize("fn", ["right_jacobian", "inv_left_jacobian",
                                "inv_right_jacobian"])
def test_so3_jacobians_match_jax(fn):
    w = _rotvecs(np.random.default_rng(5), 64)
    np.testing.assert_allclose(getattr(so3, fn)(_t(w)).numpy(),
                               np.asarray(getattr(jso3, fn)(jnp.asarray(w))),
                               atol=1e-5)


def test_so3_from_quat_matches_jax():
    q = np.random.default_rng(6).normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(so3.from_quat(_t(q)).numpy(),
                               np.asarray(jso3.from_quat(jnp.asarray(q))),
                               atol=1e-6)


def test_se3_log_adjoint_boxplus_relative_match_jax():
    rng = np.random.default_rng(7)
    xi = rng.normal(scale=0.5, size=(16, 6)).astype(np.float32)
    xj = rng.normal(scale=0.5, size=(16, 6)).astype(np.float32)
    A, JA = se3.exp(_t(xi)), jse3.exp(jnp.asarray(xi))
    B, JB = se3.exp(_t(xj)), jse3.exp(jnp.asarray(xj))
    np.testing.assert_allclose(se3.log(A).numpy(), np.asarray(jse3.log(JA)),
                               atol=1e-5)
    np.testing.assert_allclose(se3.adjoint(A).numpy(),
                               np.asarray(jse3.adjoint(JA)), atol=1e-5)
    for mine, ref in ((se3.boxplus(A, _t(xj)), jse3.boxplus(JA,
                                                             jnp.asarray(xj))),
                      (se3.relative(A, B), jse3.relative(JA, JB))):
        np.testing.assert_allclose(mine.R.numpy(), np.asarray(ref.R),
                                   atol=1e-5)
        np.testing.assert_allclose(mine.t.numpy(), np.asarray(ref.t),
                                   atol=1e-5)


def _sim3_tangents(rng, n):
    xi = rng.normal(scale=0.4, size=(n, 7)).astype(np.float32)
    xi[0] = 0.0                                   # both small
    xi[1, 3:6] = 0.0                              # theta small
    xi[2, 6] = 0.0                                # sigma small
    return xi


def test_sim3_exp_log_compose_inverse_apply_match_jax():
    rng = np.random.default_rng(8)
    xi, xj = _sim3_tangents(rng, 32), _sim3_tangents(rng, 32)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    A, JA = sim3.exp(_t(xi)), jsim3.exp(jnp.asarray(xi))
    B, JB = sim3.exp(_t(xj)), jsim3.exp(jnp.asarray(xj))
    for mine, ref in ((A, JA), (A.compose(B), JA.compose(JB)),
                      (A.inverse(), JA.inverse())):
        for a, b in zip(mine, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    np.testing.assert_allclose(A.apply(_t(x)).numpy(),
                               np.asarray(JA.apply(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sim3.log(A).numpy(), np.asarray(jsim3.log(JA)),
                               atol=1e-4)
    np.testing.assert_allclose(sim3.log(A).numpy(), xi, atol=1e-4)
    I = Sim3.identity((2,))
    assert I.R.shape == (2, 3, 3) and float(I.s.sum()) == 2.0
    S = Sim3.from_se3(A.R, A.t)
    np.testing.assert_array_equal(S.s.numpy(), np.ones(32, np.float32))


def _both_sim3(p, iters, fix_scale=False, w=None):
    E = len(p["ei"])
    w = np.ones(E, np.float32) if w is None else w
    args = [p["Re"], p["te"], p["se"], p["ei"], p["ej"], p["eR"], p["et"],
            p["es"], w]
    mine = pose_graph.optimize_sim3_graph(
        *[torch.from_numpy(np.asarray(a)) for a in args],
        torch.from_numpy(p["fixed"]), iters=iters, fix_scale=fix_scale)
    ref = jpg.optimize_sim3_graph(*[jnp.asarray(a) for a in args],
                                  jnp.asarray(p["fixed"]), iters=iters,
                                  fix_scale=fix_scale)
    return mine, ref


def _close(mine, ref, tol=2e-3):
    for a, b in zip(mine[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)


class TestSim3Graph:
    def test_corrects_loop_drift(self, rng):
        p = make_loop_problem(rng)
        mine, ref = _both_sim3(p, 20)
        _close(mine, ref)
        pre_err = np.linalg.norm(centers(p["Re"], p["te"], p["se"])
                                 - centers(p["Rg"], p["tg"]), axis=1)
        post = centers(mine.R.numpy(), mine.t.numpy(), mine.s.numpy())
        post_err = np.linalg.norm(post - centers(p["Rg"], p["tg"]), axis=1)
        assert pre_err.max() > 0.3
        assert post_err.max() < 0.25 * pre_err.max(), (pre_err.max(),
                                                       post_err.max())
        assert abs(float(mine.s[-1]) - 1.0) < 0.05

    def test_consistent_graph_unchanged(self, rng):
        p = make_loop_problem(rng, drift_rot=0.0, drift_t=0.0, drift_s=1.0)
        mine, ref = _both_sim3(p, 5)
        _close(mine, ref)
        np.testing.assert_allclose(mine.t.numpy(), p["te"], atol=2e-2)

    def test_fix_scale_holds_metric_scale(self, rng):
        p = make_loop_problem(rng, drift_s=1.0)
        mine, ref = _both_sim3(p, 20, fix_scale=True)
        _close(mine, ref)
        np.testing.assert_array_equal(mine.s.numpy(), p["se"])
        pre_err = np.linalg.norm(centers(p["Re"], p["te"], p["se"])
                                 - centers(p["Rg"], p["tg"]), axis=1)
        post = centers(mine.R.numpy(), mine.t.numpy(), mine.s.numpy())
        post_err = np.linalg.norm(post - centers(p["Rg"], p["tg"]), axis=1)
        assert post_err.max() < 0.3 * pre_err.max()

    def test_weighted_edges_and_fixed_states(self, rng):
        """Edge weights and several fixed keyframes, padded as the loop
        closer pads (zero-weight edges 0 -> 0)."""
        p = make_loop_problem(rng, K=20)
        pad = 12
        for k, fill in (("ei", 0), ("ej", 0)):
            p[k] = np.concatenate([p[k], np.full(pad, fill, np.int32)])
        p["eR"] = np.concatenate([p["eR"], np.tile(np.eye(3, dtype=np.float32),
                                                   (pad, 1, 1))])
        p["et"] = np.concatenate([p["et"], np.zeros((pad, 3), np.float32)])
        p["es"] = np.concatenate([p["es"], np.ones(pad, np.float32)])
        w = np.concatenate([rng.uniform(0.5, 5.0, len(p["ei"]) - pad),
                            np.zeros(pad)]).astype(np.float32)
        p["fixed"][[0, 7]] = True
        mine, ref = _both_sim3(p, 12, w=w)
        _close(mine, ref)
        np.testing.assert_array_equal(mine.R[0].numpy(), np.asarray(
            jso3.normalize(jnp.asarray(p["Re"][:1])))[0])
        assert abs(float(mine.cost) - float(ref.cost)) <= 1e-3 * float(
            ref.cost) + 1e-5


class Test4DoFGraph:
    def test_corrects_yaw_drift(self, rng):
        p = make_loop_problem(rng, drift_s=1.0)
        E = len(p["ei"])
        args = [p["Re"], p["te"], p["ei"], p["ej"], p["eR"], p["et"],
                np.ones(E, np.float32)]
        mine = pose_graph.optimize_4dof_graph(
            *[torch.from_numpy(np.asarray(a)) for a in args],
            torch.from_numpy(p["fixed"]), iters=20)
        ref = jpg.optimize_4dof_graph(*[jnp.asarray(a) for a in args],
                                      jnp.asarray(p["fixed"]), iters=20)
        _close(mine, ref)
        pre_err = np.linalg.norm(centers(p["Re"], p["te"])
                                 - centers(p["Rg"], p["tg"]), axis=1)
        post = centers(mine.R.numpy(), mine.t.numpy())
        post_err = np.linalg.norm(post - centers(p["Rg"], p["tg"]), axis=1)
        assert post_err.max() < 0.35 * pre_err.max()


def test_solve_damped_matches_jax():
    rng = np.random.default_rng(9)
    A = rng.normal(size=(21, 21))
    H = (A @ A.T + 0.1 * np.eye(21)).astype(np.float32)
    H[5, :] = H[:, 5] = 0.0                      # a zero row: damped floor
    g = rng.normal(size=21).astype(np.float32)
    mine = pose_graph._solve_damped(torch.from_numpy(H).double(),
                                    torch.from_numpy(g).double(), 1e-3)
    ref = jpg._solve_damped(jnp.asarray(H), jnp.asarray(g), 1e-3)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=1e-4)
