"""The port's sharded Schur step and frame-parallel pose optimisation
(``parallel/dist_ba``) against the JAX package's, on the CPU: the mirrors
of ``tests/test_parallel.py``'s step and pose cases, and the one-process
paths of a process group of one.

The port runs in 4 ``gloo`` processes (``tests/torch_dist_cases.py``,
started once for the file); the JAX package on ``Mesh(jax.devices()[:4])``
of the 8-device CPU mesh of ``tests/conftest.py``, so both split the
observations and frames at the same boundaries.

Tolerances, the JAX tests' own: the sharded step within 2e-4 of the
one-process step and of JAX's sharded step; the reprojection error below
a quarter after 5 steps; each frame's pose within 1e-4 of the serial
optimiser's and of JAX's, within 1 cm of the truth. The processes' results
are equal to the bit, and a group of one process is no group: the
one-process solves bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from orb_slam3_detailed_comments_tpu.lie import so3 as jso3
from orb_slam3_detailed_comments_tpu.models import cameras as jcam
from orb_slam3_detailed_comments_tpu.parallel import dist_ba as jdist
from orb_slam3_detailed_comments_tpu_torch.lie import SE3
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.optim import pose_opt

import torch_dist_cases
from synthetic import CAM as JCAM
from test_parallel import _ba_problem
from test_vi_ba import build_vi_problem

WORLD = 4
CAM = cameras.pinhole(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width,
                      JCAM.height)


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:WORLD]), (axis,))


def _pose_problem(rng, F=8, M=256):
    """test_frame_parallel_pose_opt_matches_serial's frames."""
    pts = np.stack([rng.uniform(-2, 2, (F, M)), rng.uniform(-1.5, 1.5, (F, M)),
                    rng.uniform(3, 7, (F, M))], -1).astype(np.float32)
    R_gt = np.stack([np.asarray(jso3.exp(jnp.asarray(
        rng.normal(0, 0.05, 3), jnp.float32))) for _ in range(F)])
    t_gt = rng.normal(0, 0.1, (F, 3)).astype(np.float32)
    pc = np.einsum("fij,fmj->fmi", R_gt, pts) + t_gt[:, None, :]
    uv = np.asarray(jcam.project(JCAM, jnp.asarray(pc.reshape(-1, 3)))
                    ).reshape(F, M, 2).copy()
    uv += rng.normal(0, 0.3, uv.shape)
    args = (np.tile(np.eye(3, dtype=np.float32), (F, 1, 1)),
            np.zeros((F, 3), np.float32), pts, uv.astype(np.float32),
            np.ones((F, M), np.float32), np.ones((F, M), bool))
    return args, t_gt


def _viba(rng):
    prob, truth = build_vi_problem(rng, n_pts=60)
    d = {k: (tuple(np.asarray(x) for x in v) if k == "edge_pre"
             else np.asarray(v)) for k, v in prob._asdict().items()}
    return d, np.asarray(truth["g"], np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pose, t_gt = _pose_problem(np.random.default_rng(42))
    viba, g = _viba(np.random.default_rng(44))
    inp = dict(cam=tuple(CAM), ba=_ba_problem(np.random.default_rng(42)),
               pose=pose, t_gt=t_gt, viba=viba, g=g,
               pcg=_ba_problem(np.random.default_rng(43), C=10, Pn=128,
                               O=1024))
    out = torch_dist_cases.run_cases(WORLD, "parallel_cases", inp,
                                     tmp_path_factory.mktemp("parallel"))
    return inp, out


def _cost(args, R, t, p):
    oc, op, uv = args[3], args[4], args[5]
    pc = np.einsum("oij,oj->oi", R[oc], p[op]) + t[oc]
    pred = cameras.project(CAM, torch.from_numpy(pc)).numpy()
    return float(np.sum((pred - uv) ** 2))


def test_dist_ba_step_reduces_error(runs):
    inp, out = runs
    args = inp["ba"]
    c0 = _cost(args, *args[:3])
    c1 = _cost(args, *out[0]["step1"])
    c5 = _cost(args, *out[0]["step5"])
    assert c1 < c0
    assert c5 < 0.25 * c0, (c0, c1, c5)


def test_dist_ba_matches_single_device(runs):
    """The reduced Schur step equals the same step in one process."""
    _, out = runs
    R4, t4, p4 = out[0]["step1"]
    R1, t1, p1 = out[0]["step1_one"]
    np.testing.assert_allclose(t4, t1, atol=2e-4)
    np.testing.assert_allclose(p4, p1, atol=2e-4)


def test_dist_ba_step_matches_jax(runs):
    inp, out = runs
    step = jdist.make_dist_ba_step(_mesh(jdist.OBS_AXIS), JCAM)
    R, t, p = step(*[jnp.asarray(a) for a in inp["ba"]])
    np.testing.assert_allclose(out[0]["step1"][0], np.asarray(R), atol=2e-4)
    np.testing.assert_allclose(out[0]["step1"][1], np.asarray(t), atol=2e-4)
    np.testing.assert_allclose(out[0]["step1"][2], np.asarray(p), atol=2e-4)


def test_frame_parallel_pose_opt_matches_serial(runs):
    inp, out = runs
    R0, t0, X, uv, w, valid = inp["pose"]
    Rp, tp, ni = out[0]["pose"]
    for f in range(R0.shape[0]):
        res = pose_opt.pose_optimization(
            SE3(torch.from_numpy(R0[f]), torch.from_numpy(t0[f])),
            torch.from_numpy(X[f]), torch.from_numpy(uv[f]),
            torch.from_numpy(w[f]), torch.from_numpy(valid[f]), CAM)
        np.testing.assert_allclose(tp[f], res.T_cw.t.numpy(), atol=1e-4)
        assert int(ni[f]) == int(res.n_inliers)
        err = np.linalg.norm(tp[f] - inp["t_gt"][f])
        assert err < 0.01, (f, err)


def test_frame_parallel_pose_opt_matches_jax(runs):
    inp, out = runs
    popt = jdist.make_frame_parallel_pose_opt(_mesh("frames"), JCAM)
    Rj, tj, nj = popt(*[jnp.asarray(a) for a in inp["pose"]])
    np.testing.assert_allclose(out[0]["pose"][0], np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(out[0]["pose"][1], np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("key", ["step1", "step5", "pose"])
def test_every_rank_has_the_same_result(runs, key):
    _, out = runs
    for r in range(1, WORLD):
        for a, b in zip(out[0][key], out[r][key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", ["pcg_group1", "pcg_dist1", "viba_group1",
                                 "step_group1"])
def test_group_of_one_process_is_the_one_process_solve(runs, key):
    """ba_solve_pcg, make_dist_gba_pcg, vi_ba_solve and make_dist_ba_step
    over a group of one process equal their group=None solves bit for
    bit."""
    _, out = runs
    assert out[0][key] is True
