"""The port's sharded global BAs against the JAX package's, on the CPU:
``parallel/dist_ba.make_dist_gba_pcg`` (the mirrors of
``tests/test_parallel.py``'s PCG cases), ``make_dist_viba_solve`` (of
``tests/test_full_inertial_ba.py::TestDistVIBA``) and the loop closer's
racing global BA with ``dist_gba`` (of ``tests/test_loop_closing.py``'s
``test_async_solve_applies_and_abort_discards[True]``: rank 0 runs the
loop closer and leads, rank 1 serves, over a group of two).

The port runs in 4 ``gloo`` processes (``tests/torch_dist_cases.py``,
started once for the file, the slow cases in processes of their own); the
JAX package on ``Mesh(jax.devices()[:4])`` of the 8-device CPU mesh.

Tolerances, the JAX tests' own: the sharded PCG within 5e-4 of the
one-process solve and of JAX's sharded solve, > 90 % inliers, a
sub-pixel residual after 10 iterations; at C = 192 within 2e-3 (slow);
the sharded inertial BA within 2e-3 (positions) and 2e-2 (velocities) of
the one-process solve, and of JAX's, positions within 3 cm of the truth;
the full chain within 5e-3 / 5e-2 and 6 cm (slow). The racing global BA
halves the keyframes' error, applies once, and an aborted run leaves the
map equal to the bit; its keyframes within 1e-3 of JAX's sharded run.
"""
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from orb_slam3_detailed_comments_tpu.imu import preintegration as jpre
from orb_slam3_detailed_comments_tpu.optim import ba as jba
from orb_slam3_detailed_comments_tpu.optim import vi_ba as jvi
from orb_slam3_detailed_comments_tpu.parallel import dist_ba as jdist
from orb_slam3_detailed_comments_tpu.pipeline import loop_closing as jlc
from orb_slam3_detailed_comments_tpu_torch.models import cameras

import test_loop_closing
import torch_dist_cases
from synthetic import CAM as JCAM
from test_parallel import _ba_problem
from test_vi_ba import build_vi_problem

WORLD = 4
CAM = cameras.pinhole(JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width,
                      JCAM.height)


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), (jdist.OBS_AXIS,))


def _viba(rng, **kw):
    """build_vi_problem's problem, its observations padded with
    obs_valid=False to a multiple of the world size (as the JAX test
    pads them)."""
    prob, truth = build_vi_problem(rng, **kw)
    O = int(prob.obs_cam.shape[0])
    pad = -O % WORLD
    d = {}
    for k, v in prob._asdict().items():
        if k == "edge_pre":
            d[k] = tuple(np.asarray(x) for x in v)
            continue
        v = np.asarray(v)
        if k.startswith("obs_"):
            v = np.concatenate([v, np.full((pad, *v.shape[1:]),
                                           False if k == "obs_valid" else 0,
                                           v.dtype)])
        d[k] = v
    return d, truth


def _jax_viba(d):
    return jvi.VIBAProblem(**{
        k: (jpre.Preintegrated(*[jnp.asarray(x) for x in v])
            if k == "edge_pre" else jnp.asarray(v)) for k, v in d.items()})


def _scene(rng):
    """TestAsyncGlobalBA's perturbed scene map (its class is not imported
    here, so that its tests are not collected twice)."""
    jm, sc = test_loop_closing.TestAsyncGlobalBA()._scene_map(rng)
    jm.kf_t[1:4] += rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    jm.pt_xyz[:120] += rng.normal(0, 0.02, (120, 3)).astype(np.float32)
    return jm, sc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    viba, truth = _viba(np.random.default_rng(42))
    jm, sc = _scene(np.random.default_rng(7))
    inp = dict(cam=tuple(CAM),
               pcg=_ba_problem(np.random.default_rng(42), C=10, Pn=128,
                               O=2048),
               viba=viba, g=np.asarray(truth["g"], np.float32), truth=truth,
               map={k: v for k, v in vars(jm).items()
                    if isinstance(v, np.ndarray)},
               scene_t=sc["t"])
    out = torch_dist_cases.run_cases(WORLD, "dist_gba_cases", inp,
                                     tmp_path_factory.mktemp("dist_gba"))
    return inp, out, jm


def _rms(prob_t, res):
    oc, op, uv = prob_t[3], prob_t[4], prob_t[5]
    pc = np.einsum("oij,oj->oi", res["kf_R"][oc],
                   res["points"][op]) + res["kf_t"][oc]
    pred = cameras.project(CAM, torch.from_numpy(pc)).numpy()
    return float(np.sqrt(np.mean(np.sum((pred - uv) ** 2, -1))))


def test_dist_gba_pcg_matches_single_device(runs):
    """Every reduction is summed over the group, so every process walks
    the one-process solve's LM and CG steps."""
    _, out, _ = runs
    r4, r1 = out[0]["pcg8"], out[0]["pcg8_one"]
    np.testing.assert_allclose(r4["kf_t"], r1["kf_t"], atol=5e-4)
    np.testing.assert_allclose(r4["points"], r1["points"], atol=5e-4)
    assert r4["obs_inlier"].mean() > 0.9
    assert r4["obs_inlier"].shape == (2048,)


def test_dist_gba_pcg_matches_jax(runs):
    inp, out, _ = runs
    prob = jba.BAProblem(*[jnp.asarray(a) for a in inp["pcg"]])
    rj = jdist.make_dist_gba_pcg(_mesh(), JCAM, iters=8)(prob)
    np.testing.assert_allclose(out[0]["pcg8"]["kf_t"], np.asarray(rj.kf_t),
                               atol=5e-4)
    np.testing.assert_allclose(out[0]["pcg8"]["points"],
                               np.asarray(rj.points), atol=5e-4)


def test_dist_gba_pcg_converges(runs):
    inp, out, _ = runs
    assert _rms(inp["pcg"], out[0]["pcg10"]) < 1.0


@pytest.mark.parametrize("key", ["pcg8", "viba"])
def test_every_rank_has_the_same_result(runs, key):
    _, out, _ = runs
    for r in range(1, WORLD):
        for f, v in out[0][key].items():
            np.testing.assert_array_equal(v, out[r][key][f], err_msg=f)


@pytest.mark.slow
def test_dist_gba_pcg_matches_single_device_at_scale(tmp_path):
    """The deployment shape that selects the sharded PCG (C = 192 > 128
    cameras, 16,384 points, 65,536 observations)."""
    prob_t = _ba_problem(np.random.default_rng(42), C=192, Pn=16384,
                         O=65536)
    out = torch_dist_cases.run_cases(
        WORLD, "pcg_scale_cases", dict(cam=tuple(CAM), pcg=prob_t),
        tmp_path, timeout=1800)
    r4, r1 = out[0]["pcg"], out[0]["pcg_one"]
    np.testing.assert_allclose(r4["kf_t"], r1["kf_t"], atol=2e-3)
    np.testing.assert_allclose(r4["points"], r1["points"], atol=2e-3)
    assert _rms(prob_t, r4) < 1.0


class TestDistVIBA:
    def test_sharded_matches_single_device(self, runs):
        inp, out, _ = runs
        r4, r1 = out[0]["viba"], out[0]["viba_one"]
        np.testing.assert_allclose(r4["p_w"], r1["p_w"], atol=2e-3)
        np.testing.assert_allclose(r4["v_w"], r1["v_w"], atol=2e-2)
        p_err = np.linalg.norm(r4["p_w"] - inp["truth"]["p"], axis=1)
        assert p_err.max() < 0.03, p_err

    def test_sharded_matches_jax(self, runs):
        inp, out, _ = runs
        rj = jvi.vi_ba_solve(_jax_viba(inp["viba"]), JCAM, jnp.eye(3),
                             jnp.zeros(3), gravity=jnp.asarray(inp["g"]),
                             prior_gyro=1.0, prior_acc=1e4, iters=6)
        np.testing.assert_allclose(out[0]["viba"]["p_w"], np.asarray(rj.p_w),
                                   atol=2e-3)
        np.testing.assert_allclose(out[0]["viba"]["v_w"], np.asarray(rj.v_w),
                                   atol=2e-2)

    @pytest.mark.slow
    def test_sharded_matches_single_device_full_chain(self, tmp_path):
        viba, truth = _viba(np.random.default_rng(42), n_kf=60, n_pts=600)
        out = torch_dist_cases.run_cases(
            WORLD, "viba_chain_cases",
            dict(cam=tuple(CAM), viba=viba,
                 g=np.asarray(truth["g"], np.float32)), tmp_path,
            timeout=1800)
        r4, r1 = out[0]["viba"], out[0]["viba_one"]
        np.testing.assert_allclose(r4["p_w"], r1["p_w"], atol=5e-3)
        np.testing.assert_allclose(r4["v_w"], r1["v_w"], atol=5e-2)
        p_err = np.linalg.norm(r4["p_w"] - truth["p"], axis=1)
        assert p_err.max() < 0.06, p_err.max()


def test_async_solve_applies_and_abort_discards_dist(runs):
    """dist=True: rank 0's racing global BA leads rank 1 through every
    sharded step; it halves the error and applies once, and the aborted
    run leaves the map untouched."""
    inp, out, _ = runs
    c = out[0]["closer"]
    t_true = inp["scene_t"]
    err0 = float(np.abs(inp["map"]["kf_t"][1:4] - t_true[1:4]).max())
    err1 = float(np.abs(c["kf_t"][1:4] - t_true[1:4]).max())
    assert c["sharded"] and c["runs"] == 1 and c["aborted"] == 0
    assert err1 < 0.5 * err0, (err0, err1)
    assert c["aborted_after"] >= 1 and c["version_kept"] and c["kf_t_kept"]
    assert out[1]["served"] >= 5     # the sharded steps rank 1 joined


def test_async_dist_solve_matches_jax(runs):
    """The same launch in the JAX package, sharded over its 8 devices:
    5 sharded steps and a one-process polish in both."""
    inp, out, _ = runs
    jm, _ = _scene(np.random.default_rng(7))
    lc = jlc.LoopCloser(jm, JCAM, kfdb=None,
                        cfg=jlc.LoopClosingConfig(async_gba=True,
                                                  gba_iters=6, gba_chunk=3,
                                                  dist_gba=True))
    lc.map_lock = threading.RLock()
    lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
    lc.wait_gba()
    assert lc.n_gba_runs == 1
    np.testing.assert_allclose(out[0]["closer"]["kf_t"], jm.kf_t, atol=1e-3)
    np.testing.assert_allclose(out[0]["closer"]["pt_xyz"], jm.pt_xyz,
                               atol=2e-3)


def test_world_of_one_takes_the_one_process_solve(runs):
    """A group of one process with dist_gba=True: no sharding, the
    one-process racing global BA, applied once."""
    inp, out, _ = runs
    c = out[0]["closer_one"]
    t_true = inp["scene_t"]
    err0 = float(np.abs(inp["map"]["kf_t"][1:4] - t_true[1:4]).max())
    err1 = float(np.abs(c["kf_t"][1:4] - t_true[1:4]).max())
    assert not c["sharded"] and c["runs"] == 1 and c["aborted"] == 0
    assert err1 < 0.5 * err0, (err0, err1)
