"""The port's bundle adjustment (table tier) against the JAX package's, on
the CPU, on one synthetic problem: 5 real cameras padded to C = 8, 400 real
points padded to P = 512, 2000 observations padded to 4096, 40 of them gross
outliers, table depth 8.

Tolerances: the observation table is integer bookkeeping and must be equal;
one damped Schur solve from shared normal equations agrees within 1e-4
relative (float32 Cholesky of a 48x48 system; measured 2.6e-5); a whole
solve ends within 1 % of the JAX cost (measured 1e-6 relative) with >= 99 %
of the inlier mask equal (measured all) and poses / points within 1e-3.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synthetic import CAM as JCAM, make_scene
from orb_slam3_detailed_comments_tpu.optim import ba as jba
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.optim import ba, reproj

torch.set_num_threads(2)
CAM = cameras.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480)
C, P, O, DEPTH = 8, 512, 4096, 8


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(1)
    sc = make_scene(rng, n_points=400, n_cams=5)
    ci, pi = np.nonzero(sc["vis"])
    n = len(ci)
    uv = sc["uv"][ci, pi].copy()
    bad = rng.choice(n, 40, replace=False)
    uv[bad] += rng.normal(0, 30, (40, 2))
    pad = O - n
    f32 = np.float32
    arr = dict(
        kf_R=np.concatenate([sc["R"], np.tile(np.eye(3, dtype=f32),
                                              (C - 5, 1, 1))]),
        kf_t=np.concatenate([sc["t"] + rng.normal(0, 0.02, (5, 3)),
                             np.zeros((C - 5, 3))]).astype(f32),
        points=np.concatenate([sc["points"] + rng.normal(0, 0.05, (400, 3)),
                               np.zeros((P - 400, 3))]).astype(f32),
        obs_cam=np.concatenate([ci, np.zeros(pad, np.int64)]).astype(np.int32),
        obs_pt=np.concatenate([pi, np.zeros(pad, np.int64)]).astype(np.int32),
        obs_uv=np.concatenate([uv, np.zeros((pad, 2))]).astype(f32),
        obs_w=np.concatenate([rng.choice([1.0, 0.69, 0.48], n),
                              np.zeros(pad)]).astype(f32),
        obs_valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        fixed_cam=np.array([True] + [False] * 4 + [True] * (C - 5)),
        point_valid=np.concatenate([np.ones(400, bool),
                                    np.zeros(P - 400, bool)]))
    arr["kf_t"][0] = sc["t"][0]
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})
    return arr, jp, ba.problem_from_numpy(arr), bad


@pytest.fixture(autouse=True)
def _reference_lm_body(monkeypatch):
    # the einsum LM body that the JAX package's CPU tests pin its packed
    # variant against
    monkeypatch.setattr(jba, "USE_PACKED", False)


def test_problem_from_numpy_round_trip(problem):
    arr, jp, tp, _ = problem
    for k, v in tp._asdict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jp, k)))
    assert tp.obs_cam.dtype == torch.int32 and tp.obs_valid.dtype == torch.bool


@pytest.mark.parametrize("depth", [DEPTH, 4])
def test_build_obs_table_equal(problem, depth):
    """depth 4 overflows for points seen by all 5 cameras: the overflow
    column and the inverse map must agree too."""
    _, jp, tp, _ = problem
    t_j = jba.prepare_table(jp, depth)
    t_t = ba.prepare_table(tp, depth)
    for f in t_j._fields:
        np.testing.assert_array_equal(getattr(t_t, f).numpy(),
                                      np.asarray(getattr(t_j, f)), err_msg=f)
    absent = int((t_t.pos == P * depth).sum())
    assert absent == O - 2000 if depth == DEPTH else absent > O - 2000


def test_one_schur_solve_matches(problem):
    _, jp, tp, _ = problem
    TL = ba.prepare_table(tp, DEPTH)
    blocks = ba.assemble_normal_equations(
        TL, tp.kf_R, tp.kf_t, tp.points, TL.w_t, CAM, reproj.CHI2_MONO)
    dc, dp = ba._schur_lm_solve(*blocks, torch.tensor(1e-4), tp.fixed_cam,
                                tp.point_valid)
    dc_j, dp_j = jba._schur_lm_solve(
        *[jnp.asarray(b.numpy()) for b in blocks], jnp.float32(1e-4),
        jp.fixed_cam, jp.point_valid)
    for got, ref in ((dc, dc_j), (dp, dp_j)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-4
    assert float(dc[0].abs().max()) == 0.0            # fixed camera
    assert float(dp[400:].abs().max()) == 0.0         # padding points


def test_normal_equations_match_a_coo_assembly(problem):
    """The table assembly equals a plain per-observation accumulation of
    the same Jacobians (float64 on the host), within 1e-4 relative."""
    arr, _, tp, _ = problem
    TL = ba.prepare_table(tp, DEPTH)
    U, b_c, V, b_p, Wd = (x.numpy() for x in ba.assemble_normal_equations(
        TL, tp.kf_R, tp.kf_t, tp.points, TL.w_t, CAM, reproj.CHI2_MONO))
    from orb_slam3_detailed_comments_tpu_torch.lie import SE3
    oc, op = tp.obs_cam.long(), tp.obs_pt.long()
    r, Jc, Jp, ok = reproj.residual_full(
        SE3(tp.kf_R[oc], tp.kf_t[oc]), tp.points[op], tp.obs_uv, CAM)
    chi2 = (r * r).sum(-1) * tp.obs_w
    w = (tp.obs_w * reproj.huber_weight(chi2, reproj.CHI2_MONO) * ok
         * tp.obs_valid).double().numpy()
    Jc, Jp, r = Jc.double().numpy(), Jp.double().numpy(), r.double().numpy()
    U2, V2 = np.zeros((C, 6, 6)), np.zeros((P, 3, 3))
    W2, bc2, bp2 = np.zeros((P, C, 6, 3)), np.zeros((C, 6)), np.zeros((P, 3))
    np.add.at(U2, oc.numpy(), np.einsum("oki,o,okj->oij", Jc, w, Jc))
    np.add.at(V2, op.numpy(), np.einsum("oki,o,okj->oij", Jp, w, Jp))
    np.add.at(W2, (op.numpy(), oc.numpy()),
              np.einsum("oki,o,okj->oij", Jc, w, Jp))
    np.add.at(bc2, oc.numpy(), np.einsum("oki,o,ok->oi", Jc, w, r))
    np.add.at(bp2, op.numpy(), np.einsum("oki,o,ok->oi", Jp, w, r))
    for got, ref in ((U, U2), (V, V2), (Wd, W2), (b_c, bc2), (b_p, bp2)):
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.fixture(scope="module")
def solved(problem):
    _, jp, tp, _ = problem
    jba.USE_PACKED = False
    try:
        r_j = jba.ba_solve(jp, JCAM, iters=20, table_depth=DEPTH)
    finally:
        jba.USE_PACKED = None
    return r_j, ba.ba_solve(tp, CAM, iters=20, table_depth=DEPTH)


def test_ba_solve_cost_and_inliers(problem, solved):
    _, _, tp, bad = problem
    r_j, r_t = solved
    cost_j = float(r_j.cost)
    assert abs(float(r_t.cost) - cost_j) < 0.01 * cost_j
    inl_t, inl_j = r_t.obs_inlier.numpy(), np.asarray(r_j.obs_inlier)
    assert (inl_t == inl_j).mean() >= 0.99
    assert inl_t[bad].sum() <= 2                    # the gross outliers go
    assert inl_t[:2000].sum() > 1900 and not inl_t[2000:].any()


def test_ba_solve_state(problem, solved):
    arr, _, _, _ = problem
    r_j, r_t = solved
    np.testing.assert_allclose(r_t.points.numpy()[:400],
                               np.asarray(r_j.points)[:400], atol=1e-3)
    np.testing.assert_allclose(r_t.kf_R.numpy(), np.asarray(r_j.kf_R),
                               atol=1e-3)
    np.testing.assert_allclose(r_t.kf_t.numpy(), np.asarray(r_j.kf_t),
                               atol=1e-3)
    # the fixed camera and the padding stay where they were
    np.testing.assert_allclose(r_t.kf_t.numpy()[0], arr["kf_t"][0], atol=1e-6)
    np.testing.assert_array_equal(r_t.points.numpy()[400:], 0.0)


def test_failed_cholesky_is_a_rejected_step():
    """An indefinite Schur system must not raise: the step comes back NaN,
    which the LM accept test rejects."""
    U = -torch.eye(6)[None].repeat(2, 1, 1)
    V = torch.eye(3)[None].repeat(4, 1, 1)
    dc, dp = ba._schur_lm_solve(
        U, torch.ones(2, 6), V, torch.ones(4, 3), torch.zeros(4, 2, 6, 3),
        torch.tensor(1e-4), torch.zeros(2, dtype=torch.bool),
        torch.ones(4, dtype=torch.bool))
    assert not torch.isfinite(dc).all()


def _scene_problem(seed, n_cams, C_pad, n_pts, P_pad, n_bad):
    """A make_scene problem of n_cams cameras padded to C_pad and n_pts
    points padded to P_pad, n_bad gross outliers, as numpy arrays, a JAX
    BAProblem and the port's."""
    rng = np.random.default_rng(seed)
    sc = make_scene(rng, n_points=n_pts, n_cams=n_cams)
    ci, pi = np.nonzero(sc["vis"])
    n = len(ci)
    uv = sc["uv"][ci, pi].copy()
    uv[rng.choice(n, n_bad, replace=False)] += rng.normal(0, 30, (n_bad, 2))
    O_pad = ((n + 511) // 512) * 512
    pad = O_pad - n
    f32 = np.float32
    arr = dict(
        kf_R=np.concatenate([sc["R"], np.tile(np.eye(3, dtype=f32),
                                              (C_pad - n_cams, 1, 1))]),
        kf_t=np.concatenate([sc["t"] + rng.normal(0, 0.02, (n_cams, 3)),
                             np.zeros((C_pad - n_cams, 3))]).astype(f32),
        points=np.concatenate([sc["points"]
                               + rng.normal(0, 0.05, (n_pts, 3)),
                               np.zeros((P_pad - n_pts, 3))]).astype(f32),
        obs_cam=np.concatenate([ci, np.zeros(pad, np.int64)]).astype(np.int32),
        obs_pt=np.concatenate([pi, np.zeros(pad, np.int64)]).astype(np.int32),
        obs_uv=np.concatenate([uv, np.zeros((pad, 2))]).astype(f32),
        obs_w=np.concatenate([rng.choice([1.0, 0.69, 0.48], n),
                              np.zeros(pad)]).astype(f32),
        obs_valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        fixed_cam=np.array([True] + [False] * (n_cams - 1)
                           + [True] * (C_pad - n_cams)),
        point_valid=np.concatenate([np.ones(n_pts, bool),
                                    np.zeros(P_pad - n_pts, bool)]))
    arr["kf_t"][0] = sc["t"][0]
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})
    return arr, jp, ba.problem_from_numpy(arr), n


def _agree(r_t, r_j, n_obs, n_pts, cost_rel=1e-2, tol=1e-3):
    """The gates of a whole solve: cost within cost_rel of the reference,
    >= 99 % of the inlier mask equal, poses and points within tol."""
    c_t, c_j = float(r_t.cost), float(np.asarray(r_j.cost))
    assert abs(c_t - c_j) <= cost_rel * c_j, (c_t, c_j)
    inl_t = np.asarray(r_t.obs_inlier)[:n_obs]
    inl_j = np.asarray(r_j.obs_inlier)[:n_obs]
    assert (inl_t == inl_j).mean() >= 0.99
    for a, b in ((r_t.kf_R, r_j.kf_R), (r_t.kf_t, r_j.kf_t)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)
    np.testing.assert_allclose(np.asarray(r_t.points)[:n_pts],
                               np.asarray(r_j.points)[:n_pts], atol=tol)


@pytest.fixture(scope="module")
def coo_problem():
    """52 cameras padded to C = 56: above the table tier, below PCG."""
    return _scene_problem(4, 52, 56, 120, 128, 30)


def test_coo_tier_matches_jax(coo_problem):
    """48 < C <= 128: the port's ba_solve takes the COO tier, held against
    the JAX package's _ba_solve_coo on the same problem."""
    arr, jp, tp, n = coo_problem
    assert ba._TABLE_C_MAX < tp.kf_R.shape[0] <= ba._PCG_C_MIN
    r_t = ba.ba_solve(tp, CAM, iters=9)
    r_j = jba._ba_solve_coo(jp, JCAM, 9, reproj.CHI2_MONO, 1e-4)
    _agree(r_t, r_j, n, 120)
    assert np.asarray(r_t.obs_inlier)[:n].sum() > 0.9 * n
    np.testing.assert_allclose(r_t.kf_t.numpy()[0], arr["kf_t"][0],
                               atol=1e-6)


def test_coo_tier_matches_the_table_tier(problem):
    """One problem that both tiers take (C = 8): the COO tier against the
    port's table tier (which stops once a step no longer lowers the cost;
    the COO tier runs every iteration)."""
    _, _, tp, _ = problem
    r_c = ba._ba_solve_coo(tp, CAM, 9, reproj.CHI2_MONO, 1e-4)
    r_t = ba.ba_solve(tp, CAM, iters=9, table_depth=DEPTH)
    _agree(r_c, r_t, 2000, 400)


def test_coo_scatter_sums_are_float64_rounded_once():
    """segment_sum's float32 result is the float64 sum rounded once: the
    same for any order of the rows."""
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.normal(size=(5000, 6)).astype(np.float32)
                            * 1e3)
    seg = torch.from_numpy(rng.integers(0, 7, 5000))
    perm = torch.from_numpy(rng.permutation(5000))
    a = ba.segment_sum(vals, seg, 7)
    b = ba.segment_sum(vals[perm], seg[perm], 7)
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = np.zeros((7, 6))
    np.add.at(want, seg.numpy(), vals.numpy().astype(np.float64))
    np.testing.assert_array_equal(a.numpy(), want.astype(np.float32))


def test_ba_solve_routes_by_camera_count(problem, coo_problem, monkeypatch):
    """C <= 48: the table tier; 48 < C <= 128: COO; C > 128: Schur-PCG."""
    from orb_slam3_detailed_comments_tpu_torch.optim import schur_pcg
    took = []
    for name, mod in (("_ba_solve_tables", ba), ("_ba_solve_coo", ba),
                      ("ba_solve_pcg", schur_pcg)):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            took.append(_n))
    ba.ba_solve(problem[2], CAM)
    ba.ba_solve(coo_problem[2], CAM)
    big = coo_problem[2]._replace(
        kf_R=torch.eye(3).repeat(136, 1, 1), kf_t=torch.zeros(136, 3),
        fixed_cam=torch.ones(136, dtype=torch.bool))
    ba.ba_solve(big, CAM)
    ba.ba_solve_fused(big, CAM)
    assert took == ["_ba_solve_tables", "_ba_solve_coo", "ba_solve_pcg",
                    "ba_solve_pcg"]


def test_pcg_tier_matches_jax():
    """C > 128 with few points: the port's Schur-PCG against the JAX
    package's ba_solve_pcg."""
    from orb_slam3_detailed_comments_tpu.optim import schur_pcg as jpcg
    arr, jp, tp, n = _scene_problem(5, 132, 136, 48, 64, 20)
    r_t = ba.ba_solve(tp, CAM, iters=6)
    r_j = jpcg.ba_solve_pcg(jp, JCAM, iters=6)
    _agree(r_t, r_j, n, 48, tol=2e-3)
