"""The port's two-view reconstruction against the JAX package's, on the CPU.

Both sides get the same matches (numpy, seeded) and the same minimal sets:
the JAX index sets are recomputed here with the two ``jax.random`` calls
that ``reconstruct`` makes from its key, and handed to the port as
``samples``.

Tolerances. E and H are defined up to sign and their singular vectors up to
order, so what is compared is the motion.

* Homography path (planar scenes): ``R21`` within 1e-4, the ``t21``
  direction within 1e-3 rad, ``is_good`` agreement >= 0.98, the same
  ``used_homography`` and ``success``. Measured: 3.4e-6, 3.5e-4 rad, 1.000.
* Essential path: an 8-point or least-squares system in normalized
  coordinates has a spectrum wider than float32 resolves, so its null
  vector depends on the eigensolver. XLA's float32 ``eigh`` and the port's
  (taken in float64, see ``models/twoview._smallest_eigvec9``) refit E from
  one shared inlier mask to within 3e-4 of each other, score one
  hypothesis within a median of 2-12 points, and on some inputs crown
  another hypothesis. The two motions then differ by as much as either
  differs from the scene's ground truth (measured on seeds 1, 10, 11, 20,
  22: R21 1e-5 .. 2e-3 apart, each 2e-3 .. 7e-3 from the truth). Held to:
  R21 within 5e-3 of each other and 1e-2 of the truth, ``t21`` within
  0.02 rad, ``is_good`` agreement >= 0.9, same flags. Seed 0, where
  another hypothesis wins, is held to 0.02 / 0.05 rad. Over 20 further
  seeds with 20 % wrong matches the JAX version succeeded on 17 and the
  port on 18, with median rotation errors of 9.1e-3 and 1.0e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.models import twoview as jtv
from orb_slam3_detailed_comments_tpu.ops import triangulate as jtri
from orb_slam3_detailed_comments_tpu.lie import SE3 as JSE3
from orb_slam3_detailed_comments_tpu_torch.lie import SE3, so3
from orb_slam3_detailed_comments_tpu_torch.models import twoview
from orb_slam3_detailed_comments_tpu_torch.ops import triangulate as tri

torch.set_num_threads(2)
FOCAL = 460.0
N_HYP = 256


def _rot(w):
    return so3.exp(torch.tensor(w, dtype=torch.float32)).numpy()


def project_pair(points, R21, t21, noise, rng):
    """points in frame 1 -> normalized coords in both frames + visibility."""
    z1 = points[:, 2]
    x1 = points[:, :2] / z1[:, None]
    p2 = points @ R21.T + t21
    x2 = p2[:, :2] / p2[:, 2:3]
    vis = ((z1 > 0.1) & (p2[:, 2] > 0.1) & (np.abs(x1) < 0.7).all(1)
           & (np.abs(x2) < 0.7).all(1))
    x1 = x1 + rng.normal(0, noise / FOCAL, x1.shape)
    x2 = x2 + rng.normal(0, noise / FOCAL, x2.shape)
    return x1.astype(np.float32), x2.astype(np.float32), vis


def scene(kind, rng):
    if kind == "planar":
        xy = rng.uniform(-2.5, 2.5, (300, 2))
        pts = np.concatenate(
            [xy, (5.0 + 0.3 * xy[:, 0] + 0.2 * xy[:, 1])[:, None]], axis=1)
        R21, t21 = _rot([0.03, 0.08, -0.02]), np.array([0.5, -0.1, 0.15])
    else:
        pts = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1.5, 1.5, 300),
                        rng.uniform(3, 9, 300)], axis=1)
        R21 = _rot([0.0, 0.15, 0.0] if kind == "rotation"
                   else [0.02, -0.1, 0.01])
        t21 = (np.zeros(3) if kind == "rotation"
               else np.array([0.6, 0.05, 0.1]))
    x1, x2, vis = project_pair(pts, R21, t21.astype(np.float32), 0.5, rng)
    if kind == "outliers":
        x2[:60] = rng.uniform(-0.5, 0.5, (60, 2)).astype(np.float32)
    return x1, x2, vis, R21, t21


def jax_samples(key, valid, n_hyp=N_HYP):
    """The index sets jtv.reconstruct draws from its key."""
    def sample_idx(k, n):
        g = jax.random.uniform(k, (n_hyp, valid.shape[0]))
        g = jnp.where(jnp.asarray(valid)[None, :], g, -1.0)
        return np.asarray(jax.lax.top_k(g, n)[1])
    k_e, k_h = jax.random.split(key)
    return sample_idx(k_e, 8), sample_idx(k_h, 4)


def both(kind, seed):
    rng = np.random.default_rng(seed)
    x1, x2, vis, R21, t21 = scene(kind, rng)
    key = jax.random.PRNGKey(seed)
    ref = jtv.reconstruct(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(vis),
                          key, focal=FOCAL)
    idx_e, idx_h = jax_samples(key, vis)
    got = twoview.reconstruct(
        torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(vis),
        samples=(torch.from_numpy(idx_e.copy()),
                 torch.from_numpy(idx_h.copy())), focal=FOCAL)
    return ref, got, (x1, x2, vis, R21, t21)


def _compare(ref, got):
    dR = np.abs(got.R21.numpy() - np.asarray(ref.R21)).max()
    cos = float(got.t21.numpy() @ np.asarray(ref.t21))
    agree = (got.is_good.numpy() == np.asarray(ref.is_good)).mean()
    return dR, np.arccos(min(cos, 1.0)), agree


@pytest.mark.parametrize("seed", [2, 23, 24])
def test_homography_path_matches_jax_on_shared_samples(seed):
    ref, got, (_, _, vis, R21, t21) = both("planar", seed)
    assert bool(ref.success) and bool(got.success)
    assert bool(got.used_homography) and bool(ref.used_homography)
    dR, dt, agree = _compare(ref, got)
    assert dR < 1e-4 and dt < 1e-3 and agree >= 0.98
    good = got.is_good.numpy() & np.asarray(ref.is_good)
    X_t, X_j = got.points3d.numpy()[good], np.asarray(ref.points3d)[good]
    assert np.median(np.abs(X_t - X_j).max(1) / X_j[:, 2]) < 1e-3
    assert np.abs(got.R21.numpy() - R21).max() < 0.02


@pytest.mark.parametrize("kind,seed,tol_R,tol_t", [
    ("general", 1, 5e-3, 0.02), ("general", 10, 5e-3, 0.02),
    ("general", 11, 5e-3, 0.02), ("general", 20, 5e-3, 0.02),
    ("outliers", 22, 5e-3, 0.02), ("general", 0, 0.02, 0.05)])
def test_essential_path_matches_jax_on_shared_samples(kind, seed, tol_R,
                                                      tol_t):
    ref, got, (_, _, vis, R21, t21) = both(kind, seed)
    assert bool(ref.success) and bool(got.success)
    assert not bool(got.used_homography) and not bool(ref.used_homography)
    dR, dt, agree = _compare(ref, got)
    assert dR < tol_R and dt < tol_t and agree >= 0.9
    for R in (got.R21.numpy(), np.asarray(ref.R21)):
        assert np.abs(R - R21).max() < 1e-2
    assert abs(got.t21.numpy() @ t21) / np.linalg.norm(t21) > 0.99
    if kind == "outliers":
        assert int(got.is_good[:60].sum()) < 8        # corrupted matches


def test_refit_and_motion_recovery_match_jax_on_a_shared_mask():
    """From one inlier mask both sides refit the same E and H (up to sign),
    recover the same set of motions and count the same good points."""
    rng = np.random.default_rng(8)
    x1, x2, vis, R21, t21 = scene("general", rng)
    w = vis & (rng.uniform(size=len(vis)) < 0.9)
    a = [torch.from_numpy(v) for v in (x1, x2, w)]
    j = [jnp.asarray(v) for v in (x1, x2, w)]
    f2 = FOCAL ** 2
    for refit_t, refit_j in ((twoview._essential_refit, jtv._essential_refit),
                             (twoview._homography_refit,
                              jtv._homography_refit)):
        M_t, M_j = refit_t(*a).numpy(), np.asarray(refit_j(*j))
        M_t, M_j = M_t / np.linalg.norm(M_t), M_j / np.linalg.norm(M_j)
        assert min(np.abs(M_t - M_j).max(), np.abs(M_t + M_j).max()) < 1e-3
    E = jtv._essential_refit(*j)
    Rs_j, ts_j = jtv._motions_from_E(E)
    Rs_t, ts_t = twoview._motions_from_E(torch.from_numpy(np.array(E)))
    good, n_t, _, _ = twoview._check_rt(Rs_t, ts_t, a[0], a[1], a[2], f2)
    n_j = [int(jtv._check_rt(Rs_j[i], ts_j[i], j[0], j[1], j[2], f2)[1])
           for i in range(4)]
    # the four candidates may come in another order (singular-vector signs)
    assert sorted(n_t.tolist()) == sorted(n_j)
    assert max(n_j) > 0.8 * w.sum() and sorted(n_j)[-2] == 0
    best_t, best_j = int(torch.argmax(n_t)), int(np.argmax(n_j))
    assert np.abs(Rs_t[best_t].numpy() - np.asarray(Rs_j[best_j])).max() < 1e-5
    assert np.abs(ts_t[best_t].numpy() - np.asarray(ts_j[best_j])).max() < 1e-5


def test_pure_rotation_rejected_by_both():
    ref, got, _ = both("rotation", 4)
    assert not bool(ref.success) and not bool(got.success)


def test_reconstruct_with_its_own_generator():
    """Sampling from a torch.Generator: succeeds on a general scene, and the
    same seed gives the same result."""
    rng = np.random.default_rng(5)
    x1, x2, vis, R21, t21 = scene("outliers", rng)
    args = [torch.from_numpy(a) for a in (x1, x2, vis)]
    a = twoview.reconstruct(*args, generator=torch.Generator().manual_seed(9),
                            focal=FOCAL)
    b = twoview.reconstruct(*args, generator=torch.Generator().manual_seed(9),
                            focal=FOCAL)
    assert bool(a.success)
    assert torch.equal(a.R21, b.R21) and torch.equal(a.is_good, b.is_good)
    assert np.abs(a.R21.numpy() - R21).max() < 0.02
    assert int(a.is_good[:60].sum()) < 8          # corrupted matches


def test_sample_minimal_sets_are_distinct_and_valid():
    valid = torch.from_numpy(np.random.default_rng(6).uniform(size=200) < 0.5)
    idx = twoview.sample_minimal_sets(valid, 64, 8,
                                      torch.Generator().manual_seed(0))
    assert idx.shape == (64, 8)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 8 for row in idx)
    assert len({tuple(r.tolist()) for r in idx}) > 60


def test_triangulate_matches_jax():
    """ops/triangulate: points within 1e-4 relative of the JAX version's,
    the same ok mask, parallax cosines within 1e-6."""
    rng = np.random.default_rng(7)
    x1, x2, vis, R21, t21 = scene("general", rng)
    R, t = R21.astype(np.float32), t21.astype(np.float32)
    X_j, ok_j = jtri.triangulate(JSE3.identity(), jnp.asarray(x1),
                                 JSE3(jnp.asarray(R), jnp.asarray(t)),
                                 jnp.asarray(x2))
    T2 = SE3(torch.from_numpy(R), torch.from_numpy(t))
    X_t, ok_t = tri.triangulate(SE3.identity(), torch.from_numpy(x1), T2,
                                torch.from_numpy(x2))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    v = vis & np.asarray(ok_j)
    rel = np.abs(X_t.numpy() - np.asarray(X_j))[v].max(1) / np.abs(
        np.asarray(X_j))[v, 2]
    assert rel.max() < 1e-4
    np.testing.assert_allclose(
        tri.parallax_cos(SE3.identity(), T2, X_t).numpy()[v],
        np.asarray(jtri.parallax_cos(
            JSE3.identity(), JSE3(jnp.asarray(R), jnp.asarray(t)), X_j))[v],
        atol=1e-6)
