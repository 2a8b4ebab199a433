"""The port's place recognition against the JAX package: the vocabulary
(bundled and trained), the keyframe database, PnP and the Sim3 solver, and
the System's relocalisation after a blackout.

Same seeded numpy inputs through both packages. Tolerances: word ids,
BoW vectors' supports and candidate lists exactly equal; BoW weights and
scores within 1e-6; the deterministic solvers (``_pnp_dlt``,
``_ml_refine``, ``horn_sim3``, ``refine_sim3_gn``) within 1e-4 on
rotations and 1e-3 on translations and scales (the port solves the DLT's
and Horn's eigenproblems in float64); each RANSAC on JAX's own minimal
sets, injected, to the same tolerances with >= 99 % of the inlier mask
equal. The gates of ``tests/test_placerec.py`` hold on the port's own
results. The blackout scenario mirrors ``test_relocalization_after_blackout``
at 376x240 with 512 features (world seed 5: at this size seed 5
initialises at frame 12 and holds 11 keyframes by frame 30).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import so3 as jso3
from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.placerec import keyframe_db as jkdb
from orb_slam3_detailed_comments_tpu.placerec import pnp as jpnp
from orb_slam3_detailed_comments_tpu.placerec import sim3_solver as jsim3
from orb_slam3_detailed_comments_tpu.placerec import vocab as jvocab
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.ops import extractor
from orb_slam3_detailed_comments_tpu_torch.pipeline import (
    kernels, system, tracking)
from orb_slam3_detailed_comments_tpu_torch.placerec import (
    keyframe_db, pnp, sim3_solver, vocab)
from orb_slam3_detailed_comments_tpu_torch.utils import synth_render

from test_placerec import perturb_desc, random_desc

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(d):
    return _t(np.ascontiguousarray(d).view(np.int32))


@pytest.fixture(scope="module")
def bundled():
    return vocab.load(), jvocab.load(str(vocab.DEFAULT_PATH))


def test_bundled_vocab_is_read_by_path(bundled):
    voc, jvoc = bundled
    assert vocab.DEFAULT_PATH.name == "default_vocab.npz"
    assert (voc.k, voc.levels, voc.n_words) == (10, 6, 10 ** 6)
    assert voc.centroids[5].shape == (10 ** 6, 8)
    assert voc.centroids[5].dtype == torch.int32
    np.testing.assert_array_equal(voc.idf, np.asarray(jvoc.idf))
    assert vocab.load() is voc          # read once a process and device


def test_transform_on_bundled_vocab_equals_jax(bundled):
    """Word ids of random descriptors, of perturbed copies and of real ORB
    descriptors of a rendered frame, exactly JAX's."""
    voc, jvoc = bundled
    rng = np.random.default_rng(11)
    d = random_desc(rng, 600)
    d = np.concatenate([d, perturb_desc(rng, d[:200], bits=3)])
    cam = cameras.pinhole(229.0, 228.5, 188.0, 120.0, 376, 240)
    img = synth_render.render_image(
        cam, synth_render.default_world(np.random.default_rng(3)),
        *[a[0] for a in synth_render.orbit_trajectory(2)], "cpu")
    prep = kernels.prepare_frame(img, cam, extractor.OrbConfig(n_features=512))
    real = prep.feat.desc.numpy().view(np.uint32)
    d = np.concatenate([d, real])
    valid = np.ones(len(d), bool)
    valid[::7] = False
    w = vocab.transform(voc, _i32(d), _t(valid)).numpy()
    jw = np.asarray(jvocab.transform(jvoc, jnp.asarray(d), jnp.asarray(valid)))
    np.testing.assert_array_equal(w, jw)
    assert (w[~valid] == -1).all() and (w[valid] >= 0).all()
    ids, ws = vocab.bow_sparse(voc, w, 512)
    jids, jws = jvocab.bow_sparse(jvoc, jw, 512)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(ws, jws, atol=1e-6)
    v = vocab.bow_vector(voc, torch.from_numpy(w[:300]))
    jv = np.asarray(jvocab.bow_vector(jvoc, jnp.asarray(jw[:300])))
    nz = np.nonzero(jv)[0]
    np.testing.assert_array_equal(np.nonzero(v.numpy())[0], nz)
    np.testing.assert_allclose(v.numpy()[nz], jv[nz], rtol=1e-5)


class TestTrainedVocab:
    @pytest.fixture(scope="class")
    def vocs(self):
        train = random_desc(np.random.default_rng(0), 8000)
        return (vocab.train(train, k=8, levels=3, seed=1),
                jvocab.train(train, k=8, levels=3, seed=1))

    def test_train_matches_jax(self, vocs):
        voc, jvoc = vocs
        for c, jc in zip(voc.centroids, jvoc.centroids):
            np.testing.assert_array_equal(c.numpy().view(np.uint32),
                                          np.asarray(jc))
        np.testing.assert_allclose(voc.idf, np.asarray(jvoc.idf), atol=1e-6)

    def test_similar_descriptors_and_scoring(self, vocs, rng):
        """The gates of test_placerec's TestVocab on the port."""
        voc, _ = vocs
        ones = torch.ones(300, dtype=torch.bool)
        a = random_desc(rng, 300)
        a2 = perturb_desc(rng, a, bits=4)
        w1 = vocab.transform(voc, _i32(a), ones).numpy()
        w2 = vocab.transform(voc, _i32(a2), ones).numpy()
        assert w1.shape == (300,) and (w1 >= 0).all() and (
            w1 < voc.n_words).all()
        assert (w1 == w2).mean() > 0.5
        b = random_desc(rng, 300)
        an = perturb_desc(rng, a, bits=6)
        va, va2, vb = (vocab.bow_vector(voc, vocab.transform(voc, _i32(x),
                                                             ones))
                       for x in (a, an, b))
        assert float(va @ va2) > 1.5 * float(va @ vb)

    def test_save_load_roundtrip(self, vocs, tmp_path, rng):
        voc, jvoc = vocs
        p = tmp_path / "voc.npz"
        vocab.save(voc, str(p))
        d = random_desc(rng, 50)
        ones = torch.ones(50, dtype=torch.bool)
        w2 = vocab.transform(vocab.load(p), _i32(d), ones).numpy()
        np.testing.assert_array_equal(vocab.transform(voc, _i32(d),
                                                      ones).numpy(), w2)
        # the file is the JAX package's format
        jw = np.asarray(jvocab.transform(jvocab.load(str(p)), jnp.asarray(d),
                                         jnp.ones(50, bool)))
        np.testing.assert_array_equal(w2, jw)


def _place_maps(voc_pair, n_places=4, per_place=3, n_feat=128, seed=4):
    """A JAX map and the port's copy: n_places places of 150 points each;
    each keyframe observes 100 of its place's points with perturbed
    descriptors (so keyframes of one place are covisible), plus one
    unlinked query keyframe per place."""
    rng = np.random.default_rng(seed)
    cfg = dict(max_kf=32, max_pt=1024, n_feat=n_feat)
    jm = jms.MapStore(jms.MapConfig(**cfg))
    pdesc = random_desc(rng, n_places * 150)
    jm.pt_valid[:len(pdesc)] = True
    jm.pt_desc[:len(pdesc)] = pdesc
    z2, z1 = np.zeros((n_feat, 2), np.float32), np.zeros(n_feat, np.float32)
    queries = []
    for p in range(n_places):
        for j in range(per_place + 1):
            ids = p * 150 + rng.choice(150, 100, replace=False)
            desc = np.zeros((n_feat, 8), np.uint32)
            desc[:100] = perturb_desc(rng, pdesc[ids], bits=3)
            fp = np.full(n_feat, -1, np.int32)
            if j < per_place:
                fp[:100] = ids
            valid = np.arange(n_feat) < 100
            k = jm.add_keyframe(np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32), 0.1 * len(queries),
                                p * 10 + j, z2, z2, np.zeros(n_feat, np.int32),
                                z1, desc, valid, fp)
            if j == per_place:
                queries.append(k)
    arrays = {k: v for k, v in vars(jm).items() if isinstance(v, np.ndarray)}
    m = mapstore.MapStore.from_numpy(arrays, mapstore.MapConfig(**cfg), "cpu")
    return jm, m, queries


def test_keyframe_database_candidates_equal_jax(bundled):
    voc, jvoc = bundled
    jm, m, queries = _place_maps(bundled)
    db = keyframe_db.KeyFrameDatabase(voc, 4)
    jdb = jkdb.KeyFrameDatabase(jvoc, 4)
    for k in m.kf_ids():
        db.add(int(k), m.kf_feat_desc[k], m.kf_feat_valid[k])
        jdb.add(int(k), jm.kf_feat_desc[k], jm.kf_feat_valid[k])
    assert db.max_kf == jdb.max_kf >= 16       # grown past the first 4
    db.erase(1)
    jdb.erase(1)
    for q in queries:
        s = db.query_scores(m.kf_feat_desc[q], m.kf_feat_valid[q])
        js = jdb.query_scores(jm.kf_feat_desc[q], jm.kf_feat_valid[q])
        np.testing.assert_allclose(s, js, atol=1e-6)
        c = db.detect_candidates(m, q, n_best=3)
        assert c == jdb.detect_candidates(jm, q, n_best=3)
        assert c and c[0] // 4 == q // 4         # its own place first
        r = db.detect_relocalization_candidates(m, m.kf_feat_desc[q],
                                                m.kf_feat_valid[q])
        assert r == jdb.detect_relocalization_candidates(
            jm, jm.kf_feat_desc[q], jm.kf_feat_valid[q])
        assert 1 not in r
    db.clear()
    assert db.query_scores(m.kf_feat_desc[0], m.kf_feat_valid[0]).max() == 0


def _jax_sets(key, valid, n_hyp, size):
    g = jax.random.uniform(key, (n_hyp, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -1.0)
    return np.asarray(jax.lax.top_k(g, size)[1])


def _pnp_case(rng, N=200, n_bad=60):
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                  rng.uniform(0, 2, N)], 1).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray([0.2, -0.3, 0.1], jnp.float32)))
    t = np.array([0.5, -0.3, 6.0], np.float32)
    pc = X @ R.T + t
    xn = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.4 / 460, (N, 2))
    xn[:n_bad] = rng.uniform(-0.4, 0.4, (n_bad, 2))
    return X, xn.astype(np.float32), R, t


class TestPnP:
    def test_dlt_and_ml_refine_match_jax(self, rng):
        """The DLT on 40-point sets: the port's rotation is the truth's for
        every set; JAX keeps the null vector's sign that eigh returns, and
        where that sign is the right one (its rotation near the truth) the
        two agree (the port takes the sign with det P[:, :3] > 0)."""
        X, xn, R, t = _pnp_case(rng, n_bad=0)
        sets = np.argsort(rng.random((16, len(X))), axis=1)[:, :40]
        R_p, t_p = pnp._pnp_dlt(_t(X[sets]), _t(xn[sets]))
        R_j, t_j = jpnp._pnp_dlt(jnp.asarray(X[sets]), jnp.asarray(xn[sets]))
        R_j, t_j = np.asarray(R_j), np.asarray(t_j)
        assert np.abs(R_p.numpy() - R).max() < 0.01
        assert np.abs(t_p.numpy() - t).max() < 0.1
        right = np.abs(R_j - R).max(axis=(1, 2)) < 0.05
        assert right.sum() >= 2
        np.testing.assert_allclose(R_p.numpy()[right], R_j[right], atol=1e-3)
        np.testing.assert_allclose(t_p.numpy()[right], t_j[right], atol=2e-2)
        bear = np.concatenate([xn, np.ones((len(xn), 1), np.float32)], 1)
        bear /= np.linalg.norm(bear, axis=1, keepdims=True)
        w = np.ones(len(X), np.float32)
        R0 = (R @ np.asarray(jso3.exp(jnp.asarray([0.02, 0.0, -0.01],
                                                  jnp.float32)))).astype(
            np.float32)
        t0 = (t + 0.05).astype(np.float32)
        Rm, tm = pnp._ml_refine(_t(R0), _t(t0), _t(X), _t(bear), _t(w))
        Rj, tj = jpnp._ml_refine(jnp.asarray(R0), jnp.asarray(t0),
                                 jnp.asarray(X), jnp.asarray(bear),
                                 jnp.asarray(w))
        np.testing.assert_allclose(Rm.numpy(), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(tm.numpy(), np.asarray(tj), atol=1e-3)
        np.testing.assert_allclose(Rm.numpy(), R, atol=2e-3)

    def test_ransac_on_shared_samples_matches_jax(self, rng):
        X, xn, R, t = _pnp_case(rng)
        valid = np.ones(len(X), bool)
        valid[-5:] = False
        key = jax.random.PRNGKey(0)
        sets = _jax_sets(key, valid, 256, 6)
        mine = pnp.solve_pnp_ransac(_t(X), _t(xn), _t(valid),
                                    sample_idx=_t(sets))
        ref = jpnp.solve_pnp_ransac(jnp.asarray(X), jnp.asarray(xn),
                                    jnp.asarray(valid), key)
        np.testing.assert_allclose(mine.R.numpy(), np.asarray(ref.R),
                                   atol=1e-4)
        np.testing.assert_allclose(mine.t.numpy(), np.asarray(ref.t),
                                   atol=1e-3)
        assert (mine.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
        # test_placerec's gates on the port
        assert bool(mine.ok)
        dR = mine.R.numpy() @ R.T
        ang = np.linalg.norm(np.asarray(jso3.log(jnp.asarray(dR))))
        assert ang < 0.01 and np.linalg.norm(mine.t.numpy() - t) < 0.05
        assert int(mine.n_inliers) > 0.8 * (len(X) - 60)
        # a generator draws its own sets, over the valid rows only
        g = pnp.solve_pnp_ransac(_t(X), _t(xn), _t(valid),
                                 torch.Generator().manual_seed(3))
        assert bool(g.ok)
        s = pnp.sample_sets(_t(valid), 64, 6, torch.Generator().manual_seed(3))
        assert s.shape == (64, 6) and valid[s.numpy()].all()


def _sim3_case(rng, N=120, n_bad=30, s=1.4):
    x2 = rng.uniform(-2, 2, (N, 3)).astype(np.float32) + [0, 0, 5]
    R = np.asarray(jso3.exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t = np.array([0.4, -0.2, 0.6], np.float32)
    x1 = (s * x2 @ R.T + t).astype(np.float32)
    xn1 = (x1[:, :2] / x1[:, 2:3]
           + rng.normal(0, 0.3 / 460, (N, 2))).astype(np.float32)
    xn2 = (x2[:, :2] / x2[:, 2:3]
           + rng.normal(0, 0.3 / 460, (N, 2))).astype(np.float32)
    x2c = x2.astype(np.float32).copy()
    x2c[:n_bad] += rng.uniform(0.5, 2.0, (n_bad, 3)).astype(np.float32)
    return x1, x2c, xn1, xn2, R, t


class TestSim3:
    def test_horn_matches_jax(self, rng):
        x1, x2, _, _, R, t = _sim3_case(rng, n_bad=0)
        sets = np.argsort(rng.random((32, len(x1))), axis=1)[:, :3]
        for fix in (False, True):
            mine = sim3_solver.horn_sim3(_t(x2[sets]), _t(x1[sets]), fix)
            ref = jsim3.horn_sim3(jnp.asarray(x2[sets]), jnp.asarray(x1[sets]),
                                  fix)
            for a, b in zip(mine, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-3, rtol=1e-4)

    @pytest.mark.parametrize("fix_scale", [False, True])
    def test_ransac_and_refine_on_shared_samples_match_jax(self, rng,
                                                           fix_scale):
        x1, x2, xn1, xn2, R, t = _sim3_case(rng, s=1.0 if fix_scale else 1.4)
        valid = np.ones(len(x1), bool)
        key = jax.random.PRNGKey(0)
        sets = _jax_sets(key, valid, 128, 3)
        args = (x1, x2, valid, xn1, xn2)
        mine = sim3_solver.solve_sim3_ransac(*map(_t, args),
                                             fix_scale=fix_scale,
                                             sample_idx=_t(sets))
        ref = jsim3.solve_sim3_ransac(*map(jnp.asarray, args), key,
                                      fix_scale=fix_scale)
        for a, b in zip(mine[:3], ref[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
        assert (mine.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
        assert bool(mine.ok)
        if fix_scale:
            assert float(mine.s) == 1.0
        else:
            assert abs(float(mine.s) - 1.4) < 0.02
            assert mine.inliers.numpy()[:30].sum() < 5
        np.testing.assert_allclose(mine.R.numpy(), R, atol=5e-3)
        np.testing.assert_allclose(mine.t.numpy(), t, atol=3e-2)
        rm = sim3_solver.refine_sim3_gn(mine.R, mine.t, mine.s, _t(x1),
                                        _t(x2), _t(xn1), _t(xn2), _t(valid),
                                        fix_scale=fix_scale)
        rj = jsim3.refine_sim3_gn(ref.R, ref.t, ref.s, *map(
            jnp.asarray, (x1, x2, xn1, xn2, valid)), fix_scale=fix_scale)
        for a, b in zip(rm[:3], rj[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
        assert abs(int(rm.n_inliers) - int(rj.n_inliers)) <= 1

    def test_refine_beats_ransac_and_holds_unit_scale(self, rng):
        """test_placerec's TestRefineSim3GN gates, on the port."""
        from test_placerec import TestRefineSim3GN
        x1, x2, xn1, xn2, R_gt, t_gt, s_gt, f = TestRefineSim3GN._pairs(
            None, rng)
        valid = _t(np.ones(len(x1), bool))
        s3 = sim3_solver.solve_sim3_ransac(
            _t(x1), _t(x2), valid, _t(xn1), _t(xn2),
            torch.Generator().manual_seed(0), focal=f)
        ref = sim3_solver.refine_sim3_gn(s3.R, s3.t, s3.s, _t(x1), _t(x2),
                                         _t(xn1), _t(xn2), valid, focal=f)
        assert (np.linalg.norm(ref.t.numpy() - t_gt)
                < np.linalg.norm(s3.t.numpy() - t_gt))
        assert abs(float(ref.s) - s_gt) < 0.01 and int(ref.n_inliers) >= 30
        x1 = (x2 @ R_gt.T + t_gt).astype(np.float32)
        xn1 = (x1[:, :2] / x1[:, 2:3]).astype(np.float32)
        s3 = sim3_solver.solve_sim3_ransac(
            _t(x1), _t(x2), valid, _t(xn1), _t(xn2),
            torch.Generator().manual_seed(0), focal=f, fix_scale=True)
        ref = sim3_solver.refine_sim3_gn(s3.R, s3.t, s3.s, _t(x1), _t(x2),
                                         _t(xn1), _t(xn2), valid, focal=f,
                                         fix_scale=True)
        assert abs(float(ref.s) - 1.0) < 1e-6 and int(ref.n_inliers) >= 30


def test_relocalization_after_blackout():
    """test_relocalization_after_blackout's gates on the port's System."""
    cam = cameras.pinhole(229.0, 228.5, 188.0, 120.0, 376, 240)
    n = 46
    planes = synth_render.default_world(np.random.default_rng(5))
    R, t = synth_render.orbit_trajectory(n)
    frames = [synth_render.render_image(cam, planes, R[i], t[i], "cpu")
              for i in range(n)]
    slam = system.System(
        cam, system.MONOCULAR,
        map_cfg=mapstore.MapConfig(max_kf=32, max_pt=2048, n_feat=512),
        tracking_cfg=tracking.TrackingConfig(n_features=512,
                                             min_init_matches=50,
                                             max_frames=4), device="cpu")
    ts = np.arange(n) * 0.05
    for i in range(30):
        slam.track_monocular(frames[i], float(ts[i]))
    assert slam.tracker.state == tracking.OK
    assert slam.map.n_kf > 5
    blank = torch.full_like(frames[0], 128.0)
    for i in range(30, 36):
        slam.track_monocular(blank, float(ts[i]))
    assert slam.tracker.state != tracking.OK
    recovered = any(slam.track_monocular(frames[i], float(ts[i] + 0.6))
                    is not None for i in range(26, 30))
    assert recovered
    prep = kernels.prepare_frame(frames[20], cam, slam.tracker.orb_cfg)
    out = slam._relocalize(prep)
    assert out is not None
    R_o, t_o, match_pt, ref = out
    assert (match_pt >= 0).sum() >= 15
    assert np.isfinite(R_o).all() and np.isfinite(t_o).all()
    # the pose is the frame's (the map's gauge is the first keyframe's)
    assert slam.map.kf_valid[ref]
