"""The port's matching module against the JAX package's (its XLA path, which
the JAX tests pin equal to the Pallas kernels on the CPU).

Exact equality of match indices, distances and validity on the valid
matches; both of the port's branches (the dense masked search of
``extra_mask`` and the best-2 kernels' plain versions) are exercised, at
128-multiple shapes and at others.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.ops import extractor as jext
from orb_slam3_detailed_comments_tpu.ops import matching as jm
from orb_slam3_detailed_comments_tpu_torch.ops import extractor, matching

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _desc_pair(rng, Q, K, n_true=200):
    """Targets, and queries that are noisy copies of some of them."""
    db = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint64).astype(np.uint32)
    da = rng.integers(0, 2 ** 32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.permutation(K)[:n_true]
    da[:n_true] = db[src]
    flips = rng.integers(0, 32, (n_true, 8))
    da[:n_true] ^= (rng.uniform(size=(n_true, 8)) < 0.3) * (
        np.uint32(1) << flips.astype(np.uint32))
    return da, db


def _check(res_t, res_j):
    vt = res_t.valid.numpy()
    np.testing.assert_array_equal(vt, np.asarray(res_j.valid))
    np.testing.assert_array_equal(res_t.idx.numpy()[vt],
                                  np.asarray(res_j.idx)[vt])
    np.testing.assert_array_equal(res_t.dist.numpy()[vt],
                                  np.asarray(res_j.dist)[vt])


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("Q,K", [(256, 384), (200, 300)])
def test_match_nn(rng, Q, K, mutual):
    """The unmasked search runs the best-2 search at any shape; JAX takes
    its Pallas path on 128-multiples and its dense search elsewhere, and
    both agree with the port."""
    da, db = _desc_pair(rng, Q, K)
    va = rng.uniform(size=Q) < 0.95
    vb = rng.uniform(size=K) < 0.95
    res_j = jm.match_nn(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db),
                        jnp.asarray(vb), mutual=mutual)
    res_t = matching.match_nn(_t(da.view(np.int32)), _t(va),
                              _t(db.view(np.int32)), _t(vb), mutual=mutual)
    _check(res_t, res_j)
    assert res_t.valid.sum() > 100


def test_match_nn_extra_mask(rng):
    da, db = _desc_pair(rng, 256, 256)
    v = np.ones(256, bool)
    extra = rng.uniform(size=(256, 256)) < 0.5
    res_j = jm.match_nn(jnp.asarray(da), jnp.asarray(v), jnp.asarray(db),
                        jnp.asarray(v), extra_mask=jnp.asarray(extra))
    res_t = matching.match_nn(_t(da.view(np.int32)), _t(v),
                              _t(db.view(np.int32)), _t(v),
                              extra_mask=_t(extra))
    _check(res_t, res_j)


def test_rotation_consistency_mask(rng):
    dang = np.concatenate([rng.normal(0.3, 0.02, 300),
                           rng.normal(-2.0, 0.02, 120),
                           rng.uniform(-7, 7, 80)]).astype(np.float32)
    dang[:5] = 0.0                               # on a bin edge
    valid = rng.uniform(size=len(dang)) < 0.9
    ref = jm.rotation_consistency_mask(jnp.asarray(dang), jnp.asarray(valid))
    got = matching.rotation_consistency_mask(_t(dang), _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # tied histogram bins: the first bin wins, as lax.top_k
    tie = np.repeat(np.arange(6, dtype=np.float32) * (2 * np.pi / 30) + 0.1, 5)
    ref = jm.rotation_consistency_mask(jnp.asarray(tie),
                                       jnp.ones(len(tie), bool))
    got = matching.rotation_consistency_mask(_t(tie),
                                             torch.ones(len(tie), dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _features(rng, n):
    xy = rng.uniform(0, 376, (n, 2)).astype(np.float32)
    level = rng.integers(0, 4, n).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.uniform(size=n) < 0.95
    score = np.zeros(n, np.float32)
    return xy, level, angle, score, desc, valid


def _both(arrs):
    xy, level, angle, score, desc, valid = arrs
    fj = jext.FrameFeatures(*(jnp.asarray(a) for a in arrs))
    ft = extractor.FrameFeatures(_t(xy), _t(level), _t(angle), _t(score),
                                 _t(desc.view(np.int32)), _t(valid))
    return ft, fj


@pytest.mark.parametrize("Q", [256, 250])
def test_search_by_projection(rng, Q):
    K = 256
    arrs = _features(rng, K)
    ft, fj = _both(arrs)
    xy, level, _, _, desc, _ = arrs
    src = rng.integers(0, K, Q)
    proj_xy = (xy[src] + rng.normal(0, 2.0, (Q, 2))).astype(np.float32)
    proj_desc = desc[src].copy()
    proj_desc[:, 0] ^= np.uint32(0xF)
    proj_level = np.clip(level[src] + rng.integers(-1, 2, Q), 0, 7).astype(np.int32)
    proj_valid = rng.uniform(size=Q) < 0.9
    radius = rng.uniform(2.0, 12.0, Q).astype(np.float32)
    taken = rng.uniform(size=K) < 0.1
    res_j = jm.search_by_projection(
        jnp.asarray(proj_xy), jnp.asarray(proj_valid), jnp.asarray(proj_desc),
        jnp.asarray(proj_level), fj, jnp.asarray(radius),
        taken=jnp.asarray(taken))
    res_t = matching.search_by_projection(
        _t(proj_xy), _t(proj_valid), _t(proj_desc.view(np.int32)),
        _t(proj_level), ft, _t(radius), taken=_t(taken))
    _check(res_t, res_j)
    assert res_t.valid.sum() > 50


def test_search_for_initialization(rng):
    arrs1 = list(_features(rng, 256))
    arrs1[1][:] = 0
    arrs2 = [a.copy() for a in arrs1]
    arrs2[0] = (arrs2[0] + rng.normal(0, 3, arrs2[0].shape)).astype(np.float32)
    arrs2[2] = (arrs2[2] + 0.05).astype(np.float32)
    perm = rng.permutation(256)
    arrs2 = [a[perm] for a in arrs2]
    f1t, f1j = _both(arrs1)
    f2t, f2j = _both(arrs2)
    _check(matching.search_for_initialization(f1t, f2t),
           jm.search_for_initialization(f1j, f2j))
