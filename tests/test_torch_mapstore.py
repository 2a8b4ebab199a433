"""The port's map store against the JAX package's.

One sequence of add_keyframe / add_points / update_point_stats calls goes
to both stores; the port's map is also built from the JAX map's arrays
(``MapStore.from_numpy(vars(m))``). The observation structure the tracker
reads (point bitsets, covisibility) must be equal, bit for bit.
"""
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore

torch.set_num_threads(2)

K, P, N = 16, 1024, 128


def _build(store_cls, cfg, rng, **kw):
    s = store_cls(cfg, **kw)
    for k in range(10):
        n_new = int(rng.integers(20, 60))
        xyz = rng.uniform(-3, 3, (n_new, 3)).astype(np.float32)
        xyz[:, 2] += 6.0
        desc = rng.integers(0, 2 ** 32, (n_new, 8),
                            dtype=np.uint64).astype(np.uint32)
        fp = np.full(N, -1, np.int32)
        live = np.where(s.pt_valid)[0]
        if len(live):
            seen = rng.choice(live, min(len(live), 40), replace=False)
            fp[rng.choice(N, len(seen), replace=False)] = seen
        slot = s.alloc_kf()
        ids = s.add_points(xyz, desc, slot)
        free = np.where(fp < 0)[0][:n_new]
        fp[free] = ids[:len(free)]
        ang = rng.uniform(-3, 3, (N,)).astype(np.float32)
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.1 * k, 0.0, 0.0], np.float32)
        kdesc = rng.integers(0, 2 ** 32, (N, 8),
                             dtype=np.uint64).astype(np.uint32)
        s.add_keyframe(R, t, float(k), k, rng.uniform(0, 700, (N, 2)),
                       rng.uniform(-1, 1, (N, 2)), rng.integers(0, 8, N),
                       ang, kdesc, np.ones(N, bool), fp)
    return s


@pytest.fixture
def stores():
    cfg_j = jms.MapConfig(max_kf=K, max_pt=P, n_feat=N)
    cfg_t = mapstore.MapConfig(max_kf=K, max_pt=P, n_feat=N)
    jm = _build(jms.MapStore, cfg_j, np.random.default_rng(9))
    tm = _build(mapstore.MapStore, cfg_t, np.random.default_rng(9),
                device="cpu")
    return jm, tm, cfg_t


def test_same_calls_same_arrays(stores):
    jm, tm, _ = stores
    for name, arr in tm.to_numpy().items():
        np.testing.assert_array_equal(arr, getattr(jm, name), err_msg=name)


def test_from_numpy_kf_obs_equal(stores):
    jm, _, cfg = stores
    tm = mapstore.MapStore.from_numpy(vars(jm), cfg, device="cpu")
    ko_t = tm.device_kf_obs()
    ko_j = jm.device_kf_obs()
    np.testing.assert_array_equal(ko_t["point_bits"].numpy().view(np.uint32),
                                  np.asarray(ko_j["point_bits"]))
    np.testing.assert_array_equal(ko_t["covis"].numpy(),
                                  np.asarray(ko_j["covis"]))
    np.testing.assert_array_equal(ko_t["feat_point"].numpy(),
                                  np.asarray(ko_j["feat_point"]))
    np.testing.assert_array_equal(ko_t["valid"].numpy(),
                                  np.asarray(ko_j["valid"]))
    dp_t, dp_j = tm.device_points(), jm.device_points()
    for key in ("xyz", "normal", "min_dist", "max_dist", "valid", "proj8"):
        np.testing.assert_array_equal(dp_t[key].numpy(), np.asarray(dp_j[key]))
    np.testing.assert_array_equal(dp_t["desc"].numpy().view(np.uint32),
                                  np.asarray(dp_j["desc"]))
    # the caches follow the version
    v = tm.version
    assert tm.device_kf_obs() is ko_t
    tm.add_points(np.zeros((1, 3), np.float32), np.zeros((1, 8), np.uint32), 0)
    assert tm.version == v + 1 and tm.device_points() is not dp_t


def test_update_point_stats_matches_jax(stores):
    jm, tm, _ = stores
    pids = np.where(tm.pt_valid)[0][::3]
    jm.update_point_stats(pids)
    tm.update_point_stats(pids)
    np.testing.assert_array_equal(tm.pt_desc.view(np.uint32), jm.pt_desc)
    np.testing.assert_array_equal(tm.pt_ref_kf, jm.pt_ref_kf)
    for name in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_to_numpy_roundtrip(stores):
    _, tm, cfg = stores
    back = mapstore.MapStore.from_numpy(tm.to_numpy(), cfg, device="cpu")
    for name, arr in tm.to_numpy().items():
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(tm, name), err_msg=name)
    assert back.pt_desc.dtype == np.int32
