"""The port's map edits against the JAX package's, on one map snapshot in
both stores: remove_keyframe (with its tombstones), resolve_kf_pose through
a chain of tombstones, replace_point, fuse_observations and resolve_pid.
Both are numpy host code on both sides: the arrays must be exactly equal
afterwards. Also the Atlas, so3.to_quat and the timing registry.

The map is built with seeded numpy draws through the JAX store's own calls
and loaded into the port with ``MapStore.from_numpy``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_detailed_comments_tpu.lie import so3 as jso3
from orb_slam3_detailed_comments_tpu.mapping import atlas as jatlas
from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu_torch.lie import so3
from orb_slam3_detailed_comments_tpu_torch.mapping import atlas, mapstore
from orb_slam3_detailed_comments_tpu_torch.utils import timing

torch.set_num_threads(2)

K, P, N = 16, 1024, 128
N_KF = 12


def _jax_map(rng):
    """N_KF keyframes along x, each with fresh points and links to ~40
    points of the keyframes before it (so covisibility is dense)."""
    m = jms.MapStore(jms.MapConfig(max_kf=K, max_pt=P, n_feat=N))
    for k in range(N_KF):
        n_new = int(rng.integers(20, 50))
        xyz = rng.uniform(-3, 3, (n_new, 3)).astype(np.float32)
        xyz[:, 2] += 6.0
        desc = rng.integers(0, 2 ** 32, (n_new, 8),
                            dtype=np.uint64).astype(np.uint32)
        fp = np.full(N, -1, np.int32)
        live = np.where(m.pt_valid)[0]
        if len(live):
            seen = rng.choice(live, min(len(live), 40), replace=False)
            fp[rng.choice(N, len(seen), replace=False)] = seen
        slot = m.alloc_kf()
        ids = m.add_points(xyz, desc, slot)
        free = np.where(fp < 0)[0][:n_new]
        fp[free] = ids[:len(free)]
        w = rng.normal(0, 0.05, 3)
        R = np.asarray(jso3.exp(jnp.asarray(w, jnp.float32)))
        t = np.array([0.2 * k, 0.01 * k, 0.0], np.float32)
        m.add_keyframe(R, t, float(k), k, rng.uniform(0, 700, (N, 2)),
                       rng.uniform(-1, 1, (N, 2)), rng.integers(0, 8, N),
                       rng.uniform(-3, 3, N).astype(np.float32),
                       rng.integers(0, 2 ** 32, (N, 8),
                                    dtype=np.uint64).astype(np.uint32),
                       np.ones(N, bool), fp)
        m.kf_prev[slot] = slot - 1
    m.update_point_stats(np.where(m.pt_valid)[0])
    m.pt_found[:] = rng.integers(0, 5, P)
    m.pt_visible[:] = rng.integers(1, 8, P)
    return m


@pytest.fixture
def pair():
    jm = _jax_map(np.random.default_rng(5))
    tm = mapstore.MapStore.from_numpy(
        vars(jm), mapstore.MapConfig(max_kf=K, max_pt=P, n_feat=N), "cpu")
    return jm, tm


def _assert_same(jm, tm, invariants=True):
    for name, arr in tm.to_numpy().items():
        np.testing.assert_array_equal(arr, getattr(jm, name), err_msg=name)
    assert set(tm.tombstones) == set(jm.tombstones)
    for key, (s, e, R, t) in jm.tombstones.items():
        s2, e2, R2, t2 = tm.tombstones[key]
        assert (s2, e2) == (s, e)
        np.testing.assert_array_equal(R2, R)
        np.testing.assert_array_equal(t2, t)
    if invariants:                  # (resolving compresses the chains)
        assert tm.check_invariants() == jm.check_invariants()


def test_remove_keyframe_chain_and_resolve(pair):
    """Cull a keyframe, then the survivor its tombstone points to, and so
    on: a chain of 4 tombstones. Every culled keyframe then resolves to the
    same pose in both stores, and the chains are compressed alike."""
    jm, tm = pair
    culled, k = [], 3
    for _ in range(4):
        e = int(jm.kf_epoch[k])
        jm.remove_keyframe(k)
        tm.remove_keyframe(k)
        culled.append((k, e))
        _assert_same(jm, tm, invariants=False)
        k = jm.tombstones[(k, e)][0]
    hops, key = 0, culled[0]
    while key in tm.tombstones:
        key = tm.tombstones[key][:2]
        hops += 1
    assert hops == 4 and tm.kf_valid[key[0]]
    for slot, epoch in culled:
        rj = jm.resolve_kf_pose(slot, epoch)
        rt = tm.resolve_kf_pose(slot, epoch)
        assert rj is not None and rt is not None
        np.testing.assert_array_equal(rt[0], rj[0])
        np.testing.assert_array_equal(rt[1], rj[1])
    _assert_same(jm, tm)                     # compressed chains alike
    assert tm.resolve_kf_pose(3, 99) is None
    # a live keyframe resolves to its own pose
    R, t = tm.resolve_kf_pose(9, int(tm.kf_epoch[9]))
    np.testing.assert_array_equal(R, tm.kf_R[9])
    np.testing.assert_array_equal(t, tm.kf_t[9])


def test_remove_keyframe_kills_orphans_and_reanchors(pair):
    jm, tm = pair
    own = tm.kf_feat_point[11][tm.kf_feat_point[11] >= 0]
    obs = tm.observation_counts()
    only = own[obs[own] == 1]
    assert len(only) > 0
    jm.remove_keyframe(11)
    tm.remove_keyframe(11)
    _assert_same(jm, tm)
    assert not tm.pt_valid[only].any()
    assert not (tm.pt_ref_kf[tm.pt_valid] == 11).any()
    assert tm.kf_prev[tm.kf_prev >= 0].max() <= 10


def test_replace_point_and_resolve_pid(pair):
    jm, tm = pair
    pts = np.where(tm.pt_valid)[0]
    chain = [int(pts[3]), int(pts[40]), int(pts[90])]
    for old, new in ((chain[0], chain[1]), (chain[1], chain[2])):
        jm.replace_point(old, new)
        tm.replace_point(old, new)
        _assert_same(jm, tm)
    assert tm.resolve_pid(chain[0]) == jm.resolve_pid(chain[0]) == chain[2]
    dead = int(pts[120])
    jm.remove_points(np.array([dead]))
    tm.remove_points(np.array([dead]))
    assert tm.resolve_pid(dead) == jm.resolve_pid(dead) == -1
    assert tm.resolve_pid(-1) == -1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_observations_matches_jax(pair, seed):
    """Random fuse matches into a keyframe: replacements of the weaker
    point, new observations, skipped duplicates, dead and forwarded ids."""
    jm, tm = pair
    rng = np.random.default_rng(seed)
    live = np.where(tm.pt_valid)[0]
    old, new = int(live[7]), int(live[8])
    jm.replace_point(old, new)
    tm.replace_point(old, new)
    for kf in (2, 8, 11):
        pids = rng.choice(live, 60)
        pids[:3] = old                     # forwarded to new
        feats = rng.integers(0, N, 60)
        nj = jm.fuse_observations(kf, pids, feats)
        nt = tm.fuse_observations(kf, pids, feats)
        assert nt == nj and nt > 0
        _assert_same(jm, tm)


def test_covisibility_batch_and_point_observers(pair):
    jm, tm = pair
    ks = np.array([0, 4, 9])
    for (a, wa), (b, wb) in zip(tm.covisibility_batch(ks, 15),
                                jm.covisibility_batch(ks, 15)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(wa, wb)
    p = int(np.where(tm.pt_valid)[0][5])
    np.testing.assert_array_equal(tm.point_observers(p),
                                  jm.point_observers(p))
    assert tm.big_change_idx == jm.big_change_idx == 0


def test_atlas_maps_and_replay(pair):
    jm, tm = pair
    cfg = tm.cfg
    a = atlas.Atlas(cfg, "cpu")
    ja = jatlas.Atlas(jm.cfg)
    a.maps[0], ja.maps[0] = tm, jm
    for m in (tm, jm):
        m.remove_keyframe(4)
    np.testing.assert_array_equal(a.resolve_kf_pose(0, 4, 1)[0],
                                  ja.resolve_kf_pose(0, 4, 1)[0])
    m1 = a.create_new_map()
    ja.create_new_map()
    assert a.active is m1 and m1.map_id == 1 == ja.active.map_id
    assert m1.device == torch.device("cpu") and m1.n_kf == 0
    a.maps[0].big_change_idx = 3
    a.active_id = 1
    a.maps[0].kf_valid[2:] = False          # a mini-map of 2 keyframes
    a.remove_bad_maps()
    assert a.maps[0].n_kf == 0 and a.maps[0].big_change_idx == 3
    assert a.resolve_kf_pose(0, 4, 1) is None


def test_to_quat_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(200, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [np.pi - 1e-3, 0.0, 0.0]          # near pi: another pivot wins
    w[2] = [0.0, np.pi - 1e-3, 0.0]
    w[3] = [0.0, 0.0, np.pi - 1e-3]
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    q = so3.to_quat(torch.from_numpy(R.copy())).numpy()
    qj = np.asarray(jso3.to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(q, qj, atol=1e-6)
    # and it is the rotation: back through the JAX from_quat
    np.testing.assert_allclose(np.asarray(jso3.from_quat(jnp.asarray(q))), R,
                               atol=1e-5)


def test_timing_registry(monkeypatch):
    clock = iter([0.0, 0.001, 0.0, 0.002, 10.0, 10.5])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    timing.reset()
    with timing.span("MP culling"):
        pass
    with timing.span("MP culling"):
        pass
    with timing.span("local BA"):
        pass
    st = timing.stats()
    assert st["MP culling"][3] == 2 and st["local BA"][0] == 500.0
    assert timing.samples("local BA") == [0.5]
    assert timing.samples("missing") == []
    text = timing.print_time_stats()
    assert "local BA" in text and "MP culling" in text
    timing.enable(False)
    with timing.span("local BA"):
        pass
    timing.enable(True)
    assert len(timing.samples("local BA")) == 1
    timing.reset()


def test_capacity_grows_as_in_jax(pair):
    """A keyframe or point past capacity doubles it, arrays kept."""
    jm, tm = pair
    rng = np.random.default_rng(1)
    for _ in range(K - N_KF + 1):
        args = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 99.0,
                99, rng.uniform(0, 700, (N, 2)), rng.uniform(-1, 1, (N, 2)),
                rng.integers(0, 8, N), np.zeros(N, np.float32),
                rng.integers(0, 2 ** 32, (N, 8),
                             dtype=np.uint64).astype(np.uint32),
                np.ones(N, bool), np.full(N, -1, np.int32))
        assert tm.add_keyframe(*args) == jm.add_keyframe(*args)
    n_pt = P - tm.n_points + 5
    xyz = rng.uniform(-1, 1, (n_pt, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pt, 8), dtype=np.uint64).astype(
        np.uint32)
    np.testing.assert_array_equal(tm.add_points(xyz, desc, 0),
                                  jm.add_points(xyz, desc, 0))
    assert (tm.cfg.max_kf, tm.cfg.max_pt) == (jm.cfg.max_kf,
                                              jm.cfg.max_pt) == (2 * K, 2 * P)
    _assert_same(jm, tm)
    assert tm.device_kf_obs()["point_bits"].shape == (2 * K, 2 * P // 32)
