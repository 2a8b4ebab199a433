"""The port's host library (``host_native``) against its numpy twins and
the JAX package's ``native``.

Mirrors ``tests/test_native_host.py`` and
``test_persistence_config.py::TestNativeLib``; holds every C++ entry to
its twin in ``host_native/plain.py``; pins the repair of the descriptor
median (an even number of observations takes the upper middle distance,
as the JAX package's C++ does, not ``np.median``'s mean of the two middle
ones); and checks that processes building the library at once leave one
whole library, and that a failed build raises.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu import native as jnative
from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu_torch import host_native
from orb_slam3_detailed_comments_tpu_torch.host_native import plain
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def world():
    rng = np.random.default_rng(3)
    K, N, P = 32, 256, 4096
    kf_valid = rng.uniform(size=K) < 0.8
    fp = np.where(rng.uniform(size=(K, N)) < 0.4,
                  rng.integers(0, P, (K, N)), -1).astype(np.int32)
    inc = np.zeros((K, P), bool)
    kk, ff = np.nonzero(fp >= 0)
    inc[kk, fp[kk, ff]] = True
    inc &= kf_valid[:, None]
    return kf_valid, fp, inc, P


def test_covis_counts_matches_incidence_matmul(world):
    kf_valid, fp, inc, P = world
    bits = host_native.build_incidence_bits(kf_valid, fp, P)
    ks = np.array([0, 5, 11, 31])
    W = host_native.covis_counts(bits, kf_valid, ks)
    Wref = inc[ks].astype(np.int32) @ inc.astype(np.int32).T
    assert np.array_equal(W, Wref)


def test_observers_of_matches_any(world):
    kf_valid, fp, inc, P = world
    bits = host_native.build_incidence_bits(kf_valid, fp, P)
    ids = np.random.default_rng(5).integers(0, P, 64)
    ob = host_native.observers_of(bits, kf_valid, ids, P)
    assert np.array_equal(ob, inc[:, ids].any(axis=1))
    one = host_native.observers_of(bits, kf_valid, ids[:1], P)
    assert np.array_equal(one, inc[:, ids[:1]].any(axis=1))


def test_mapstore_covisibility_bits_vs_incidence():
    """The MapStore's covisibility, counted on the bitsets, equals the
    [K, P] incidence product, and so does the matrix it builds."""
    rng = np.random.default_rng(9)
    m = mapstore.MapStore(mapstore.MapConfig(n_feat=128, max_kf=16,
                                             max_pt=1024), device="cpu")
    for k in range(6):
        m.kf_valid[k] = True
        m.kf_feat_point[k] = -1
        m.kf_feat_point[k, :64] = rng.integers(0, 300, 64)
    m.version += 1
    ks = [0, 2, 5]
    inc = m.incidence().astype(np.int32)
    assert np.array_equal(m._covis_weights(ks), inc[ks] @ inc.T)
    assert np.array_equal(m.covisibility_matrix(), inc @ inc.T)
    for k, (ids, w) in zip(ks, m.covisibility_batch(ks, min_weight=1)):
        row = (inc[k] @ inc.T).copy()
        row[k] = 0
        assert np.array_equal(np.sort(ids), np.nonzero(row >= 1)[0])
        assert np.array_equal(w, row[ids])
        assert (np.diff(w) <= 0).all()
        one = m.covisibility(k, min_weight=1)
        assert np.array_equal(one[0], ids) and np.array_equal(one[1], w)


def _random_map(rng, K=12, N=96, P=512, n_levels=8):
    """Host arrays of a map whose points have 1-9 observations, over some
    dead keyframes."""
    kf_valid = np.ones(K, bool)
    kf_valid[[3, 7]] = False
    fp = np.full((K, N), -1, np.int32)
    for k in range(K):
        pts = rng.choice(P, 60, replace=False)
        fp[k, rng.choice(N, 60, replace=False)] = pts
    desc = rng.integers(0, 2 ** 32, (K, N, 8), dtype=np.uint64)
    desc = desc.astype(np.uint32).view(np.int32)
    level = rng.integers(-1, n_levels + 1, (K, N)).astype(np.int32)
    ang = rng.normal(0, 0.3, (K, 3))
    R = np.stack([_rot(a) for a in ang]).astype(np.float32)
    t = rng.normal(0, 1, (K, 3)).astype(np.float32)
    xyz = rng.normal(0, 2, (P, 3)).astype(np.float32)
    xyz[:, 2] += 6
    ref = rng.integers(0, K, P).astype(np.int32)
    return dict(kf_valid=kf_valid, kf_feat_point=fp, kf_feat_desc=desc,
                kf_feat_level=level, kf_R=R, kf_t=t, pt_xyz=xyz,
                pt_ref_kf=ref)


def _rot(a):
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _stats(fn, arrays, pids, sf):
    a = {k: v.copy() for k, v in arrays.items()}
    P = a["pt_xyz"].shape[0]
    out = dict(pt_desc=np.zeros((P, 8), np.int32),
               pt_normal=np.zeros((P, 3), np.float32),
               pt_min_dist=np.zeros(P, np.float32),
               pt_max_dist=np.zeros(P, np.float32))
    n = fn(a["kf_valid"], a["kf_feat_point"], a["kf_feat_desc"],
           a["kf_feat_level"], a["kf_R"], a["kf_t"], a["pt_xyz"],
           a["pt_ref_kf"], pids, sf, out["pt_desc"], out["pt_normal"],
           out["pt_min_dist"], out["pt_max_dist"])
    out["pt_ref_kf"] = a["pt_ref_kf"]
    return n, out


@pytest.mark.parametrize("seed", [0, 1])
def test_update_point_stats_equals_its_twin(seed):
    rng = np.random.default_rng(seed)
    arrays = _random_map(rng)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    pids = np.concatenate([rng.choice(512, 300, replace=False), [5, 5, -1]])
    n_c, c = _stats(host_native.update_point_stats, arrays, pids, sf)
    n_p, p = _stats(plain.update_point_stats, arrays, pids, sf)
    assert n_c == n_p > 200
    np.testing.assert_array_equal(c["pt_desc"], p["pt_desc"])
    np.testing.assert_array_equal(c["pt_ref_kf"], p["pt_ref_kf"])
    np.testing.assert_allclose(c["pt_normal"], p["pt_normal"], atol=1e-6)
    np.testing.assert_allclose(c["pt_max_dist"], p["pt_max_dist"],
                               rtol=1e-6)
    np.testing.assert_allclose(c["pt_min_dist"], p["pt_min_dist"],
                               rtol=1e-6)


@pytest.mark.parametrize("entry", ["replace_point", "build_incidence_bits",
                                   "covis_counts", "observers_of",
                                   "observation_counts"])
def test_map_entry_equals_its_twin(entry):
    rng = np.random.default_rng(11)
    a = _random_map(rng)
    valid, fp, P = a["kf_valid"], a["kf_feat_point"], 512
    if entry == "replace_point":
        pairs = [(int(x), int(y)) for x, y in rng.integers(0, P, (40, 2))]
        c, p = fp.copy(), fp.copy()
        nc = [host_native.replace_point(valid, c, *xy) for xy in pairs]
        npl = [plain.replace_point(valid, p, *xy) for xy in pairs]
        assert nc == npl and sum(nc) > 0
        np.testing.assert_array_equal(c, p)
        return
    bits = host_native.build_incidence_bits(valid, fp, P)
    if entry == "build_incidence_bits":
        got, want = bits, plain.build_incidence_bits(valid, fp, P)
    elif entry == "covis_counts":
        ks = np.arange(12)
        got = host_native.covis_counts(bits, valid, ks)
        want = plain.covis_counts(bits, valid, ks)
    elif entry == "observers_of":
        ids = rng.integers(0, P, 7)
        got = host_native.observers_of(bits, valid, ids, P)
        want = plain.observers_of(bits, valid, ids, P)
    else:
        got = host_native.observation_counts(valid, fp, P)
        want = plain.observation_counts(valid, fp, P)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_png_unfilter_equals_its_twin():
    rng = np.random.default_rng(2)
    for height, stride, bpp in [(9, 40, 1), (7, 39, 3), (5, 64, 8),
                                (4, 6, 2)]:
        raw = rng.integers(0, 256, height * (stride + 1)).astype(np.uint8)
        raw[::stride + 1] = np.arange(height) % 5
        np.testing.assert_array_equal(
            host_native.png_unfilter(raw, height, stride, bpp),
            plain.png_unfilter(raw, height, stride, bpp))
        raw[(height - 1) * (stride + 1)] = 5
        for fn in (host_native.png_unfilter, plain.png_unfilter):
            with pytest.raises(ValueError, match=f"row {height - 1}"):
                fn(raw, height, stride, bpp)


# ---- the JAX package's MapStore and its native library --------------------

CFG = dict(max_kf=16, max_pt=256, n_feat=64)


def _tiny_jax_map(rng, n_kf):
    """tests/test_persistence_config.py::tiny_map with n_kf keyframes and
    the points' observers cut to an even count of 4-6 each."""
    m = jms.MapStore(jms.MapConfig(**CFG))
    m.pt_xyz[:20] = (rng.normal(0, 1, (20, 3)) + [0, 0, 5]).astype(
        np.float32)
    m.pt_valid[:20] = True
    m.pt_ref_kf[:20] = 0
    for k in range(n_kf):
        fp = np.full(64, -1, np.int32)
        fp[:20] = np.arange(20)
        # point p is seen by keyframes 0..(4 + 2 * (p % 2)) - 1
        fp[:20][k >= 4 + 2 * (np.arange(20) % 2)] = -1
        m.add_keyframe(
            np.eye(3, dtype=np.float32), np.array([0.1 * k, 0, 0],
                                                  np.float32),
            k * 0.1, k, rng.normal(300, 50, (64, 2)).astype(np.float32),
            rng.normal(0, 0.3, (64, 2)).astype(np.float32),
            rng.integers(0, 8, 64).astype(np.int32),
            np.zeros(64, np.float32),
            rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32),
            np.ones(64, bool), fp)
    return m


def _port_of(jm):
    return mapstore.MapStore.from_numpy(vars(jm), mapstore.MapConfig(**CFG),
                                        device="cpu")


def test_native_matches_numpy_twin_on_tiny_map(rng):
    """TestNativeLib's check, on the port: the library and its twin give
    the same descriptors, normals and scale ranges."""
    jm = _tiny_jax_map(rng, 3)
    tm = _port_of(jm)
    tm.update_point_stats(np.arange(20))
    arrays = {k: getattr(tm, k) for k in (
        "kf_valid", "kf_feat_point", "kf_feat_desc", "kf_feat_level",
        "kf_R", "kf_t", "pt_xyz", "pt_ref_kf")}
    _, p = _stats(plain.update_point_stats, arrays, np.arange(20),
                  tm._scale_factors.astype(np.float32))
    np.testing.assert_array_equal(tm.pt_desc[:20], p["pt_desc"][:20])
    np.testing.assert_allclose(tm.pt_normal[:20], p["pt_normal"][:20],
                               atol=1e-5)
    np.testing.assert_allclose(tm.pt_max_dist[:20], p["pt_max_dist"][:20],
                               rtol=1e-5)


@pytest.mark.skipif(not jnative.available,
                    reason="the JAX package's native library did not build")
def test_descriptor_median_is_the_upper_middle_as_jax_native(monkeypatch):
    """ROADMAP fault 3.1. On a map whose points have 4 or 6 observations,
    the port's representative descriptors equal the JAX package's C++
    path point for point, and the old rule (np.median, the JAX package's
    numpy fallback) picks another descriptor for at least one point."""
    jm = _tiny_jax_map(np.random.default_rng(1), 6)
    counts = jm.observation_counts()[:20]
    assert set(counts.tolist()) == {4, 6}
    tm = _port_of(jm)
    tm.update_point_stats(np.arange(20))
    jm.update_point_stats(np.arange(20))          # native C++
    np.testing.assert_array_equal(tm.pt_desc[:20].view(np.uint32),
                                  jm.pt_desc[:20])
    np.testing.assert_allclose(tm.pt_normal[:20], jm.pt_normal[:20],
                               atol=1e-6)
    np.testing.assert_allclose(tm.pt_max_dist[:20], jm.pt_max_dist[:20],
                               rtol=1e-6)
    fallback = _tiny_jax_map(np.random.default_rng(1), 6)
    monkeypatch.setattr(jnative, "available", False)
    fallback.update_point_stats(np.arange(20))
    differ = (fallback.pt_desc[:20] != jm.pt_desc[:20]).any(axis=1)
    assert differ.sum() >= 1, "no point where the two medians part"


def test_device_bits_equal_the_jax_packing(rng):
    """device_kf_obs uploads the library's bitsets viewed as int32 words;
    they equal the JAX package's pack_point_bits of the same rows."""
    jm = _tiny_jax_map(rng, 6)
    tm = _port_of(jm)
    got = tm.device_kf_obs()["point_bits"].numpy()
    want = jms.pack_point_bits(jm.kf_feat_point, CFG["max_pt"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.device_kf_obs()["covis"].numpy(),
                                  jm.covisibility_matrix())


# ---- the build ------------------------------------------------------------

def test_concurrent_builds_leave_one_valid_library(tmp_path):
    """20 processes force a build into one directory at once: each moves
    its own file into place, and the library left loads and computes."""
    code = (
        "import sys\nfrom pathlib import Path\n"
        "from orb_slam3_detailed_comments_tpu_torch import host_native as h\n"
        "h.BUILD_DIR = Path(sys.argv[1])\n"
        "h.LIB_PATH = h.BUILD_DIR / 'libslam_host.so'\n"
        "h.build(force=True)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stderr=subprocess.PIPE, text=True)
             for _ in range(20)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libslam_host.so"]
    check = (
        "import sys\nimport numpy as np\nfrom pathlib import Path\n"
        "from orb_slam3_detailed_comments_tpu_torch import host_native as h\n"
        "h.LIB_PATH = Path(sys.argv[1]) / 'libslam_host.so'\n"
        "h.BUILD_DIR = h.LIB_PATH.parent\n"
        "fp = np.array([[0, 1, -1], [1, 2, 3]], np.int32)\n"
        "c = h.observation_counts(np.ones(2, bool), fp, 4)\n"
        "assert c.tolist() == [1, 2, 1, 1], c\n"
        "assert h.n_builds == 0\n")
    out = subprocess.run([sys.executable, "-c", check, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( {\n")
    monkeypatch.setattr(host_native, "SOURCES", (bad,))
    monkeypatch.setattr(host_native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(host_native, "LIB_PATH",
                        tmp_path / "out" / "libslam_host.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_native.build()
    assert not (tmp_path / "out" / "libslam_host.so").exists()
    assert list((tmp_path / "out").iterdir()) == []
