"""The port's atlas checkpoints (``utils/serialization``,
``System.save_atlas`` / ``load_atlas``) on the CPU: the round trips of
``tests/test_persistence_config.py`` (``test_atlas_roundtrip``,
``test_grown_map_and_imu_state_roundtrip``, ``test_checksum_guard``)
ported; a file written by the JAX package loads into the port, and one
written by the port loads into the JAX package, with every array equal
(two maps, a keyframe redirect, the inertial block, descriptors as uint32
words on disk); and ``test_localize_against_loaded_atlas`` at 376x240 (512
features, world seed 3, ``min_init_matches`` 50, the first 30 frames of
the 60-frame orbit: at this size the 30-frame orbit, whose frames lie
twice as far apart, initialises only at its last frame).
"""
import zipfile

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_tpu.mapping import atlas as jatlas
from orb_slam3_detailed_comments_tpu.mapping import mapstore as jms
from orb_slam3_detailed_comments_tpu.utils import serialization as jser
from orb_slam3_detailed_comments_tpu_torch.mapping.atlas import Atlas
from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
    MapConfig, MapStore)
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system, tracking
from orb_slam3_detailed_comments_tpu_torch.utils import (serialization,
                                                         synth_render)

from test_persistence_config import tiny_map as jax_tiny_map

torch.set_num_threads(2)

CFG = MapConfig(max_kf=16, max_pt=256, n_feat=64)
JCFG = jms.MapConfig(max_kf=16, max_pt=256, n_feat=64)
ARRAYS = serialization._MAP_ARRAYS


def tiny_map(rng, n_kf=3, origin=0.0):
    """The port's copy of test_persistence_config.tiny_map."""
    m = MapStore(CFG, device="cpu")
    m.pt_xyz[:20] = (rng.normal(0, 1, (20, 3))
                     + [origin, 0, 5]).astype(np.float32)
    m.pt_valid[:20] = True
    m.pt_ref_kf[:20] = 0
    for k in range(n_kf):
        fp = np.full(64, -1, np.int32)
        fp[:20] = np.arange(20)
        m.add_keyframe(
            np.eye(3, dtype=np.float32),
            np.array([origin + 0.1 * k, 0, 0], np.float32), k * 0.1, k,
            rng.normal(300, 50, (64, 2)).astype(np.float32),
            rng.normal(0, 0.3, (64, 2)).astype(np.float32),
            rng.integers(0, 8, 64).astype(np.int32),
            np.zeros(64, np.float32),
            rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32).view(np.int32),
            np.ones(64, bool), fp)
    m.update_point_stats(np.arange(20))
    return m


def _with_imu(m, rng):
    m.kf_vel[:3] = rng.normal(0, 1, (3, 3)).astype(np.float32)
    m.kf_bg[:3] = 0.01
    m.kf_prev[1:3] = [0, 1]
    m.kf_pre_dT[1:3] = 0.25
    m.kf_pre_C[1:3] = np.eye(15, dtype=np.float32) * 1e-4
    m.imu_initialized = m.imu_ba1 = True
    return m


def _assert_atlas_equal(port, jax_):
    assert port.active_id == jax_.active_id
    assert len(port.maps) == len(jax_.maps)
    for pm, jm in zip(port.maps, jax_.maps):
        for k in ARRAYS:
            a = getattr(pm, k)
            if k in ("kf_feat_desc", "pt_desc"):
                a = a.view(np.uint32)
            np.testing.assert_array_equal(a, getattr(jm, k), err_msg=k)
        assert (pm.imu_initialized, pm.imu_ba1, pm.imu_ba2) == (
            jm.imu_initialized, jm.imu_ba1, jm.imu_ba2)
        assert pm.cfg.max_kf == jm.cfg.max_kf and pm.cfg.max_pt == \
            jm.cfg.max_pt
    assert port.kf_redirect.keys() == jax_.kf_redirect.keys()
    for key, v in port.kf_redirect.items():
        w = jax_.kf_redirect[key]
        assert tuple(v[:3]) == tuple(w[:3])
        np.testing.assert_array_equal(v[3], np.asarray(w[3]))
        np.testing.assert_array_equal(v[4], np.asarray(w[4]))


REDIRECT = ((0, 2, 1), (1, 5, 2, np.eye(3, dtype=np.float32),
                        np.float32([0.1, 0.2, 0.3])))


def test_atlas_roundtrip(rng, tmp_path):
    a = Atlas(CFG, device="cpu")
    a.maps = [tiny_map(rng), tiny_map(rng, origin=5.0)]
    a.active_id = 1
    p = str(tmp_path / "atlas.zip")
    serialization.save_atlas(a, p)
    b = serialization.load_atlas(p, device="cpu")
    assert b.active_id == 1 and len(b.maps) == 2
    assert [m.map_id for m in b.maps] == [0, 1]
    np.testing.assert_array_equal(b.maps[0].pt_xyz, a.maps[0].pt_xyz)
    np.testing.assert_array_equal(b.maps[1].kf_feat_desc,
                                  a.maps[1].kf_feat_desc)
    assert b.maps[0].n_kf == 3


def test_grown_map_and_imu_state_roundtrip(rng, tmp_path):
    a = Atlas(CFG, device="cpu")
    m = _with_imu(tiny_map(rng), rng)
    old_K, old_P = m.cfg.max_kf, m.cfg.max_pt
    m.grow(grow_kf=True, grow_pt=True)
    assert m.cfg.max_kf == 2 * old_K and m.cfg.max_pt == 2 * old_P
    assert m.n_kf == 3 and m.n_points == 20
    a.maps = [m]
    p = str(tmp_path / "atlas.zip")
    serialization.save_atlas(a, p)
    m2 = serialization.load_atlas(p, device="cpu").maps[0]
    assert m2.cfg.max_kf == 2 * old_K
    for k in ("kf_vel", "kf_prev", "kf_pre_dT", "kf_pre_C"):
        np.testing.assert_array_equal(getattr(m2, k), getattr(m, k))
    assert m2.imu_initialized and m2.imu_ba1 and not m2.imu_ba2


def test_checksum_guard(rng, tmp_path):
    a = Atlas(CFG, device="cpu")
    a.maps = [tiny_map(rng)]
    p = str(tmp_path / "atlas.zip")
    serialization.save_atlas(a, p)
    data = open(p, "rb").read()
    idx = data.find(b"map_0.npz") + 2000
    p2 = str(tmp_path / "bad.zip")
    open(p2, "wb").write(data[:idx] + bytes([data[idx] ^ 0xFF])
                         + data[idx + 1:])
    with pytest.raises(Exception):
        serialization.load_atlas(p2, device="cpu")


def test_unknown_format_refused(tmp_path):
    p = str(tmp_path / "other.zip")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("header.json", '{"format": "something-else"}')
    with pytest.raises(ValueError, match="unknown atlas format"):
        serialization.load_atlas(p, device="cpu")


def test_jax_atlas_loads_into_the_port(rng, tmp_path):
    a = jatlas.Atlas(JCFG)
    m0 = jax_tiny_map(rng)
    m0.kf_vel[:3] = rng.normal(0, 1, (3, 3)).astype(np.float32)
    m0.kf_prev[1:3] = [0, 1]
    m0.kf_pre_dT[1:3] = 0.25
    m0.imu_initialized = True
    a.maps = [m0, jax_tiny_map(rng, origin=5.0)]
    a.active_id = 1
    a.kf_redirect[REDIRECT[0]] = REDIRECT[1]
    p = str(tmp_path / "jax.zip")
    jser.save_atlas(a, p)
    _assert_atlas_equal(serialization.load_atlas(p, device="cpu"), a)


def test_port_atlas_loads_into_jax(rng, tmp_path):
    a = Atlas(CFG, device="cpu")
    a.maps = [_with_imu(tiny_map(rng), rng), tiny_map(rng, origin=5.0)]
    a.maps[1].grow(grow_pt=True)
    a.active_id = 0
    a.kf_redirect[REDIRECT[0]] = REDIRECT[1]
    p = str(tmp_path / "port.zip")
    serialization.save_atlas(a, p)
    _assert_atlas_equal(a, jser.load_atlas(p))


def test_localize_against_loaded_atlas(tmp_path):
    cam = cameras.pinhole(fx=229.0, fy=228.5, cx=188.0, cy=120.0,
                          width=376, height=240)
    planes = synth_render.default_world(np.random.default_rng(3))
    n = 30
    R, t = synth_render.orbit_trajectory(60)
    frames = [synth_render.render_frame_raycast(cam, planes, R[i], t[i])[0]
              for i in range(n)]
    ts = np.arange(n) * 0.05

    def make():
        return system.System(
            cam, system.MONOCULAR,
            map_cfg=MapConfig(max_kf=32, max_pt=2048, n_feat=512),
            tracking_cfg=tracking.TrackingConfig(n_features=512,
                                                 min_init_matches=50),
            device="cpu")

    slam = make()
    for i in range(n):
        slam.track_monocular(frames[i], float(ts[i]))
    assert slam.map.n_kf >= 3
    p = str(tmp_path / "session.zip")
    slam.save_atlas(p)

    slam2 = make()
    slam2.load_atlas(p)
    assert slam2.map.n_kf == slam.map.n_kf
    assert slam2.tracker.map is slam2.map and slam2.local_mapper.map is \
        slam2.map
    assert slam2.get_tracking_state() == tracking.LOST
    slam2.activate_localization_mode()
    slam2._build_recognition()
    for kk in slam2.map.kf_ids():
        slam2.kfdb.add(kk, slam2.map.kf_feat_desc[kk],
                       slam2.map.kf_feat_valid[kk])
    n_kf_before = slam2.map.n_kf
    ok = sum(slam2.track_monocular(frames[i], float(100.0 + i * 0.05))
             is not None for i in range(10, 20))
    assert ok >= 5, f"only {ok}/10 frames localised against the loaded map"
    assert slam2.map.n_kf == n_kf_before
