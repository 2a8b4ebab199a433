"""Atlas checkpoints: save every map and resume from them.

Counterpart of ``utils/serialization.py`` of the JAX package, in the same
file format (reference: System::SaveAtlas / LoadAtlas, src/System.cc:1466,
1517): a zip holding ``header.json`` (the format name
``"tpu-slam-atlas-v1"``, the active map, the map config, the atlas's
keyframe redirects and an MD5 checksum of each map) and one compressed
``map_i.npz`` per map with its SoA arrays and ``imu_flags``. Descriptors
are written as the JAX package's uint32 words (the port holds them as
int32 with the same bits), so a file written by either package loads into
the other with every array equal.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import zipfile

import numpy as np

from ..mapping.atlas import Atlas
from ..mapping.mapstore import MapConfig, MapStore

FORMAT = "tpu-slam-atlas-v1"
_MAP_ARRAYS = [
    "kf_R", "kf_t", "kf_valid", "kf_ts", "kf_frame_id", "kf_epoch",
    "kf_feat_xy", "kf_feat_xyn", "kf_feat_level", "kf_feat_angle",
    "kf_feat_desc", "kf_feat_valid", "kf_feat_point",
    "pt_xyz", "pt_valid", "pt_desc", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_ref_kf", "pt_first_kf", "pt_found", "pt_visible",
    # the inertial block (the reference serialises mVw, mImuBias and
    # mpImuPreintegrated with each KeyFrame, KeyFrame.h:55-190)
    "kf_vel", "kf_bg", "kf_ba", "kf_prev", "kf_pre_dT", "kf_pre_dR",
    "kf_pre_dV", "kf_pre_dP", "kf_pre_C", "kf_pre_JRg", "kf_pre_JVg",
    "kf_pre_JVa", "kf_pre_JPg", "kf_pre_JPa", "kf_pre_bg0", "kf_pre_ba0",
]
_DESC = ("kf_feat_desc", "pt_desc")


def _map_to_npz_bytes(m: MapStore) -> bytes:
    arrays = {k: (getattr(m, k).view(np.uint32) if k in _DESC
                  else getattr(m, k)) for k in _MAP_ARRAYS}
    buf = io.BytesIO()
    np.savez_compressed(buf, imu_flags=np.asarray(
        [m.imu_initialized, m.imu_ba1, m.imu_ba2], bool), **arrays)
    return buf.getvalue()


def _map_from_npz_bytes(data: bytes, cfg: MapConfig, device) -> MapStore:
    z = np.load(io.BytesIO(data))
    # the capacities come from the file: a map grown past the atlas's
    # MapConfig loads at its grown size
    m = MapStore(dataclasses.replace(cfg, max_kf=len(z["kf_valid"]),
                                     max_pt=len(z["pt_valid"])), device)
    for k in _MAP_ARRAYS:
        if k not in z.files:        # older checkpoints lack the inertial block
            continue
        dst, a = getattr(m, k), z[k]
        if k in _DESC:
            a = np.ascontiguousarray(a).view(np.int32)
        if any(sa > sd for sa, sd in zip(a.shape, dst.shape)):
            raise ValueError(f"checkpoint array {k} {a.shape} exceeds the "
                             f"store's capacity {dst.shape}")
        # a capacity below the rounded max_pt loads into the store's head
        dst[tuple(slice(0, s) for s in a.shape)] = a
    if "imu_flags" in z.files:
        m.imu_initialized, m.imu_ba1, m.imu_ba2 = (bool(x)
                                                   for x in z["imu_flags"])
    m.version = 1
    return m


def save_atlas(atlas: Atlas, path: str):
    header = {
        "format": FORMAT,
        "active_id": atlas.active_id,
        "n_maps": len(atlas.maps),
        "map_cfg": {
            "max_kf": atlas.map_cfg.max_kf, "max_pt": atlas.map_cfg.max_pt,
            "n_feat": atlas.map_cfg.n_feat,
            "n_levels": atlas.map_cfg.n_levels,
            "scale": atlas.map_cfg.scale,
        },
        "kf_redirect": [
            [[int(x) for x in k],
             [int(v[0]), int(v[1]), int(v[2]), np.asarray(v[3]).tolist(),
              np.asarray(v[4]).tolist()]]
            for k, v in atlas.kf_redirect.items()
        ],
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        blobs = []
        for i, m in enumerate(atlas.maps):
            blob = _map_to_npz_bytes(m)
            blobs.append(blob)
            zf.writestr(f"map_{i}.npz", blob)
        header["checksums"] = [hashlib.md5(b).hexdigest() for b in blobs]
        zf.writestr("header.json", json.dumps(header))


def load_atlas(path: str, device=None) -> Atlas:
    """The Atlas of a checkpoint, its maps on ``device`` (the card unless
    given). Raises ValueError on an unknown format or a checksum that does
    not match."""
    with zipfile.ZipFile(path, "r") as zf:
        header = json.loads(zf.read("header.json"))
        if header.get("format") != FORMAT:
            raise ValueError(f"unknown atlas format in {path}")
        c = header["map_cfg"]
        cfg = MapConfig(max_kf=c["max_kf"], max_pt=c["max_pt"],
                        n_feat=c["n_feat"], n_levels=c["n_levels"],
                        scale=c["scale"])
        atlas = Atlas(cfg, device)
        atlas.maps = []
        for i in range(header["n_maps"]):
            blob = zf.read(f"map_{i}.npz")
            if hashlib.md5(blob).hexdigest() != header["checksums"][i]:
                raise ValueError(f"checksum mismatch for map_{i} in {path}")
            m = _map_from_npz_bytes(blob, cfg, atlas.device)
            m.map_id = i
            atlas.maps.append(m)
        atlas.active_id = header["active_id"]
        for k, v in header.get("kf_redirect", []):
            atlas.kf_redirect[tuple(k)] = (
                v[0], v[1], v[2],
                np.asarray(v[3], np.float32), np.asarray(v[4], np.float32))
    return atlas


def save_map(m: MapStore, path: str):
    with open(path, "wb") as f:
        f.write(_map_to_npz_bytes(m))


def load_map(path: str, cfg: MapConfig, device=None) -> MapStore:
    with open(path, "rb") as f:
        return _map_from_npz_bytes(f.read(), cfg, device)
