"""Atlas: the maps built by one System.

Counterpart of ``mapping/atlas.py`` of the JAX package (reference:
src/Atlas.cc): when tracking is lost for good a fresh map is spawned
(reference: Tracking::CreateMapInAtlas, Tracking.cc:3093), and trajectory
rows are replayed through the per-map tombstones. Every map lives on the
Atlas's device. Merging maps (``merge_map_into_active``) needs Sim3 and
place recognition and waits for a later slice.
"""
from __future__ import annotations

import numpy as np

from .. import device as device_mod
from .mapstore import MapConfig, MapStore


class Atlas:
    def __init__(self, map_cfg: MapConfig, device=None):
        self.map_cfg = map_cfg
        self.device = device_mod.resolve(device)
        self.maps: list = [MapStore(map_cfg, self.device)]
        self.active_id: int = 0
        # replay redirects for keyframes of merged maps:
        # (map_id, slot, epoch) -> (map_id', slot', epoch', R_rel, t_rel);
        # empty until merging is ported
        self.kf_redirect: dict = {}

    @property
    def active(self) -> MapStore:
        return self.maps[self.active_id]

    def new_store(self, map_id: int) -> MapStore:
        """An empty map on the Atlas's device, carrying map_id."""
        m = MapStore(self.map_cfg, self.device)
        m.map_id = map_id
        return m

    def create_new_map(self) -> MapStore:
        """(reference: Atlas::CreateNewMap, Atlas.cc:62)"""
        self.maps.append(self.new_store(len(self.maps)))
        self.active_id = len(self.maps) - 1
        return self.active

    def remove_bad_maps(self, min_kf: int = 3):
        """Clear failed mini-maps (reference: Atlas::RemoveBadMaps)."""
        for i, m in enumerate(self.maps):
            if i != self.active_id and 0 < m.n_kf < min_kf:
                self.maps[i] = self.new_store(i)
                # keep max(big_change_idx) monotone for System.map_changed
                self.maps[i].big_change_idx = m.big_change_idx

    def resolve_kf_pose(self, map_id: int, slot: int, epoch: int):
        """Trajectory replay: follow atlas redirects, then the map's
        tombstones. (R, t) world->camera, or None."""
        R_acc = np.eye(3, dtype=np.float32)
        t_acc = np.zeros(3, np.float32)
        for _ in range(8):
            key = (map_id, slot, epoch)
            if key in self.kf_redirect:
                map_id2, slot2, epoch2, R_rel, t_rel = self.kf_redirect[key]
                t_acc = R_acc @ t_rel + t_acc
                R_acc = R_acc @ R_rel
                map_id, slot, epoch = map_id2, slot2, epoch2
                continue
            out = self.maps[map_id].resolve_kf_pose(slot, epoch)
            if out is None:
                return None
            R, t = out
            return R_acc @ R, R_acc @ t + t_acc
        return None
