"""Atlas: the maps built by one System.

Counterpart of ``mapping/atlas.py`` of the JAX package (reference:
src/Atlas.cc): when tracking is lost for good a fresh map is spawned
(reference: Tracking::CreateMapInAtlas, Tracking.cc:3093), and trajectory
rows are replayed through the per-map tombstones and the merge redirects.
When place recognition finds the active map overlapping a stored one, the
stored map is welded into the active one through the verified Sim3
(``merge_map_into_active``; reference: LoopClosing::MergeLocal,
LoopClosing.cc:1590). Every map lives on the Atlas's device.
"""
from __future__ import annotations

import numpy as np

from .. import device as device_mod
from .mapstore import NO_POINT, MapConfig, MapStore


class Atlas:
    def __init__(self, map_cfg: MapConfig, device=None):
        self.map_cfg = map_cfg
        self.device = device_mod.resolve(device)
        self.maps: list = [MapStore(map_cfg, self.device)]
        self.active_id: int = 0
        # replay redirects for keyframes of merged maps:
        # (map_id, slot, epoch) -> (map_id', slot', epoch', R_rel, t_rel)
        self.kf_redirect: dict = {}
        self.n_merges = 0

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

    def merge_map_into_active(self, other_id: int, S_ao) -> dict:
        """Weld map ``other_id`` into the active map: an other-world point
        lands at x_a = S_ao(x_o) (S_ao a Sim3 of host tensors). Returns
        {other_slot: new_slot}; the other map's rows replay through
        ``kf_redirect`` (reference: LoopClosing::MergeLocal welding)."""
        act = self.active
        oth = self.maps[other_id]
        R_s = S_ao.R.cpu().numpy().astype(np.float64)
        t_s = S_ao.t.cpu().numpy().astype(np.float64)
        s_s = float(S_ao.s)
        # T_j,wa = T_j,wo ∘ S_ao^-1, the scale folded into the translation
        # (the points scale with it): R' = R R_s^T, t' = s t - R' t_s
        slot_map = {}
        for j in oth.kf_ids():
            R_new = (oth.kf_R[j] @ R_s.T).astype(np.float32)
            t_new = (s_s * oth.kf_t[j] - R_new @ t_s).astype(np.float32)
            k_new = act.add_keyframe(
                R_new, t_new, oth.kf_ts[j], oth.kf_frame_id[j],
                oth.kf_feat_xy[j], oth.kf_feat_xyn[j], oth.kf_feat_level[j],
                oth.kf_feat_angle[j], oth.kf_feat_desc[j],
                oth.kf_feat_valid[j],
                np.full(act.cfg.n_feat, NO_POINT, np.int32))
            slot_map[int(j)] = k_new
            # the keyframe is the same camera: identity in its own frame
            self.kf_redirect[(other_id, int(j), int(oth.kf_epoch[j]))] = (
                self.active_id, k_new, int(act.kf_epoch[k_new]),
                np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

        opts = np.where(oth.pt_valid)[0]
        if len(opts):
            X_a = s_s * oth.pt_xyz[opts] @ R_s.T + t_s
            new_ids = act.alloc_points(len(opts))
            act.pt_xyz[new_ids] = X_a.astype(np.float32)
            act.pt_desc[new_ids] = oth.pt_desc[opts]
            act.pt_valid[new_ids] = True
            lut = np.full(oth.pt_valid.shape[0], NO_POINT, np.int64)
            lut[opts] = new_ids
            for j, k_new in slot_map.items():
                fp = oth.kf_feat_point[j]
                sel = fp >= 0
                act.kf_feat_point[k_new][sel] = lut[fp[sel]]
            first = next(iter(slot_map.values()))
            act.pt_ref_kf[new_ids] = [slot_map.get(int(r), first)
                                      for r in oth.pt_ref_kf[opts]]
            act.pt_first_kf[new_ids] = act.pt_ref_kf[new_ids]
            act.update_point_stats(new_ids)
        # keyframes of the other map culled before the weld: their rows
        # replay through the tombstone, compressed onto a welded keyframe
        # (the JAX package drops them with the retired store)
        for (slot, epoch), _ in list(oth.tombstones.items()):
            if oth.resolve_kf_pose(slot, epoch) is None:
                continue
            s2, e2, R_rel, t_rel = oth.tombstones[(slot, epoch)]
            if (other_id, s2, e2) in self.kf_redirect:
                self.kf_redirect[(other_id, slot, epoch)] = (
                    other_id, s2, e2, R_rel, t_rel)
        # the temporal chain, remapped within the welded set
        for j, k_new in slot_map.items():
            p = int(oth.kf_prev[j])
            if p >= 0 and p in slot_map:
                act.kf_prev[k_new] = slot_map[p]

        # retire the other map; its big-change history folds into the
        # active map so System.map_changed's maximum never falls
        act.big_change_idx += oth.big_change_idx
        self.maps[other_id] = self.new_store(other_id)
        self.n_merges += 1
        act.version += 1
        act.big_change_idx += 1
        return slot_map
