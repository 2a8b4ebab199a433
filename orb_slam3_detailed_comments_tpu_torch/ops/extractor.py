"""ORB feature extraction: pyramid -> FAST -> orientation -> rBRIEF.

Counterpart of ``ops/extractor.py`` of the JAX package (reference:
ORBextractor::operator(), src/ORBextractor.cc:1557). Every level's detection
is a dense tensor program with static shapes; outputs are fixed-capacity
arrays with masks. Two front ends compute the same features:

* ``"fused"`` (default): one ``frontend.dense_frontend_levels`` call for all
  levels yields each level's NMS'd score, rounded blur and moment maps;
  angles are read from the maps and the blurred patches are gathered per
  level;
* ``"xla"``: FAST, blur and orientation as separate tensor passes; all
  levels' patches ride two atlas gathers (``ops/patches.py``).

They differ in the outermost pixels only (wrap-around against edge
replication), where no keypoint is selected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import brief, fast, frontend as frontend_mod, patches, pyramid

FRONTENDS = ("fused", "xla")


class OrbConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    ini_th: float = 20.0    # reference iniThFAST (kept for config parity)
    min_th: float = 7.0     # reference minThFAST: weakest accepted corner
    cell: int = 32          # grid cell for uniform selection
    k_per_cell: int = 8
    margin: int = 16        # FAST detection border


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (SoA, level-0 coordinates)."""

    xy: torch.Tensor      # [N, 2] float32 (u=col, v=row) in level-0 pixels
    level: torch.Tensor   # [N] int32 pyramid level
    angle: torch.Tensor   # [N] float32 radians
    score: torch.Tensor   # [N] float32 FAST score
    desc: torch.Tensor    # [N, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor   # [N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def level_budgets(cfg: OrbConfig) -> list:
    """Per-level feature budgets, geometric in 1/scale like the reference
    (ORBextractor ctor: nDesiredFeaturesPerScale)."""
    f = 1.0 / cfg.scale
    total = cfg.n_features
    n0 = total * (1 - f) / (1 - f ** cfg.n_levels)
    budgets = []
    acc = 0
    for lv in range(cfg.n_levels - 1):
        b = int(round(n0 * f ** lv))
        budgets.append(b)
        acc += b
    budgets.append(max(total - acc, 8))
    return budgets


def _extract_impl(img: torch.Tensor, cfg: OrbConfig, h: int, w: int,
                  frontend: str = "fused") -> FrameFeatures:
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend must be one of {FRONTENDS}, "
                         f"got {frontend!r}")
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale)
    budgets = level_budgets(cfg)
    scales = pyramid.scale_factors(cfg.n_levels, cfg.scale)
    dev = img.device
    dense = (frontend_mod.dense_frontend_levels(levels)
             if frontend == "fused" else None)

    xs, lvs, scs, vals, kps_per_level, dims = [], [], [], [], [], []
    angs, blur_pats = [], []
    for lv in range(cfg.n_levels):
        ch = int(round(h / cfg.scale ** lv))
        cw = int(round(w / cfg.scale ** lv))
        if frontend == "fused":
            score, blurred, m10, m01 = dense[lv]
            kps = fast.select_from_nms_score(
                score, (ch, cw), budgets[lv], cell=cfg.cell,
                k_per_cell=cfg.k_per_cell, min_th=cfg.min_th,
                margin=cfg.margin)
            angs.append(brief.angle_from_maps(m10, m01, kps.yx))
            blur_pats.append(brief.extract_patches(blurred, kps.yx, (ch, cw)))
        else:
            kps = fast.detect_level(levels[lv], (ch, cw), budgets[lv],
                                    cell=cfg.cell, k_per_cell=cfg.k_per_cell,
                                    min_th=cfg.min_th, margin=cfg.margin)
        kps_per_level.append(kps)
        dims.append((ch, cw))
        s = float(scales[lv])
        xs.append(torch.stack([kps.yx[:, 1].to(torch.float32) * s,
                               kps.yx[:, 0].to(torch.float32) * s], dim=-1))
        lvs.append(torch.full((budgets[lv],), lv, dtype=torch.int32,
                              device=dev))
        scs.append(kps.score)
        vals.append(kps.valid)

    if frontend == "fused":
        angle_all = torch.cat(angs)
        desc_all = brief.describe_patches(torch.cat(blur_pats), angle_all)
    else:
        # all levels' patches in two atlas gathers: raw 31x31 for the
        # intensity-centroid angle, blurred (rounded like the reference's
        # uint8 GaussianBlur, ORBextractor.cc:1630) 37x37 for rBRIEF
        raw_atlas, offs = patches.build_atlas(levels, w)
        blur_atlas, _ = patches.build_atlas(
            [torch.round(pyramid.gaussian_blur(l)) for l in levels], w)
        pr, pb = brief.HALF_PATCH, brief.PATCH_R
        rc_raw = torch.cat([brief.patch_corners(k.yx, pr, d, o)
                            for k, d, o in zip(kps_per_level, dims, offs)])
        rc_blur = torch.cat([brief.patch_corners(k.yx, pb, d, o)
                             for k, d, o in zip(kps_per_level, dims, offs)])
        n_all = sum(budgets)
        raw_pat = patches.gather_patches(raw_atlas, rc_raw, 2 * pr + 1)
        blur_pat = patches.gather_patches(blur_atlas, rc_blur, 2 * pb + 1)
        angle_all = brief.ic_angle_patches(raw_pat.reshape(n_all, -1))
        desc_all = brief.describe_patches(blur_pat.reshape(n_all, -1),
                                          angle_all)

    return FrameFeatures(
        xy=torch.cat(xs, dim=0),
        level=torch.cat(lvs, dim=0),
        angle=angle_all,
        score=torch.cat(scs, dim=0),
        desc=desc_all,
        valid=torch.cat(vals, dim=0),
    )


def extract(img: torch.Tensor, cfg: OrbConfig = OrbConfig(),
            frontend: str = "fused") -> FrameFeatures:
    """img: [H, W] float32 grayscale in [0, 255], on the device to run on."""
    h, w = img.shape
    return _extract_impl(img, cfg, h, w, frontend)
