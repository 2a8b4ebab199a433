"""ORB feature extraction: pyramid -> FAST -> orientation -> rBRIEF.

Counterpart of ``ops/extractor.py`` of the JAX package (reference:
ORBextractor::operator(), src/ORBextractor.cc:1557). Every level's detection
is a dense tensor program with static shapes; outputs are fixed-capacity
arrays with masks. Two front ends compute the same features:

* ``"fused"`` (default): one ``frontend.dense_frontend_levels`` call for all
  levels yields each level's NMS'd score, rounded blur and moment maps;
  angles are read from the maps and every keypoint's blurred patch comes
  from its level's blur map in one ``patches.gather_patches_levels`` call;
* ``"xla"``: FAST, blur and orientation as separate tensor passes; all
  levels' patches ride two atlas gathers (``ops/patches.py``).

Both select every level's keypoints at once (``fast.select_levels``: one
``cell_topk`` launch and one sort a frame). They differ in the outermost
pixels only (wrap-around against edge replication), where no keypoint is
selected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import brief, fast, frontend as frontend_mod, patches, pyramid
from .layout import frame_layout

FRONTENDS = ("fused", "xla")


class OrbConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    ini_th: float = 20.0    # reference iniThFAST (kept for config parity)
    min_th: float = 7.0     # reference minThFAST: weakest accepted corner
    cell: int = 32          # grid cell for uniform selection (the card's
                            # cell_topk kernel takes 16, 32, 48, ...)
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


def _extract_impl(img: torch.Tensor, cfg: OrbConfig, h: int, w: int,
                  frontend: str = "fused") -> FrameFeatures:
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend must be one of {FRONTENDS}, "
                         f"got {frontend!r}")
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale)
    lay = frame_layout(cfg, h, w, img.device)
    if frontend == "fused":
        dense = frontend_mod.dense_frontend_levels(levels)
        scores = [maps[0] for maps in dense]
    else:
        scores = [fast.nms3x3(fast.fast_score(l)) for l in levels]
    kps = fast.select_levels(scores, lay)
    n_all = sum(lay.budgets)

    if frontend == "fused":
        angle_all = torch.cat([
            brief.angle_from_maps(maps[2], maps[3], yx)
            for maps, yx in zip(dense, kps.yx.split(lay.budgets))])
        rc = brief.patch_corners(kps.yx, brief.PATCH_R, (lay.ch, lay.cw))
        blur_pat = patches.gather_patches_levels(
            [maps[1] for maps in dense], lay.level, rc, brief.PATCH_W)
    else:
        # all levels' patches in two atlas gathers: raw 31x31 for the
        # intensity-centroid angle, blurred (rounded like the reference's
        # uint8 GaussianBlur, ORBextractor.cc:1630) 37x37 for rBRIEF
        raw_atlas, _ = patches.build_atlas(levels, w)
        blur_atlas, _ = patches.build_atlas(
            [torch.round(pyramid.gaussian_blur(l)) for l in levels], w)
        pr, pb = brief.HALF_PATCH, brief.PATCH_R
        rc_raw = brief.patch_corners(kps.yx, pr, (lay.ch, lay.cw),
                                     lay.row_off)
        rc_blur = brief.patch_corners(kps.yx, pb, (lay.ch, lay.cw),
                                      lay.row_off)
        raw_pat = patches.gather_patches(raw_atlas, rc_raw, 2 * pr + 1)
        blur_pat = patches.gather_patches(blur_atlas, rc_blur, 2 * pb + 1)
        angle_all = brief.ic_angle_patches(raw_pat.reshape(n_all, -1))
    desc_all = brief.describe_patches(blur_pat.reshape(n_all, -1), angle_all)

    yx = kps.yx.to(torch.float32)
    return FrameFeatures(
        xy=torch.stack([yx[:, 1] * lay.scale, yx[:, 0] * lay.scale], dim=-1),
        level=lay.level.clone(),   # the table is shared by every frame
        angle=angle_all,
        score=kps.score,
        desc=desc_all,
        valid=kps.valid,
    )


def extract(img: torch.Tensor, cfg: OrbConfig = OrbConfig(),
            frontend: str = "fused") -> FrameFeatures:
    """img: [H, W] float32 grayscale in [0, 255], on the device to run on."""
    h, w = img.shape
    return _extract_impl(img, cfg, h, w, frontend)
