"""ORB feature extraction: pyramid -> FAST -> orientation -> rBRIEF.

Counterpart of ``ops/extractor.py`` of the JAX package (reference:
ORBextractor::operator(), src/ORBextractor.cc:1557). Every level's detection
is a dense tensor program with static shapes; outputs are fixed-capacity
arrays with masks. Two front ends compute the same features:

* ``"fused"`` (default, ``extract_batch``): one
  ``frontend.dense_frontend_levels`` call for all levels yields each
  level's NMS'd score, rounded blur and moment maps; angles are read from
  the maps and every keypoint's blurred patch comes from its level's blur
  map in one ``patches.gather_patches_levels`` call;
* ``"xla"``: FAST, blur and orientation as separate tensor passes; all
  levels' patches ride two atlas gathers (``ops/patches.py``).

Both select every level's keypoints at once (``fast.select_levels_batch``:
one ``cell_topk`` launch and one sort a frame). They differ in the
outermost pixels only (wrap-around against edge replication), where no
keypoint is selected.

``extract_batch`` extracts B frames of one size at once: their pyramids
lie in one list of B x L levels, frame after frame, so that
``dense_frontend_levels`` and ``cell_topk_levels`` each launch once for
every 16 levels of the batch, ``gather_patches_levels`` once for every
16 // L frames, and the angles and rBRIEF run over the batch's keypoints
in one pass. ``extract`` on the fused front end is its one-frame case,
and each frame of a batch equals it bit for bit: every step is a
per-level kernel, a stable sort of the frame's own row, a gather or an
elementwise operation.
"""
from __future__ import annotations

import functools
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
    if frontend == "fused":
        return FrameFeatures(*[x[0] for x in extract_batch(img[None], cfg)])
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale)
    lay = frame_layout(cfg, h, w, img.device)
    scores = [fast.nms3x3(fast.fast_score(l)) for l in levels]
    kps = fast.select_levels(scores, lay)
    n_all = sum(lay.budgets)

    # all levels' patches in two atlas gathers: raw 31x31 for the
    # intensity-centroid angle, blurred (rounded like the reference's
    # uint8 GaussianBlur, ORBextractor.cc:1630) 37x37 for rBRIEF
    raw_atlas, _ = patches.build_atlas(levels, w)
    blur_atlas, _ = patches.build_atlas(
        [torch.round(pyramid.gaussian_blur(l)) for l in levels], w)
    pr, pb = brief.HALF_PATCH, brief.PATCH_R
    rc_raw = brief.patch_corners(kps.yx, pr, (lay.ch, lay.cw), lay.row_off)
    rc_blur = brief.patch_corners(kps.yx, pb, (lay.ch, lay.cw), lay.row_off)
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


@functools.lru_cache(maxsize=8)
def _frame_levels(cfg: OrbConfig, h: int, w: int, device: torch.device,
                  n_frames: int) -> torch.Tensor:
    """[n_frames * N] int32: each keypoint's image in a table of
    n_frames frames' L levels, frame after frame."""
    lay = frame_layout(cfg, h, w, device)
    shift = cfg.n_levels * torch.arange(n_frames, dtype=torch.int32,
                                        device=device)
    return (lay.level[None, :] + shift[:, None]).reshape(-1)


def extract_batch(imgs: torch.Tensor,
                  cfg: OrbConfig = OrbConfig()) -> FrameFeatures:
    """imgs: [B, H, W] float32 grayscale in [0, 255], on the device to run
    on -> FrameFeatures with a leading axis of B, frame b's fields equal to
    ``extract(imgs[b], cfg)``'s (the fused front end; see the module's
    docstring)."""
    B, h, w = imgs.shape
    L = cfg.n_levels
    dev = imgs.device
    lay = frame_layout(cfg, h, w, dev)
    pyr = pyramid.build_pyramid(imgs, L, cfg.scale)       # L x [B, h_l, w_l]
    levels = [lv[b] for b in range(B) for lv in pyr]      # frame-major
    dense = frontend_mod.dense_frontend_levels(levels)
    kps = fast.select_levels_batch([maps[0] for maps in dense], lay, B)
    N = sum(lay.budgets)

    # angles: one gather from every level's moment maps laid end to end
    yx = kps.yx.long()                                    # [B, N, 2]
    flat = (torch.arange(B, device=dev)[:, None] * lay.n_px + lay.map_off
            + torch.minimum(yx[..., 0].clamp_min(0), lay.lh - 1) * lay.lw
            + torch.minimum(yx[..., 1].clamp_min(0), lay.lw - 1))
    m10 = torch.cat([maps[2].reshape(-1) for maps in dense])[flat]
    m01 = torch.cat([maps[3].reshape(-1) for maps in dense])[flat]
    if dev.type == "cpu":
        # the CPU's atan2 runs a vector loop and a scalar tail, which can
        # part by an ulp: one call a frame and level, the calls ``extract``
        # makes (the card's atan2 is one function for every element)
        angle = torch.cat([torch.atan2(y, x) for ys, xs in zip(m01, m10)
                           for y, x in zip(ys.split(lay.budgets),
                                           xs.split(lay.budgets))])
    else:
        angle = torch.atan2(m01, m10).reshape(-1)

    # rBRIEF patches: one launch for each table of 16 // L frames' blur maps
    rc = brief.patch_corners(kps.yx.reshape(-1, 2), brief.PATCH_R,
                             (lay.ch.repeat(B), lay.cw.repeat(B)))
    per = max(patches.MAX_IMAGES // L, 1)
    table = _frame_levels(cfg, h, w, dev, per)
    pats = [patches.gather_patches_levels(
        [maps[1] for maps in dense[f0 * L:(f0 + nf) * L]],
        table[:nf * N], rc[f0 * N:(f0 + nf) * N], brief.PATCH_W)
        for f0 in range(0, B, per) for nf in [min(per, B - f0)]]
    blur_pat = pats[0] if len(pats) == 1 else torch.cat(pats)
    desc = brief.describe_patches(blur_pat.reshape(B * N, -1), angle)

    yxf = kps.yx.to(torch.float32)
    return FrameFeatures(
        xy=torch.stack([yxf[..., 1] * lay.scale, yxf[..., 0] * lay.scale],
                       dim=-1),
        level=lay.level.repeat(B, 1),
        angle=angle.reshape(B, N),
        score=kps.score,
        desc=desc.reshape(B, N, -1),
        valid=kps.valid,
    )
