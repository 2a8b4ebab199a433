"""Per-keypoint patch gather from a frame's images: the CUDA kernel and its
plain version.

Counterpart of ``ops/pallas_patches.py`` of the JAX package.
``gather_patches_levels`` takes up to ``MAX_IMAGES`` images (the fused
front end's blur maps, one a pyramid level), a level index and a corner
for each keypoint, and gathers every keypoint's window from its own image.
``gather_patches`` is its one-image case on a stacked pyramid atlas
(``build_atlas``, same layout as the JAX version), which the ``"xla"``
front end uses. A corner is placed in its image exactly as
``lax.dynamic_slice`` places its start, so the result equals the JAX
fallback ``gather_patches_atlas_xla`` on any corner.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/patches.cu`` (one block a keypoint, every keypoint of a frame in
one launch) or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import native

_LANES = 256       # the JAX layout's column slack past the widest level
MAX_IMAGES = 16    # images in the kernel's by-value table, a launch


def build_atlas(levels, widest: int, lanes_slack: int = _LANES):
    """Stack pyramid levels into one atlas [H, W] (W a multiple of 128 with
    the JAX layout's slack; 64 zero rows at the bottom). Returns
    (atlas, row_offsets)."""
    W = int(np.ceil((widest + lanes_slack - 128) / 128.0) * 128)
    W = max(W, ((widest + 127) // 128) * 128)
    offs, padded, off = [], [], 0
    for lvl in levels:
        offs.append(off)
        padded.append(F.pad(lvl, (0, W - lvl.shape[1])))
        off += lvl.shape[0]
    padded.append(torch.zeros((64, W), dtype=levels[0].dtype,
                              device=levels[0].device))
    return torch.cat(padded, dim=0), offs


def gather_patches_levels_plain(images, level: torch.Tensor, rc: torch.Tensor,
                                ph: int, pw: int = 0) -> torch.Tensor:
    """images: [H_l, W_l] float32 tensors; level [N] int32 names each
    keypoint's image; rc [N, 2] int32 corners in that image -> [N, ph, pw]
    float32 (pw defaults to ph), from the images flattened into one
    buffer."""
    pw = pw or ph
    dev = images[0].device
    sizes = [im.numel() for im in images]
    table = torch.tensor([[im.shape[0] for im in images],
                          [im.shape[1] for im in images],
                          [sum(sizes[:l]) for l in range(len(images))]],
                         device=dev)[:, level.long()]
    H, W, off = table.unbind(0)
    # lax.dynamic_slice: a negative start counts from the end, then the
    # start is clamped so the window lies inside the image
    r, c = rc[:, 0].long(), rc[:, 1].long()
    r0 = torch.minimum(torch.where(r < 0, r + H, r).clamp_min(0), H - ph)
    c0 = torch.minimum(torch.where(c < 0, c + W, c).clamp_min(0), W - pw)
    rows = r0[:, None, None] + torch.arange(ph, device=dev)[None, :, None]
    cols = c0[:, None, None] + torch.arange(pw, device=dev)[None, None, :]
    flat = torch.cat([im.reshape(-1) for im in images])
    return flat[off[:, None, None] + rows * W[:, None, None] + cols]


def gather_patches_plain(atlas: torch.Tensor, rc: torch.Tensor, ph: int,
                         pw: int = 0) -> torch.Tensor:
    """atlas [H, W] float32, rc [N, 2] int32 top-left corners ->
    [N, ph, pw] float32: the one-image case of
    ``gather_patches_levels_plain``."""
    level = torch.zeros(rc.shape[0], dtype=torch.int32, device=rc.device)
    return gather_patches_levels_plain([atlas], level, rc, ph, pw)


def _launch(images, level, rc: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """One kernel launch for every window; level None means image 0 of a
    one-image table."""
    dev = images[0].device
    for k, im in enumerate(images):
        native.require(im, f"images[{k}]", torch.float32, 2, dev)
        if not (0 < ph <= im.shape[0] and 0 < pw <= im.shape[1]):
            raise ValueError(f"gather_patches: the patch {ph}x{pw} must fit "
                             f"image {k}, {tuple(im.shape)}")
    native.require(rc, "rc", torch.int32, 2, dev)
    N = rc.shape[0]
    if rc.shape[1] != 2:
        raise ValueError("gather_patches: rc must be [N, 2]")
    if level is not None:
        native.require(level, "level", torch.int32, 1, dev)
        if level.shape[0] != N:
            raise ValueError("gather_patches: one level for each corner")
    out = torch.empty((N, ph, pw), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    H, W = map(native.int_array, zip(*[im.shape for im in images]))
    pointers = ctypes.c_void_p * len(images)
    code = native.lib().slam_gather_patches_levels(
        len(images), pointers(*[im.data_ptr() for im in images]), H, W,
        None if level is None else level.data_ptr(), rc.data_ptr(), N, ph,
        pw, out.data_ptr(), native.stream_ptr(images[0]))
    native.check(code, "gather_patches")
    native.launches.bump("gather_patches")
    return out


def gather_patches_levels(images, level: torch.Tensor, rc: torch.Tensor,
                          ph: int, pw: int = 0) -> torch.Tensor:
    """Every keypoint's [ph, pw] window (pw defaults to ph) from the image
    its level names, at its corner: the plain version on the CPU, one
    kernel launch on the card for every ``MAX_IMAGES`` images. images: one
    or more float32 tensors on one device, each at least ph x pw; level
    [N] int32 in [0, len(images)); rc [N, 2] int32."""
    images = list(images)
    pw = pw or ph
    if not images:
        raise ValueError("gather_patches_levels: no images")
    dev = images[0].device
    if any(t.device != dev for t in images + [level, rc]):
        raise ValueError("gather_patches_levels: tensors on different devices")
    if dev.type == "cpu":
        return gather_patches_levels_plain(images, level, rc, ph, pw)
    if dev.type != "cuda":
        raise ValueError(f"gather_patches_levels: unsupported device {dev}")
    if len(images) <= MAX_IMAGES:
        return _launch(images, level, rc, ph, pw)
    # one launch a table of MAX_IMAGES images over every keypoint, its
    # level shifted into the table; each keypoint keeps the windows of its
    # own table (no host sync: no keypoint is selected out)
    out = None
    for g in range(0, len(images), MAX_IMAGES):
        sub = images[g:g + MAX_IMAGES]
        mine = (level >= g) & (level < g + len(sub))
        part = _launch(sub, torch.clamp(level - g, 0, len(sub) - 1), rc, ph,
                       pw)
        out = part if out is None else torch.where(mine[:, None, None],
                                                   part, out)
    return out


def gather_patches(atlas: torch.Tensor, rc: torch.Tensor, ph: int,
                   pw: int = 0) -> torch.Tensor:
    """Patch gather from one atlas: the plain version on the CPU, the
    one-image case of the kernel on the card."""
    pw = pw or ph
    if atlas.device.type == "cpu":
        return gather_patches_plain(atlas, rc, ph, pw)
    if atlas.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {atlas.device}")
    return _launch([atlas], None, rc, ph, pw)
