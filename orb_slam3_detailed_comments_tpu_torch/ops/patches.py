"""Per-keypoint patch gather from a stacked pyramid atlas: the CUDA kernel
and its plain version.

Counterpart of ``ops/pallas_patches.py`` of the JAX package. The pyramid
levels are stacked into one atlas (``build_atlas``, same layout as the JAX
version) and one call gathers every level's keypoints. A corner is clamped
into the atlas exactly as ``lax.dynamic_slice`` clamps its start, so the
result equals the JAX fallback ``gather_patches_atlas_xla``.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/patches.cu`` (one block per keypoint) or raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import native

_LANES = 256   # the JAX layout's column slack past the widest level


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


def gather_patches_plain(atlas: torch.Tensor, rc: torch.Tensor, ph: int,
                         pw: int = 0) -> torch.Tensor:
    """atlas [H, W] float32, rc [N, 2] int32 top-left corners ->
    [N, ph, pw] float32 (pw defaults to ph)."""
    pw = pw or ph
    H, W = atlas.shape
    r, c = rc[:, 0].long(), rc[:, 1].long()
    # lax.dynamic_slice: a negative start counts from the end, then the
    # start is clamped so the window lies inside the array
    r0 = torch.clamp(torch.where(r < 0, r + H, r), 0, H - ph)
    c0 = torch.clamp(torch.where(c < 0, c + W, c), 0, W - pw)
    rows = r0[:, None, None] + torch.arange(ph, device=atlas.device)[None, :, None]
    cols = c0[:, None, None] + torch.arange(pw, device=atlas.device)[None, None, :]
    return atlas[rows, cols]


def gather_patches(atlas: torch.Tensor, rc: torch.Tensor, ph: int,
                   pw: int = 0) -> torch.Tensor:
    """Patch gather: the plain version on the CPU, the kernel on the card."""
    pw = pw or ph
    if atlas.device.type == "cpu":
        return gather_patches_plain(atlas, rc, ph, pw)
    if atlas.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {atlas.device}")
    native.require(atlas, "atlas", torch.float32, 2, atlas.device)
    native.require(rc, "rc", torch.int32, 2, atlas.device)
    H, W = atlas.shape
    N = rc.shape[0]
    if rc.shape[1] != 2 or not (0 < ph <= H and 0 < pw <= W):
        raise ValueError(f"gather_patches: rc must be [N, 2] and the patch "
                         f"{ph}x{pw} must fit the atlas {H}x{W}")
    out = torch.empty((N, ph, pw), dtype=torch.float32, device=atlas.device)
    rcode = native.lib().slam_gather_patches(
        atlas.data_ptr(), H, W, rc.data_ptr(), N, ph, pw, out.data_ptr(),
        native.stream_ptr(atlas))
    native.check(rcode, "gather_patches")
    native.launches["gather_patches"] += 1
    return out
