"""Per-cell top-k for keypoint selection: the CUDA kernel and its plain
version.

Counterpart of ``ops/pallas_topk.py`` of the JAX package. The contract is
``lax.top_k``'s: values in descending order, and the FIRST index wins a
tie. ``torch.topk`` does not promise which index wins a tie, so the plain
version is a stable descending sort followed by a slice (``stable_top``,
which every other top-k of the port uses too).

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/topk.cu`` (one warp per row) or raises.
"""
from __future__ import annotations

import torch

from .. import native


def stable_top(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along dim, first index winning
    ties (``lax.top_k``'s order; ``torch.topk`` leaves ties unspecified)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def cell_topk_plain(cells: torch.Tensor, k: int):
    """cells [C, A] float32 -> (values [C, k] float32, indices [C, k] int32)."""
    vals, idx = stable_top(cells, k, dim=1)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def cell_topk(cells: torch.Tensor, k: int):
    """Top-k of each row, descending, first index wins ties. A (the row
    length) must be a multiple of 32 and at most 1024 on the card."""
    if cells.device.type == "cpu":
        return cell_topk_plain(cells, k)
    if cells.device.type != "cuda":
        raise ValueError(f"cell_topk: unsupported device {cells.device}")
    native.require(cells, "cells", torch.float32, 2, cells.device)
    C, A = cells.shape
    if A % 32 or A > 1024 or not 0 < k <= A:
        raise ValueError(f"cell_topk: row length {A} must be a multiple of "
                         f"32 and <= 1024, and 0 < k <= {A} (k={k})")
    vals = torch.empty((C, k), dtype=torch.float32, device=cells.device)
    idx = torch.empty((C, k), dtype=torch.int32, device=cells.device)
    rc = native.lib().slam_cell_topk(cells.data_ptr(), vals.data_ptr(),
                                     idx.data_ptr(), C, A, k,
                                     native.stream_ptr(cells))
    native.check(rc, "cell_topk")
    native.launches["cell_topk"] += 1
    return vals, idx
