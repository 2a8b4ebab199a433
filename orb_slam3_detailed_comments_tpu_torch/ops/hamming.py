"""Hamming best-2 searches: the CUDA kernels and their plain versions.

Counterpart of ``ops/pallas_hamming.py`` of the JAX package.
``hamming_best2_windowed`` is the projection search of both tracking
stages; ``hamming_best2`` is the unmasked branch of ``matching.match_nn``.

Descriptors are [N, 8] int32 tensors carrying the 256 bits. The plain
versions take the popcount through a 256-entry table over a uint8 view
(torch has no popcount).

Output contract, shared by kernels and plain versions: a gated-out pair
counts as ``BIG``; ``d1`` is the minimum, ``i1`` the first index of the
minimum, ``d2`` the minimum over every column except ``i1``; a row with
every target gated out returns d1 = d2 = BIG and i1 = 0.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/hamming.cu`` or raises.
"""
from __future__ import annotations

import functools

import torch

from .. import native

BIG = 10_000
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)
_CHUNK_PAIRS = 1 << 18   # query x target pairs per block of the plain scan


@functools.lru_cache(maxsize=8)
def _popcount8_on(device: torch.device) -> torch.Tensor:
    return _POPCOUNT8.to(device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (table lookup per byte)."""
    lut = _popcount8_on(x.device)
    b = x.contiguous().view(torch.uint8).to(torch.int64)
    return lut[b].reshape(*x.shape, 4).sum(-1, dtype=torch.int32)


def _dist_rows(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    x = da[:, None, :] ^ db[None, :, :]
    return popcount32(x).sum(-1, dtype=torch.int32)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Q, 8] x [K, 8] int32 -> [Q, K] int32 Hamming distances."""
    step = max(1, _CHUNK_PAIRS // max(db.shape[0], 1))
    return torch.cat([_dist_rows(da[s:s + step], db)
                      for s in range(0, da.shape[0], step)] or
                     [torch.zeros((0, db.shape[0]), dtype=torch.int32,
                                  device=da.device)])


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Best and second-best along axis 1 under mask: (d1, i1, d2) int32."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    i1 = torch.argmin(d, dim=1)
    d1 = torch.gather(d, 1, i1[:, None])[:, 0]
    d_no1 = d.scatter(1, i1[:, None], BIG)
    d2 = torch.amin(d_no1, dim=1)
    return d1, i1.to(torch.int32), d2


def hamming_best2_plain(da, db, vb):
    """da [Q, 8], db [K, 8] int32, vb [K] bool -> (d1, i1, d2) [Q] int32."""
    return masked_best2(hamming_matrix(da, db), vb[None, :])


def hamming_best2_windowed_plain(da, q_uv, q_lv, q_r, q_lo, q_hi, qv,
                                 db, t_xy, t_lv, tv):
    """The projection-search gates in float32, as the Pallas kernel has
    them, then the masked best-2 scan."""
    du = torch.abs(q_uv[:, 0][:, None] - t_xy[:, 0][None, :])
    dv = torch.abs(q_uv[:, 1][:, None] - t_xy[:, 1][None, :])
    r = q_r[:, None]
    dl = t_lv[None, :] - q_lv[:, None]
    ok = ((du <= r) & (dv <= r) & (dl >= q_lo[:, None]) & (dl <= q_hi[:, None])
          & tv[None, :] & qv[:, None])
    return masked_best2(hamming_matrix(da, db), ok)


def _out3(Q: int, device):
    return tuple(torch.empty(Q, dtype=torch.int32, device=device)
                 for _ in range(3))


def hamming_best2(da, db, vb):
    """Unwindowed best-2 under the target mask only."""
    if da.device.type == "cpu":
        return hamming_best2_plain(da, db, vb)
    if da.device.type != "cuda":
        raise ValueError(f"hamming_best2: unsupported device {da.device}")
    dev = da.device
    native.require(da, "da", torch.int32, 2, dev)
    native.require(db, "db", torch.int32, 2, dev)
    native.require(vb, "vb", torch.bool, 1, dev)
    Q, K = da.shape[0], db.shape[0]
    if da.shape[1] != 8 or db.shape[1] != 8 or vb.shape[0] != K or K == 0:
        raise ValueError("hamming_best2: expected da [Q, 8], db [K, 8], "
                         "vb [K] with K > 0")
    d1, i1, d2 = _out3(Q, dev)
    rc = native.lib().slam_hamming_best2(
        da.data_ptr(), Q, db.data_ptr(), vb.data_ptr(), K, d1.data_ptr(),
        i1.data_ptr(), d2.data_ptr(), native.stream_ptr(da))
    native.check(rc, "hamming_best2")
    native.launches["hamming_best2"] += 1
    return d1, i1, d2


def hamming_best2_windowed(da, q_uv, q_lv, q_r, q_lo, q_hi, qv,
                           db, t_xy, t_lv, tv):
    """Projection-search matching: per-query window + level gates fused with
    the Hamming best-2 scan.

    da [Q, 8] int32, q_uv [Q, 2] f32, q_lv/q_lo/q_hi [Q] int32, q_r [Q] f32,
    qv [Q] bool; db [K, 8] int32, t_xy [K, 2] f32, t_lv [K] int32,
    tv [K] bool. Returns (d1, i1, d2) [Q] int32."""
    if da.device.type == "cpu":
        return hamming_best2_windowed_plain(da, q_uv, q_lv, q_r, q_lo, q_hi,
                                            qv, db, t_xy, t_lv, tv)
    if da.device.type != "cuda":
        raise ValueError(f"hamming_best2_windowed: unsupported device "
                         f"{da.device}")
    dev = da.device
    for t, name, dtype, nd in (
            (da, "da", torch.int32, 2), (q_uv, "q_uv", torch.float32, 2),
            (q_lv, "q_lv", torch.int32, 1), (q_r, "q_r", torch.float32, 1),
            (q_lo, "q_lo", torch.int32, 1), (q_hi, "q_hi", torch.int32, 1),
            (qv, "qv", torch.bool, 1), (db, "db", torch.int32, 2),
            (t_xy, "t_xy", torch.float32, 2), (t_lv, "t_lv", torch.int32, 1),
            (tv, "tv", torch.bool, 1)):
        native.require(t, name, dtype, nd, dev)
    Q, K = da.shape[0], db.shape[0]
    if (da.shape[1] != 8 or db.shape[1] != 8 or K == 0
            or q_uv.shape != (Q, 2) or t_xy.shape != (K, 2)
            or any(t.shape[0] != Q for t in (q_lv, q_r, q_lo, q_hi, qv))
            or any(t.shape[0] != K for t in (t_lv, tv))):
        raise ValueError("hamming_best2_windowed: inconsistent shapes")
    d1, i1, d2 = _out3(Q, dev)
    rc = native.lib().slam_hamming_best2_windowed(
        da.data_ptr(), q_uv.data_ptr(), q_lv.data_ptr(), q_r.data_ptr(),
        q_lo.data_ptr(), q_hi.data_ptr(), qv.data_ptr(), Q,
        db.data_ptr(), t_xy.data_ptr(), t_lv.data_ptr(), tv.data_ptr(), K,
        d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), native.stream_ptr(da))
    native.check(rc, "hamming_best2_windowed")
    native.launches["hamming_best2_windowed"] += 1
    return d1, i1, d2
