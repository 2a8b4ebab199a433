"""Hamming best-2 searches: the CUDA kernels and their plain versions.

Counterpart of ``ops/pallas_hamming.py`` of the JAX package.
``hamming_best2_windowed`` is the projection search of both tracking
stages; ``hamming_best2`` is the unmasked branch of ``matching.match_nn``.

Descriptors are [N, 8] int32 tensors carrying the 256 bits. The plain
versions count bits by SWAR steps on the XOR words (torch has no
popcount); ``popcount32``, for the point bitsets, through a 256-entry table
over a uint8 view.

Output contract, shared by kernels and plain versions: a gated-out pair
counts as ``BIG``; ``d1`` is the minimum, ``i1`` the first index of the
minimum, ``d2`` the minimum over every column except ``i1``; a row with
every target gated out returns d1 = d2 = BIG and i1 = 0.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/hamming.cu`` or raises. The kernel gives a warp to each query: lane
``l`` scans targets ``l, l + 32, ...`` and the lanes merge their triples.
``lane_best2`` and ``merge_lane_best2`` are that scan and that merge as
tensor functions, so that the merge's tie rules are tested without a card;
the wrappers hold ``LANES`` against the kernel's own count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import native

BIG = 10_000
LANES = 32               # lanes of the kernel's warp
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


def _xor_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance of broadcast [..., 8] int32 word rows: the bit
    count of the XOR words by SWAR steps, in int64 so that no step
    overflows (a quarter of a byte table's memory traffic)."""
    x = (a ^ b).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = (x + (x >> 16)) & 0x3F
    return x.sum(-1, dtype=torch.int32)


def _dist_rows(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    return _xor_dist(da[:, None, :], db[None, :, :])


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


def lane_best2(dist: torch.Tensor, mask: torch.Tensor, lanes: int = LANES):
    """What the kernel's lanes hold before they merge: lane l has scanned
    columns l, l + lanes, ... of dist [Q, K] under mask. Returns (d1, i1, d2)
    as [Q, lanes] int32 with i1 a column of dist; a lane with no admissible
    column holds (BIG, 0, BIG)."""
    Q, K = dist.shape
    n = -(-K // lanes)
    d = torch.full((Q, n * lanes), BIG, dtype=dist.dtype, device=dist.device)
    d[:, :K] = torch.where(mask, dist, torch.full_like(dist, BIG))
    d = d.reshape(Q, n, lanes).transpose(1, 2)               # [Q, lanes, n]
    step = torch.argmin(d, dim=2, keepdim=True)
    d1 = torch.gather(d, 2, step)[..., 0]
    d2 = torch.amin(d.scatter(2, step, BIG), dim=2)
    i1 = step[..., 0] * lanes + torch.arange(lanes, device=dist.device)
    i1 = torch.where(d1 < BIG, i1, torch.zeros_like(i1))
    return d1.to(torch.int32), i1.to(torch.int32), d2.to(torch.int32)


def merge_lane_best2(d1: torch.Tensor, i1: torch.Tensor, d2: torch.Tensor):
    """Per-lane triples [..., L] (L a power of two) -> one triple [...], by
    the kernel's butterfly: a lane and its partner at distance L/2, L/4, ...
    keep the lesser (d1, i1) pair in lexicographic order, so i1 stays the
    first index of the minimum; d2 becomes the least of both d2 and of the
    loser's d1."""
    L = d1.shape[-1]
    if L & (L - 1):
        raise ValueError(f"merge_lane_best2: {L} lanes, not a power of two")
    lane = torch.arange(L, device=d1.device)
    off = L // 2
    while off:
        p = lane ^ off
        e1, j1, e2 = d1[..., p], i1[..., p], d2[..., p]
        wins = (d1 < e1) | ((d1 == e1) & (i1 <= j1))
        d2 = torch.minimum(torch.minimum(d2, e2), torch.where(wins, e1, d1))
        d1, i1 = torch.where(wins, d1, e1), torch.where(wins, i1, j1)
        off //= 2
    return d1[..., 0], i1[..., 0], d2[..., 0]


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
    # distances of the admitted pairs only: the gates admit a few percent
    qi, ti = ok.nonzero(as_tuple=True)
    dist = torch.full(ok.shape, BIG, dtype=torch.int32, device=ok.device)
    dist[qi, ti] = _xor_dist(da[qi], db[ti])
    return masked_best2(dist, ok)


@functools.cache
def _check_kernel_lanes() -> None:
    """The kernel's lanes per query against ``LANES``, once (a failure is
    not cached)."""
    got = ctypes.c_int()
    native.check(native.lib().slam_best2_lanes(ctypes.addressof(got)),
                 "best2_lanes")
    if got.value != LANES:
        raise RuntimeError(f"csrc/hamming.cu gives a query {got.value} "
                           f"lanes, ops/hamming.py {LANES}")


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
    _check_kernel_lanes()
    d1, i1, d2 = _out3(Q, dev)
    rc = native.lib().slam_hamming_best2(
        da.data_ptr(), Q, db.data_ptr(), vb.data_ptr(), K, d1.data_ptr(),
        i1.data_ptr(), d2.data_ptr(), native.stream_ptr(da))
    native.check(rc, "hamming_best2")
    native.launches.bump("hamming_best2")
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
    _check_kernel_lanes()
    d1, i1, d2 = _out3(Q, dev)
    rc = native.lib().slam_hamming_best2_windowed(
        da.data_ptr(), q_uv.data_ptr(), q_lv.data_ptr(), q_r.data_ptr(),
        q_lo.data_ptr(), q_hi.data_ptr(), qv.data_ptr(), Q,
        db.data_ptr(), t_xy.data_ptr(), t_lv.data_ptr(), tv.data_ptr(), K,
        d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), native.stream_ptr(da))
    native.check(rc, "hamming_best2_windowed")
    native.launches.bump("hamming_best2_windowed")
    return d1, i1, d2
