"""Binary bag-of-words vocabulary: hierarchical k-medians over ORB
descriptors.

Counterpart of ``placerec/vocab.py`` of the JAX package (reference:
DBoW2's TemplatedVocabulary<FORB>, Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h:44). The tree is flat per level: the nodes of level
l + 1 are ``centroids[l]`` [k^(l+1), 8], the children of node n being
n k ... n k + k - 1. ``transform`` descends every descriptor at once, one
gather + XOR/popcount argmin a level, on the vocabulary's device.

The bundled vocabulary (a 10-way, 6-level tree of 10^6 words, 24.8 MB) is
the JAX package's data file ``placerec/default_vocab.npz``: this module
reads it where it lies, by path, with ``numpy.load`` (``DEFAULT_PATH``),
and uploads its centroids (about 36 MB) once per process and device.
Descriptor words are int32 with the bits of the JAX package's uint32.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamming import popcount32

DEFAULT_PATH = (Path(__file__).resolve().parents[2]
                / "orb_slam3_detailed_comments_tpu" / "placerec"
                / "default_vocab.npz")


class Vocabulary(NamedTuple):
    k: int
    levels: int
    centroids: tuple          # per level: [k^(l+1), 8] int32 on the device
    idf: np.ndarray           # [n_words] float32 (host)

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    @property
    def device(self) -> torch.device:
        return self.centroids[0].device


_POP_LUT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                         axis=1).sum(1).astype(np.uint16)


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return _POP_LUT[x.view(np.uint8)].sum(-1, dtype=np.int32)


def _assign_np(descs: np.ndarray, cents: np.ndarray,
               chunk: int = 200_000) -> np.ndarray:
    """argmin Hamming assignment [M, 8] x [k, 8] -> [M] (first minimum)."""
    out = np.empty(len(descs), np.int32)
    for i in range(0, len(descs), chunk):
        d = _popcount_np(descs[i:i + chunk, None, :] ^ cents[None, :, :])
        out[i:i + chunk] = d.argmin(1)
    return out


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority vote of [M, 8] uint32 -> [8] uint32 (reference:
    FORB::meanValue)."""
    tot = np.zeros(256, np.int64)
    for i in range(0, len(descs), 200_000):
        tot += np.unpackbits(descs[i:i + 200_000].view(np.uint8),
                             axis=-1).sum(0, dtype=np.int64)
    maj = (tot * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Binary k-medians: [M, 8] -> centroids [k, 8]."""
    M = len(descs)
    if M == 0:
        return np.zeros((k, 8), np.uint32)
    cents = descs[rng.choice(M, size=min(k, M), replace=False)]
    if len(cents) < k:
        cents = np.concatenate([cents,
                                np.tile(cents[-1:], (k - len(cents), 1))])
    for _ in range(iters):
        assign = _assign_np(descs, cents)
        new = np.stack([_majority_centroid(descs[assign == c])
                        if (assign == c).any() else cents[c]
                        for c in range(k)])
        if (new == cents).all():
            break
        cents = new
    return cents.astype(np.uint32)


def _upload(centroids, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(c).view(np.int32))
                 .to(device) for c in centroids)


def train(descriptors: np.ndarray, k: int = 10, levels: int = 3,
          seed: int = 0, max_train: int = 60000, device="cpu") -> Vocabulary:
    """Hierarchical k-medians over descriptors [M, 8] (uint32 or int32
    words), the fallback when no vocabulary file is given."""
    descriptors = np.ascontiguousarray(descriptors).view(np.uint32)
    rng = np.random.default_rng(seed)
    if len(descriptors) > max_train:
        descriptors = descriptors[rng.choice(len(descriptors), max_train,
                                             replace=False)]
    groups = [np.arange(len(descriptors))]
    centroids = []
    for _ in range(levels):
        cents_l, new_groups = [], []
        for g in groups:
            cg = _kmedians(descriptors[g], k, rng)
            cents_l.append(cg)
            a = _assign_np(descriptors[g], cg)
            new_groups += [g[a == c] for c in range(k)]
        centroids.append(np.concatenate(cents_l, axis=0))
        groups = new_groups
    voc = Vocabulary(k=k, levels=levels, centroids=_upload(centroids, device),
                     idf=np.ones(k ** levels, np.float32))
    dev = voc.device
    words = transform(
        voc, torch.from_numpy(descriptors.view(np.int32)).to(dev),
        torch.ones(len(descriptors), dtype=torch.bool, device=dev))
    counts = np.bincount(words.cpu().numpy(),
                         minlength=k ** levels).astype(np.float64)
    idf = np.log(max(len(descriptors), 1) / np.maximum(counts, 1.0))
    return voc._replace(idf=idf.astype(np.float32))


def transform(voc: Vocabulary, desc: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Descriptors [N, 8] int32 -> word ids [N] int32 (-1 where not valid):
    the level-wise descent of TemplatedVocabulary::transform, one gather of
    the k children [N, k, 8] and a first-index argmin a level."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    ar = torch.arange(voc.k, device=desc.device)
    for cents in voc.centroids:
        child0 = node * voc.k
        cc = cents[child0[:, None] + ar[None, :]]              # [N, k, 8]
        d = popcount32(desc[:, None, :] ^ cc).sum(-1)
        node = child0 + torch.argmin(d, dim=-1)
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)


def bow_vector(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """Word ids [N] -> L2-normalised tf-idf vector [n_words] (dense)."""
    ok = words >= 0
    hist = torch.zeros(voc.n_words, dtype=torch.float32, device=words.device)
    hist.index_add_(0, torch.where(ok, words, torch.zeros_like(words)).long(),
                    ok.to(torch.float32))
    v = hist * torch.from_numpy(voc.idf).to(words.device)
    return v / torch.clamp(torch.linalg.norm(v), min=1e-9)


def bow_sparse(voc: Vocabulary, words: np.ndarray,
               width: int) -> tuple[np.ndarray, np.ndarray]:
    """Word ids [N] -> the sparse L2-normalised tf-idf vector as (ids
    [width] int32, weights [width] float32), zero-padded; above ``width``
    distinct words the heaviest are kept (DBoW2's BowVector, fixed
    width)."""
    words = np.asarray(words)
    uw, counts = np.unique(words[words >= 0], return_counts=True)
    w = counts.astype(np.float32) * voc.idf[uw]
    n = np.linalg.norm(w)
    if n > 1e-9:
        w = w / n
    if len(uw) > width:
        keep = np.argsort(-w)[:width]
        uw, w = uw[keep], w[keep]
        w = w / max(np.linalg.norm(w), 1e-9)
    ids = np.zeros(width, np.int32)
    ws = np.zeros(width, np.float32)
    ids[:len(uw)] = uw
    ws[:len(uw)] = w
    return ids, ws


def save(voc: Vocabulary, path: str):
    np.savez_compressed(
        path, k=voc.k, levels=voc.levels, idf=voc.idf,
        **{f"c{l}": c.cpu().numpy().view(np.uint32)
           for l, c in enumerate(voc.centroids)})


@functools.lru_cache(maxsize=4)
def _load_cached(path: str, mtime: float, device: torch.device) -> Vocabulary:
    z = np.load(path)
    levels = int(z["levels"])
    return Vocabulary(k=int(z["k"]), levels=levels,
                      centroids=_upload([z[f"c{l}"] for l in range(levels)],
                                        device),
                      idf=np.asarray(z["idf"], np.float32))


def load(path=DEFAULT_PATH, device="cpu") -> Vocabulary:
    """A vocabulary file (``save``'s format) on ``device``; read and
    uploaded once per process for each file and device."""
    path = str(Path(path).resolve())
    return _load_cached(path, Path(path).stat().st_mtime,
                        torch.device(device))
