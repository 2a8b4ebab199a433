"""Keyframe database: appearance indexing and candidate retrieval.

Counterpart of ``placerec/keyframe_db.py`` of the JAX package (reference:
src/KeyFrameDatabase.cc). Each keyframe's BoW vector is stored as a
fixed-width sparse tf-idf row (word ids [K, W], weights [K, W]); a query
densifies its own vector and scores every keyframe as one gather + reduce,
then accumulates over covisibility groups (DetectNBestCandidates,
KeyFrameDatabase.cc:649). The store and the queries are numpy on the host,
as in the JAX package; only ``vocab.transform`` runs on the vocabulary's
device.
"""
from __future__ import annotations

import numpy as np

from .. import device as device_mod
from . import vocab as vocab_mod
from ..mapping.mapstore import MapStore


class KeyFrameDatabase:
    def __init__(self, voc: vocab_mod.Vocabulary, max_kf: int,
                 max_words_per_kf: int = 0):
        self.voc = voc
        self.width = max_words_per_kf    # 0: sized from the first add
        self.word_ids = None             # [max_kf, W] int32
        self.word_w = None               # [max_kf, W] float32
        self.max_kf = max_kf
        self.valid = np.zeros(max_kf, bool)

    def _ensure(self, n_feat: int, kf_id: int):
        if self.word_ids is None:
            if self.width <= 0:
                self.width = n_feat
            self.word_ids = np.zeros((self.max_kf, self.width), np.int32)
            self.word_w = np.zeros((self.max_kf, self.width), np.float32)
        while kf_id >= self.max_kf:
            self.max_kf *= 2
            self.word_ids = np.concatenate(
                [self.word_ids, np.zeros_like(self.word_ids)])
            self.word_w = np.concatenate(
                [self.word_w, np.zeros_like(self.word_w)])
            self.valid = np.concatenate([self.valid,
                                         np.zeros_like(self.valid)])

    def words(self, desc: np.ndarray, feat_valid: np.ndarray) -> np.ndarray:
        """Word ids [N] of one image's descriptors [N, 8] (host arrays)."""
        dev = self.voc.device
        d, v = device_mod.upload_packed(
            [np.ascontiguousarray(desc).view(np.int32),
             np.asarray(feat_valid, bool)], dev)
        return device_mod.to_device(vocab_mod.transform(self.voc, d, v),
                                    "cpu").numpy()

    def add(self, kf_id: int, desc, feat_valid):
        self._ensure(len(desc), kf_id)
        ids, w = vocab_mod.bow_sparse(self.voc, self.words(desc, feat_valid),
                                      self.width)
        self.word_ids[kf_id] = ids
        self.word_w[kf_id] = w
        self.valid[kf_id] = True

    def erase(self, kf_id: int):
        self.valid[kf_id] = False
        if self.word_w is not None:
            self.word_w[kf_id] = 0.0

    def clear(self):
        self.valid[:] = False
        if self.word_w is not None:
            self.word_w[:] = 0.0

    def query_scores(self, desc, feat_valid) -> np.ndarray:
        """Cosine tf-idf score of a query image against every stored
        keyframe [K]."""
        if self.word_ids is None:
            return np.zeros(self.max_kf, np.float32)
        qi, qw = vocab_mod.bow_sparse(self.voc,
                                      self.words(desc, feat_valid),
                                      self.width)
        qdense = np.zeros(self.voc.n_words, np.float32)
        nz = qw > 0
        qdense[qi[nz]] = qw[nz]
        s = (self.word_w * qdense[self.word_ids]).sum(1)
        s[~self.valid] = 0.0
        return s

    def detect_candidates(self, m: MapStore, query_kf: int, n_best: int = 3,
                          exclude: set | None = None) -> list:
        """Loop / merge candidates for a keyframe: score every keyframe,
        accumulate over covisibility groups, exclude the query's own
        covisible set (reference: DetectNBestCandidates)."""
        scores = self.query_scores(m.kf_feat_desc[query_kf],
                                   m.kf_feat_valid[query_kf])
        covis_ids, _ = m.covisibility(query_kf, min_weight=15)
        excl = {query_kf, *covis_ids.tolist(), *(exclude or set())}
        covm = m.covisibility_matrix()
        cand = []
        for k in np.argsort(-scores):
            k = int(k)
            if scores[k] <= 1e-6 or k in excl or not m.kf_valid[k]:
                continue
            group = [k] + [int(x) for x in np.argsort(-covm[k])[:10]
                           if covm[k, x] >= 15 and m.kf_valid[x]]
            acc = float(sum(scores[g] for g in group))
            cand.append((acc, max(group, key=lambda g: scores[g])))
        cand.sort(key=lambda t: -t[0])
        out, seen = [], set()
        for _, k in cand:
            if k not in seen:
                out.append(k)
                seen.add(k)
            if len(out) >= n_best:
                break
        return out

    def detect_relocalization_candidates(self, m: MapStore, desc, feat_valid,
                                         n_best: int = 5) -> list:
        """(reference: DetectRelocalizationCandidates,
        KeyFrameDatabase.cc:827)"""
        scores = self.query_scores(desc, feat_valid)
        order = np.argsort(-scores)
        return [int(k) for k in order[:n_best]
                if scores[k] > 1e-6 and m.kf_valid[k]]
