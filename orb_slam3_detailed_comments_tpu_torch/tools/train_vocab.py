"""Train a BoW vocabulary from rendered synthetic worlds.

Counterpart of ``scripts/train_vocab.py`` of the JAX package. The
reference ships a pretrained 10^6-word ORB vocabulary (ORBvoc.txt, k=10
L=6, DBoW2's TemplatedVocabulary). This tool renders ``n_worlds``
independently seeded worlds (seeds 1000 + w, 10 frames each) on the
device, extracts ORB in blocks of ``batch_extract.INGEST_BLOCK_MULTIPLE``
frames (``eval_vocab.frame_blocks``), and trains a k=10 hierarchical
binary k-medians tree (``placerec/vocab.train``, DBoW2's FORB meanValue /
Hamming scheme), saved in ``vocab.save``'s format, which both packages
load.

    python -m orb_slam3_detailed_comments_tpu_torch.tools.train_vocab \\
        [levels=4] [n_worlds=60] [out.npz] [--device cpu]

``VOCAB_PHASE=extract`` writes the descriptors ([M, 8] uint32, ``.npy``)
to ``VOCAB_DESC_CACHE`` and stops; ``VOCAB_PHASE=train`` trains from that
file; the default, ``all``, does both in one process. The cache has the
JAX tool's format, so either package trains from the other's. The
defaults of ``out`` and of the cache lie under the repo's git-ignored
``build/torch_vocab/``; the bundled vocabulary (the JAX package's
``placerec/default_vocab.npz``, k=10 L=6 from 4.1M descriptors of 400
worlds) is never written.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

from .. import device as device_mod
from ..examples import runner
from ..models import cameras
from ..ops import extractor
from ..placerec import vocab
from . import eval_vocab

BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_vocab"
DEFAULT_OUT = BUILD / "vocab.npz"
DEFAULT_CACHE = BUILD / "vocab_desc.npy"
SEED0 = 1000
FRAMES_PER_WORLD = 10
PHASES = ("extract", "train", "all")


def train_world(seed):
    """World ``seed`` of the training set: ``eval_vocab.eval_world``'s
    draws with the training ranges of the orbit's advance and sway."""
    return eval_vocab.eval_world(seed, frames_per_world=FRAMES_PER_WORLD,
                                 advance=(1.0, 4.0), sway=(0.1, 0.8))


def extract_descriptors(n_worlds, device, stats=None) -> np.ndarray:
    """The valid descriptors [M, 8] uint32 of worlds 1000 .. 1000 +
    n_worlds - 1, frame after frame; ``stats`` as ``frame_blocks``."""
    cam = cameras.pinhole(**eval_vocab.CAM_KW)
    cfg = extractor.OrbConfig(n_features=eval_vocab.N_FEATURES)
    t0, out, n_frames = time.time(), [], 0
    total = n_worlds * FRAMES_PER_WORLD
    for imgs, f in eval_vocab.frame_blocks(
            cam, cfg, train_world, range(SEED0, SEED0 + n_worlds), device,
            stats):
        out.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
        done = n_frames + len(imgs)
        if done // 100 > n_frames // 100 or done == total:
            print(f"frame {done}/{total}: {sum(len(d) for d in out)} "
                  f"descriptors ({time.time() - t0:.0f}s)")
        n_frames = done
    return np.concatenate(out, axis=0)


def train_and_save(descs, levels, out, device, t0):
    """Train k=10 with ``levels`` levels (the JAX tool's ``max_train``
    rule) and save to ``out``; returns the vocabulary."""
    print(f"training k=10 L={levels} on {len(descs)} descriptors ...")
    voc = vocab.train(descs, k=10, levels=levels, seed=0,
                      max_train=4_000_000 if levels >= 5 else 1_500_000,
                      device=device)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    vocab.save(voc, out)
    print(f"saved {voc.n_words}-word vocabulary to {out} "
          f"({os.path.getsize(out) / 1e6:.2f} MB, "
          f"{time.time() - t0:.0f}s total)")
    return voc


def run(levels, n_worlds, out, phase, cache, device, stats=None):
    """One run of the tool: the trained vocabulary, or None for the
    ``extract`` phase."""
    if phase not in PHASES:
        raise SystemExit(f"VOCAB_PHASE must be one of {PHASES}, not "
                         f"{phase!r}")
    if Path(out).resolve() == vocab.DEFAULT_PATH:
        raise SystemExit(f"{out} is the bundled vocabulary, which this "
                         "tool never writes: give another path")
    t0 = time.time()
    if phase == "train":
        descs = np.load(cache)
        print(f"loaded {len(descs)} cached descriptors from {cache}")
        return train_and_save(descs, levels, out, device, t0)
    descs = extract_descriptors(n_worlds, device, stats)
    if phase == "extract":
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        np.save(cache, descs)
        print(f"cached {len(descs)} descriptors to {cache}")
        return None
    return train_and_save(descs, levels, out, device, t0)


def main(argv=None) -> int:
    args, device = runner.split_device(sys.argv[1:] if argv is None
                                       else argv)
    levels = int(args[0]) if len(args) > 0 else 4
    n_worlds = int(args[1]) if len(args) > 1 else 60
    out = args[2] if len(args) > 2 else str(DEFAULT_OUT)
    run(levels, n_worlds, out, os.environ.get("VOCAB_PHASE", "all"),
        os.environ.get("VOCAB_DESC_CACHE", str(DEFAULT_CACHE)),
        device_mod.resolve(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
