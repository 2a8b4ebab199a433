"""Place-recognition evaluation of BoW vocabularies on held-out worlds.

Counterpart of ``scripts/eval_vocab.py`` of the JAX package. Builds a
keyframe database from held-out synthetic worlds (seeds from 50,000,
disjoint from ``train_vocab``'s 1000 + w) and measures, for the query
frames taken between the database frames:

  - top1: the share of queries whose best-scoring database frame is the
    nearest-in-time frame of the SAME world (the "same place"),
  - margin: the median ratio of the same-place score to the best score
    from a DIFFERENT world (loop-closure false-positive headroom).

This is the role of the reference's vocabulary quality check (DBoW2 L1
scoring feeding KeyFrameDatabase::DetectNBestCandidates,
src/KeyFrameDatabase.cc:649) without real datasets. ``--domains`` also
sweeps the texture statistics the vocabulary was not trained on
(``synth_render.TEXTURE_DOMAINS``: 1/f spectra, illumination fields,
specular saturation).

Frames are ray-cast on the device (``synth_render.render_image``; the JAX
tool warps textures with OpenCV) and extracted in blocks of
``batch_extract.INGEST_BLOCK_MULTIPLE`` frames, one
``extractor.extract_batch`` call a block; the next world's textures (host
numpy) are made on a thread meanwhile.

    python -m orb_slam3_detailed_comments_tpu_torch.tools.eval_vocab \\
        [--domains] [--device cpu] voc_a.npz [voc_b.npz ...]
"""
from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import device as device_mod
from ..examples import runner
from ..models import cameras
from ..ops import extractor
from ..parallel import batch_extract
from ..placerec import vocab
from ..utils import synth_render

# the JAX tool's camera (EuRoC-sized pinhole) and extractor
CAM_KW = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752, height=480)
N_FEATURES = 1024
SEED0 = 50_000
FRAMES_PER_WORLD = 10


def eval_world(seed, texture_fn=None, frames_per_world=FRAMES_PER_WORLD,
               advance=(1.0, 3.0), sway=(0.1, 0.6)):
    """One held-out world: (planes, R_cw [n, 3, 3], t_cw [n, 3]), drawn as
    the JAX tool's ``render_eval_set`` draws it from
    ``default_rng(seed)``: ``default_world``, then ``texture_fn(rng,
    size)`` over every plane's texture, then ``orbit_trajectory``
    (``advance`` and ``sway`` its draws' ranges)."""
    rng = np.random.default_rng(seed)
    planes = synth_render.default_world(
        rng, extent=float(rng.uniform(8, 20)),
        tex_size=int(rng.integers(700, 1500)))
    if texture_fn is not None:
        for pl in planes:
            pl.texture = texture_fn(rng, pl.texture.shape[0])
    R, t = synth_render.orbit_trajectory(
        frames_per_world, advance=float(rng.uniform(*advance)),
        sway=float(rng.uniform(*sway)))
    return planes, R, t


STAGES = ("textures", "world_wait", "render", "extraction")


def frame_blocks(cam, cfg, make_world, seeds, device, stats=None):
    """Yields (imgs [B, H, W], FrameFeatures with a leading axis of B) for
    the frames of the worlds ``make_world(seed) -> (planes, R, t)``, world
    after world and frame after frame, in blocks of
    ``INGEST_BLOCK_MULTIPLE`` frames (the last may be smaller), each block
    ray-cast on ``device`` and extracted by one ``extract_batch`` call.
    The next world is made on a host thread meanwhile (each world draws
    from its own seed, so the order of the draws does not change).

    ``stats``: a dict to which host seconds are added, under "textures"
    (making the worlds, on the thread), "world_wait" (waiting for them),
    "render" and "extraction" (each up to a synchronise)."""
    dev = torch.device(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    stats = {} if stats is None else stats
    for k in STAGES:
        stats.setdefault(k, 0.0)

    def made(seed):
        t0 = time.perf_counter()
        world = make_world(seed)
        return world, time.perf_counter() - t0

    def block(views):
        t0 = time.perf_counter()
        imgs = torch.stack([synth_render.render_image(cam, planes, R, t, dev)
                            for planes, R, t in views])
        sync()
        t1 = time.perf_counter()
        feat = extractor.extract_batch(imgs, cfg)
        sync()
        stats["render"] += t1 - t0
        stats["extraction"] += time.perf_counter() - t1
        return imgs, feat

    seeds = list(seeds)
    views = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(made, seeds[0]) if seeds else None
        for i in range(len(seeds)):
            t0 = time.perf_counter()
            (planes, R, t), secs = nxt.result()
            stats["world_wait"] += time.perf_counter() - t0
            stats["textures"] += secs
            if i + 1 < len(seeds):
                nxt = pool.submit(made, seeds[i + 1])
            for R_cw, t_cw in zip(R, t):
                views.append((planes, R_cw, t_cw))
                if len(views) == batch_extract.INGEST_BLOCK_MULTIPLE:
                    yield block(views)
                    views = []
    if views:
        yield block(views)


def render_eval_set(cam, cfg, n_worlds, frames_per_world, seed0,
                    texture_fn=None, device=None, stats=None):
    """Descriptor sets of ``n_worlds`` held-out worlds (``eval_world`` of
    seeds seed0, seed0 + 1, ...), ``frames_per_world`` frames each:
    (descs: [N, 8] int32 a frame, valids: [N] bool a frame, both on the
    device; world_of [F]; idx_in_world [F]), the JAX tool's four values.
    ``texture_fn(rng, size)`` overrides every plane's texture (the
    domain-shift probe); ``stats`` as ``frame_blocks``."""
    dev = device_mod.resolve(device)
    descs, valids = [], []
    for _, f in frame_blocks(
            cam, cfg, lambda s: eval_world(s, texture_fn, frames_per_world),
            range(seed0, seed0 + n_worlds), dev, stats):
        descs += list(f.desc)
        valids += list(f.valid)
    return (descs, valids, np.repeat(np.arange(n_worlds), frames_per_world),
            np.tile(np.arange(frames_per_world), n_worlds))


def bow_vectors(voc, descs, valids) -> torch.Tensor:
    """[F, n_words] float32 tf-idf vectors on the vocabulary's device, one
    ``transform`` / ``bow_vector`` a frame."""
    dev = voc.device
    return torch.stack([vocab.bow_vector(voc, vocab.transform(
        voc, d.to(dev), v.to(dev))) for d, v in zip(descs, valids)])


def retrieval_metrics(voc, descs, valids, world_of, idx_in_world):
    """(top1, margin) of the odd-frame queries against the even-frame
    database, as the JAX tool computes them; the [Q, D] scores are one
    float32 product on the vocabulary's device."""
    vecs = bow_vectors(voc, descs, valids)
    is_db = idx_in_world % 2 == 0
    db, q = np.where(is_db)[0], np.where(~is_db)[0]
    at = lambda ix: vecs[torch.from_numpy(ix).to(vecs.device)]
    S = (at(q) @ at(db).T).cpu().numpy()       # [Q, D]
    same_world = world_of[q][:, None] == world_of[db][None, :]
    near = same_world & (np.abs(idx_in_world[q][:, None]
                                - idx_in_world[db][None, :]) <= 1)
    top1 = (near[np.arange(len(q)), S.argmax(1)]).mean()
    s_same = np.where(near, S, -np.inf).max(1)
    s_other = np.where(~same_world, S, -np.inf).max(1)
    margin = np.median(s_same / np.maximum(s_other, 1e-9))
    return float(top1), float(margin)


def main(argv=None) -> int:
    args, device = runner.split_device(sys.argv[1:] if argv is None
                                       else argv)
    do_domains = "--domains" in args
    paths = [a for a in args if not a.startswith("--")]
    if not paths:
        raise SystemExit("usage: eval_vocab [--domains] [--device cpu] "
                         "voc.npz [voc2.npz ...]")
    dev = device_mod.resolve(device)
    cam = cameras.pinhole(**CAM_KW)
    cfg = extractor.OrbConfig(n_features=N_FEATURES)

    domains = {"blob": None}
    if do_domains:
        domains.update({k: fn for k, fn in
                        synth_render.TEXTURE_DOMAINS.items() if k != "blob"})
    sets = {}
    for name, fn in domains.items():
        t0 = time.time()
        n_worlds = 20 if name == "blob" else 12
        sets[name] = render_eval_set(cam, cfg, n_worlds, FRAMES_PER_WORLD,
                                     SEED0, fn, dev)
        print(f"rendered {name}: {len(sets[name][0])} frames "
              f"({time.time() - t0:.0f}s)")

    for path in paths:
        voc = vocab.load(path, dev)
        for name, data in sets.items():
            top1, margin = retrieval_metrics(voc, *data)
            print(f"{os.path.basename(path):28s} n_words={voc.n_words:>7d} "
                  f"domain={name:10s} top1={top1:.3f} "
                  f"same/other margin={margin:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
