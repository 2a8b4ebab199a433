"""Frame-parallel ORB extraction over a process group.

Counterpart of ``parallel/batch_extract.py`` of the JAX package. The
reference extracts one frame at a time (src/ORBextractor.cc via
Frame::ExtractORB, src/Frame.cc:513). Frames are independent, so a batch
of them is pure data parallelism: on each device the frames of a block
ride one batched extraction (``extractor.extract_batch``: every kernel
launches once for every 16 pyramid levels of the batch, not once a
frame), and with a process group each rank takes its own block of frames,
the results all-gathered (the JAX code's ``shard_map`` over the mesh
axis ``FRAME_AXIS``). This is the bulk path of offline mapping and
dataset ingestion (``System.track_monocular_batch``), where throughput
matters and not one frame's latency.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import comm, device as device_mod
from ..ops import extractor
from ..pipeline import kernels
from . import dist_ba

FRAME_AXIS = "frames"

# frames a rank in each block of System.track_monocular_batch: on an H100
# (chip_smoke.py phase 13a, 16 frames at 752x480) blocks of 8 took 2.10 ms
# of host time and 87 kernels a frame, blocks of 2 7.38 ms and 356
INGEST_BLOCK_MULTIPLE = 8


def make_batch_extractor(cfg: extractor.OrbConfig, group=None):
    """fn(imgs [B, H, W] float32) -> FrameFeatures with a leading axis of
    B, each rank extracting its block of the B frames (B a multiple of the
    world size: pad with a repeated frame and drop the tail)."""
    group = comm.active(group)

    def extract(imgs):
        feat = extractor.extract_batch(imgs[comm.block(imgs.shape[0], group)],
                                       cfg)
        if group is None:
            return feat
        return comm.all_gather_tree(feat, group, imgs.device)

    return extract


def make_batch_preparer(cam, cfg: extractor.OrbConfig, group=None):
    """Like ``make_batch_extractor`` but the full PreparedFrames (ORB,
    undistortion, normalised coordinates) with a leading batch axis: the
    per-frame input of the tracker."""
    group = comm.active(group)

    def prepare(imgs):
        prep = kernels.prepare_frames(
            imgs[comm.block(imgs.shape[0], group)], cam, cfg)
        if group is None:
            return prep
        return comm.all_gather_tree(prep, group, imgs.device)

    return prepare


def prepare_frames(cam, cfg: extractor.OrbConfig, imgs, group=None,
                   block_multiple: int = 2, device=None,
                   lead: bool = False) -> list:
    """Prepare a sequence of frames [n, H, W] (numpy or a tensor) in
    blocks; returns one PreparedFrame a frame, each equal to
    ``kernels.prepare_frame``'s. A block holds ``block_multiple`` frames a
    rank (the last block padded with repeats of its last frame), so its
    shape is the same for any sequence length and memory stays bounded.
    The blocks run on ``device``, or on the tensor's device (numpy images:
    the card unless ``device`` says otherwise). group: a process group
    whose ranks all call this with the same frames, or rank 0 with
    ``lead=True`` while the others ``dist_ba.serve``."""
    group = comm.active(group)
    if isinstance(imgs, torch.Tensor):
        imgs = imgs.to(device or imgs.device, torch.float32)
    else:
        imgs = torch.from_numpy(np.asarray(imgs, np.float32)).to(
            device_mod.resolve(device))
    if lead and group is not None:
        with dist_ba.LEAD_LOCK:
            dist_ba.announce(group, "prepare_frames",
                             dict(cfg=cfg, block_multiple=block_multiple),
                             (imgs,))
            return prepare_frames(cam, cfg, imgs, group, block_multiple)
    fn = make_batch_preparer(cam, cfg, group)
    n = imgs.shape[0]
    block = block_multiple * comm.world_size(group)
    out = []
    for s in range(0, n, block):
        chunk = imgs[s:s + block]
        pad = block - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk[-1:].expand(pad, *chunk.shape[1:])])
        out.extend(kernels.unbatch(fn(chunk.contiguous()),
                                   min(block, n - s)))
    return out


def _prepare_job(cam, group, cfg, block_multiple):
    """``dist_ba.serve``'s side of a ``prepare_frames`` job."""
    return lambda imgs: prepare_frames(cam, cfg, imgs, group, block_multiple)
