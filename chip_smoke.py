#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py     # the whole check, a few minutes

Phases, each of which raises on failure:
  1. card:   a CUDA card must be present; prints its name and power limit;
  2. build:  compiles the port's CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version at the shapes of
     the 752x480 / 1024-feature main path, with ties, gated rows and -inf
     padding (exact equality; dense_frontend's moment maps within an
     absolute tolerance); the best-2 searches also at shapes from 1 x 1 to
     64 x 5000 with ties planted across and within the kernel's lanes;
     dense_frontend both level by level and as the frame's one call for all
     levels; cell_topk and gather_patches as the frame's one call over the 8
     levels (all-zero, tied, negative and -inf cells, content edges, corners
     outside the image), over tables of 1 and 16 levels (gather_patches
     refusing 17, cell_topk taking 17 in two launches), cell_topk also at
     cells 16, 48, 64, 80 and 24 (the last on its plain version, the shape
     rule), and in their one-level cases (the [C, 1024], [C, 384] and
     [C, 2304] matrices; the "xla"
     front end's atlas; the stereo matcher's 12x12 and 12x22 windows of one
     image, at corners clipped as ops/stereo.py clips them). Timed as
     device time
     (torch.profiler, the "ms" of the JSON record) and with CUDA events
     around the host's calls (launch gaps included), beside the plain
     version, a PyTorch library call where one computes the same function,
     and the least time the card could take (its bound);
  4. main path: seeds a map from ground truth (EuRoC-sized pinhole camera,
     OrbConfig() and MapConfig() defaults, the fused front end), then drives
     Tracker.track_monocular over the trajectory (the tracker adds
     keyframes to the seeded map; keyframe frames are timed apart), checks
     that every kernel of the path launched as often as the frames require,
     gates the poses against the ground truth, counts the host syncs of 3
     frames, profiles 5 more (torch.profiler: device time and kernels per
     frame, the device time of each hand-written kernel, and
     pose_optimization alone; table in chiprun_out/profile_frames.txt),
     re-runs two frames on the CPU from a snapshot of tracker and map and
     compares;
  5. bootstrap path: a fresh map and tracker, fed the rendered orbit from
     the first image: two-view initialisation, initial bundle adjustment,
     one frame through reference-keyframe + local-map tracking, then the
     steady fused step. Gates the map (points, invariants), the path each
     frame took, the launch counts (all five kernels) and the scale-aligned
     ATE; re-runs two frames on the CPU; counts the host syncs of 3 frames;
     profiles 3 steady frames as phase 4 does (table in
     chiprun_out/profile_frames_bootstrap.txt) and prepare_frame alone on
     both front ends, holds the "xla" front end's features against the
     fused one's, and times whole steady frames on either, in turns. The
     bare tracker inserts keyframes here too, but no local mapper runs;
  6. System path: System(cam, MONOCULAR, enable_loop_closing=False) on the
     card, fed test_pipeline_mono's 60-frame orbit (world seed 7, ray-cast
     frames): builds and keeps its own map (keyframe insertion, the
     LocalMapper's triangulation, fusion, local BA and culling), gated by
     test_mono_end_to_end's gates; every kernel's launches checked against
     the frames' paths and the keyframe events' fuse searches; each event
     logged (host clock by stage, the local BA's camera count, points and
     keyframes created and culled); one event replayed on the CPU from a
     snapshot of the map and compared, profiled (device time, kernels, host
     clock, host syncs; chiprun_out/profile_keyframe_event.txt), and its
     fuse searches held against the plain version at their own shapes; 3
     steady frames of the grown map profiled
     (chiprun_out/profile_frames_system.txt); the replayed event's fuse
     matches that differ between card and CPU are named, each with its
     search, projection and Hamming distance;
  7. stereo and RGB-D: System(cam, STEREO, baseline=0.11) and
     System(cam, RGBD, ...) on the 40-frame orbit of world seed 9, and the
     two-camera KB8 rig System(kb8, STEREO, camera2=kb8, T_c1c2=...) on 30
     frames of world seed 17 (the cases of test_pipeline_stereo_rgbd.py and
     test_fisheye_stereo_end_to_end), each held to its JAX test's gates;
     frame 0's stereo depth against the rendered depth; the launches of
     every kernel checked against the frames (two extractions a stereo
     frame, 2 or 12 one-image gathers) and the keyframe events;
     prepare_frame_stereo and prepare_frame_stereo_fisheye on the card
     against the CPU; one steady stereo frame profiled
     (chiprun_out/profile_frame_stereo.txt) and prepare_frame_stereo alone
     (chiprun_out/profile_prepare_stereo.txt).

Output (copied to chiprun_out/chip_smoke_log.txt): per-phase lines, then
on lines of their own the kernels' JSON
record (with the System phase's record under "system", phase 7's under
"stereo"), the card's name
and power limit (nvidia-smi's csv), and last
{"ok": true, "device": {...}}. Exits non-zero with no result line when
there is no CUDA card or the port's package is not beside this script.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "orb_slam3_detailed_comments_tpu_torch"

# the H100 SXM's published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12       # float32 outside the tensor cores
# issue rates per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 32-bit integer
# add, logical and compare operations, and __popc
INT32_PER_SM_CLK = 64
POPC_PER_SM_CLK = 16

# main-path configuration (EuRoC-sized, bench.py's camera and world)
CAM_KW = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752, height=480)
N_TRAJ = 80          # orbit frames; keyframes every KF_EVERY-th frame
KF_EVERY = 2
N_TRACK = 64         # tracked frames, 1 .. N_TRACK, all inside the seeded span
CPU_FRAMES = (20, 21)
PROBE_FROM = 40      # sync count (3 frames) and profile (5) from here on
GATES = dict(tracked=0.95, median_m=0.01, max_m=0.05, cpu_match=0.99,
             cpu_pose=1e-3)


# a copy of every logged line, for what does not fit the end of the output
LOG_COPY = []


def log(*a):
    print(*a, flush=True)
    for f in LOG_COPY:
        print(*a, file=f, flush=True)


def cuda_ms(fn, reps=30, warm=3):
    """Median milliseconds of fn() on the card, from CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


# timings for which every profiler session saw no kernel, so that "ms" is
# a CUDA-event time instead: named in the JSON record
EVENT_FALLBACKS = []


def profiled(run, activities, setup=lambda: None, tries=3):
    """torch.profiler's key averages over run(setup()) (run must
    synchronize; setup runs outside the profiler), profiled again, up to
    tries sessions, while the device's records hold no kernel time: one
    session of the many in a process can lose its CUDA activity records.
    None if every session saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    for attempt in range(tries):
        state = setup()
        with profile(activities=activities) as prof:
            run(state)
        avg = prof.key_averages()
        if sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) > 0:
            return avg
        log(f"  the profiler saw no kernel (session {attempt + 1} of "
            f"{tries})")
    return None


def device_ms(fn, reps=20, warm=3, what="a timed call"):
    """Milliseconds of device time per fn() call: the durations of the
    kernels it launched, from torch.profiler, without the host's launch
    gaps that CUDA events around a host-bound call also count. If no
    profiler session sees a kernel, the CUDA-event time instead, logged
    and listed in EVENT_FALLBACKS."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()

    def run(_):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    avg = profiled(run, [ProfilerActivity.CUDA])
    if avg is None:
        log(f"  {what}: CUDA-event time in place of device time")
        EVENT_FALLBACKS.append(what)
        return cuda_ms(fn, reps=reps, warm=0)
    return sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def timed(rec, kernel, plain, library=None, plain_reps=20):
    """Device time (ms, plain_ms, library_ms) and CUDA-event time
    (event_ms, plain_event_ms) of one frame's calls."""
    name = rec["name"]
    rec.update(ms=device_ms(kernel, what=name), event_ms=cuda_ms(kernel),
               plain_ms=device_ms(plain, reps=plain_reps,
                                  what=f"{name}, plain"),
               plain_event_ms=cuda_ms(plain, reps=plain_reps),
               library_ms=None if library is None else device_ms(
                   library, what=f"{name}, library"))
    return rec


def int_rates():
    """The card's 32-bit integer and __popc rates (operations per second):
    its SM count times its maximum SM clock times the per-SM issue rates."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    sm_hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(sms=sms, sm_clock_hz=sm_hz,
                int32_ops_per_s=sms * sm_hz * INT32_PER_SM_CLK,
                popc_per_s=sms * sm_hz * POPC_PER_SM_CLK)


def bound_ms(n_bytes, n_ops=0, n_int=0, n_popc=0, rates=None):
    """The least time of the work: the larger of its bytes over the memory
    rate and of each kind of operation over its own rate (float32 n_ops on
    the CUDA cores; n_int 32-bit integer operations and n_popc popcounts at
    the card's rates from int_rates())."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    if n_int or n_popc:
        t_o = max(t_o, n_int / rates["int32_ops_per_s"] * 1e3,
                  n_popc / rates["popc_per_s"] * 1e3)
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------- phase 3
def kernel_phase(dev, rates):
    """Every kernel against its plain version at the main path's shapes,
    and the best-2 searches also at a shape that is no multiple of 128."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import (
        brief, extractor, hamming, layout, patches, pyramid, topk)
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    H, W = CAM_KW["height"], CAM_KW["width"]
    orb = extractor.OrbConfig()
    shapes = pyramid.level_shapes(H, W, orb.n_levels, orb.scale)
    n_feat = orb.n_features
    rec = []

    def same(name, got, ref):
        torch.cuda.synchronize()
        err = 0.0
        for g, r in zip(got, ref):
            if g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(f"{name}: kernel differs from its plain "
                                     f"version")
            err = max(err, float((g.double() - r.double()).abs().max()))
        return err

    # 1. cell_topk: the frame's one launch over the 8 levels' score maps
    k, margin = orb.k_per_cell, orb.margin
    contents = layout.content_dims(orb, H, W)
    maps = score_maps_case(rng, shapes, f)
    sel = lambda m, c: topk.cell_topk_levels(m, c, margin, k)
    sel_plain = lambda m, c: topk.cell_topk_levels_plain(m, c, margin, k)
    err = same("cell_topk (the frame's 8 levels)", sel(maps, contents),
               sel_plain(maps, contents))
    for m, c in ((maps[-1:], contents[-1:]), (maps * 2, contents * 2),
                 (maps * 2 + maps[:1], contents * 2 + contents[:1])):
        err = max(err, same(f"cell_topk ({len(m)} levels)", sel(m, c),
                            sel_plain(m, c)))
    # the other cells of the kernel's shape rule: 16 in registers, 48, 64
    # and 80 through the scan kernel; 24, whose area is not 128 m, takes the
    # plain version on the card as well
    for cell in (16, 48, 64, 80, 24):
        err = max(err, same(
            f"cell_topk (cell {cell})",
            topk.cell_topk_levels(maps, contents, margin, k, cell),
            topk.cell_topk_levels_plain(maps, contents, margin, k, cell)))
    # ... and the matrix entry, the one-level case on a [C, 1024] matrix
    for lh, lw in shapes[::3]:
        C = ((lh + 31) // 32) * ((lw + 31) // 32)
        x = np.where(rng.uniform(size=(C, 1024)) < 0.08,
                     rng.integers(7, 100, (C, 1024)), 0).astype(np.float32)
        x[0, :] = 0.0                                   # all-zero cell
        x[1, [5, 900]] = 42.0                           # tie
        x[2, :] = -np.inf                               # padding row
        x[3, :] = -np.inf
        x[3, [9, 600]] = 8.0                            # < k finite values
        err = max(err, same(f"cell_topk ([{C}, 1024] matrix)",
                            topk.cell_topk(f(x), k),
                            topk.cell_topk_plain(f(x), k)))
    # rows of 128 m that are no square of 16 or 32: 1 x A cells and the
    # [48 C, 48] view, both through the scan kernel
    for A in (384, 2304):
        x = np.where(rng.uniform(size=(301, A)) < 0.08,
                     rng.integers(7, 100, (301, A)), 0).astype(np.float32)
        x[1, [5, A - 1]] = 42.0
        x[2, :] = -np.inf
        err = max(err, same(f"cell_topk ([301, {A}] matrix)",
                            topk.cell_topk(f(x), k),
                            topk.cell_topk_plain(f(x), k)))
    # the least work: read the pixels inside the masks (the rest are 0 by
    # definition), one compare each, and write the cells' top-k
    n_in = sum(max(0, min(lh, ch - margin) - margin)
               * max(0, min(lw, cw - margin) - margin)
               for (lh, lw), (ch, cw) in zip(shapes, contents))
    n_px = sum(lh * lw for lh, lw in shapes)
    n_rows = sel(maps, contents)[0].shape[0]
    cells = torch.cat([topk.level_cells(m, c, margin)
                       for m, c in zip(maps, contents)])
    b, by = bound_ms(n_in * 4 + n_rows * k * 8, n_in)
    rec.append(timed(dict(
        name="cell_topk", route="cuda", source=f"{PKG}/csrc/topk.cu",
        replaces="orb_slam3_detailed_comments_tpu/ops/pallas_topk.py:36",
        max_abs_err=err, bound_ms=b, bound_by=by,
        unit=f"one frame: 1 call, {len(shapes)} levels, {n_rows} cells of "
             f"32x32 from {n_in} masked-in pixels of {n_px} in the score "
             f"maps"),
        lambda: sel(maps, contents), lambda: sel_plain(maps, contents),
        lambda: torch.topk(cells, k, dim=1)))

    # 2. gather_patches: the frame's one launch, 1024 37x37 windows from the
    # 8 blur maps at patch_corners' corners, some moved outside the image
    blurs = [f(np.round(rng.uniform(0, 255, s)).astype(np.float32))
             for s in shapes]
    budgets = layout.level_budgets(orb)
    level, rc = corners_case(rng, shapes, contents, budgets, f)
    pw = brief.PATCH_W
    gat = lambda im, lv, r: patches.gather_patches_levels(im, lv, r, pw)
    gat_plain = lambda im, lv, r: patches.gather_patches_levels_plain(
        im, lv, r, pw)
    err = same("gather_patches (the frame's 8 levels)",
               [gat(blurs, level, rc)], [gat_plain(blurs, level, rc)])
    for im, lv in ((blurs[:1], torch.zeros_like(level)),
                   (blurs * 2, level + 8 * (torch.arange(
                       level.shape[0], device=dev) % 2).to(torch.int32))):
        err = max(err, same(f"gather_patches ({len(im)} images)",
                            [gat(im, lv, rc)], [gat_plain(im, lv, rc)]))
    must_raise("gather_patches (17 images)",
               lambda: gat(blurs * 2 + blurs[:1], level, rc))
    # the library call: each level's patches as one index of the level's
    # windows view, at the corners the kernel computes
    starts = patch_starts(shapes, budgets, rc, pw)
    windows = [(im.unfold(0, pw, 1).unfold(1, pw, 1), r0, c0)
               for im, (r0, c0) in zip(blurs, starts)]
    library = lambda: [v[r0, c0] for v, r0, c0 in windows]
    same("gather_patches' library call", [torch.cat(library())],
         [gat_plain(blurs, level, rc)])
    # the least work: read the union of the windows (overlapping windows
    # share pixels) and the corners, write every window
    n_feat = level.shape[0]
    n_cov = covered_pixels(shapes, starts, pw)
    b, by = bound_ms(n_feat * 12 + n_cov * 4 + n_feat * pw * pw * 4, 0)
    rec.append(timed(dict(
        name="gather_patches", route="cuda", source=f"{PKG}/csrc/patches.cu",
        replaces="orb_slam3_detailed_comments_tpu/ops/pallas_patches.py:50",
        max_abs_err=err, bound_ms=b, bound_by=by,
        unit=f"one frame on the fused front end: 1 call, {n_feat} patches "
             f"of {pw}x{pw} covering {n_cov} pixels of {len(shapes)} blur "
             f"maps"),
        lambda: gat(blurs, level, rc), lambda: gat_plain(blurs, level, rc),
        library))
    # ... and the atlas, the one-image case of the "xla" front end: 31x31
    # raw and 37x37 blurred patches of 1024 features
    atlas, offs = patches.build_atlas(blurs, W)
    calls = []
    for ph in (31, 37):
        rca = np.concatenate([np.stack(
            [rng.integers(0, s[0] - ph, n) + o, rng.integers(0, s[1] - ph, n)], 1)
            for s, o, n in zip(shapes, offs, budgets)]).astype(np.int32)
        rca[:2] = [[-4, -9], [atlas.shape[0] - 2, atlas.shape[1] - 1]]
        calls.append((f(rca), ph))
    err_a = max(same("gather_patches (atlas)",
                     [patches.gather_patches(atlas, r, ph)],
                     [patches.gather_patches_plain(atlas, r, ph)])
                for r, ph in calls)
    rec[-1]["max_abs_err"] = max(err, err_a)
    b, by = bound_ms(sum(
        r.numel() * 4 + r.shape[0] * ph * ph * 4 + 4 * covered_pixels(
            [tuple(atlas.shape)], patch_starts([tuple(atlas.shape)],
                                               [r.shape[0]], r, ph), ph)
        for r, ph in calls), 0)
    rec[-1]["atlas"] = dict(max_abs_err=err_a, bound_ms=b, bound_by=by,
                            unit=f"one frame on the \"xla\" front end: 2 "
                                 f"calls, {n_feat} patches of 31x31 and 37x37 "
                                 f"from a {tuple(atlas.shape)} atlas",
                            ms=device_ms(lambda: [patches.gather_patches(
                                atlas, r, ph) for r, ph in calls],
                                what="gather_patches, atlas"))
    rec[-1]["stereo"] = stereo_gather_check(dev, rng, f, same)
    rec[-1]["max_abs_err"] = max(rec[-1]["max_abs_err"], max(
        q["max_abs_err"] for q in rec[-1]["stereo"].values()))

    # 3. hamming_best2_windowed: stage 1 (Q=1024) and stage 2 (Q=4096)
    sf = 1.2 ** np.arange(8)
    t_xy = rng.uniform([0, 0], [W, H], (n_feat, 2)).astype(np.float32)
    t_lv = rng.integers(0, 8, n_feat).astype(np.int32)
    db = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint64).astype(np.uint32)
    tv = rng.uniform(size=n_feat) < 0.98
    def windowed_args(Q, rad, K=n_feat):
        """Stage-like queries near the targets; returns (args, pairs that
        pass the gates)."""
        src = rng.integers(0, K, Q)
        q_uv = (t_xy[src] + rng.normal(0, 2.0, (Q, 2))).astype(np.float32)
        q_lv = np.clip(t_lv[src] + rng.integers(-1, 2, Q), 0, 7).astype(np.int32)
        da = db[src] ^ (rng.uniform(size=(Q, 8)) < 0.05).astype(np.uint32)
        qv = rng.uniform(size=Q) < 0.9
        q_r = (rad * sf[q_lv]).astype(np.float32)
        q_r[1] = 0.0                                     # all-gated row
        args = (f(da.view(np.int32)), f(q_uv), f(q_lv), f(q_r),
                f(np.full(Q, -1, np.int32)), f(np.ones(Q, np.int32)), f(qv),
                f(db[:K].view(np.int32)), f(t_xy[:K]), f(t_lv[:K]), f(tv[:K]))
        du = np.abs(q_uv[:, None, 0] - t_xy[None, :K, 0])
        dv = np.abs(q_uv[:, None, 1] - t_xy[None, :K, 1])
        dl = t_lv[None, :K] - q_lv[:, None]
        return args, int(((du <= q_r[:, None]) & (dv <= q_r[:, None])
                          & (dl >= -1) & (dl <= 1) & tv[None, :K]
                          & qv[:, None]).sum())

    wcalls, n_pass = [], 0
    for Q, rad in ((n_feat, 15.0), (4096, 4.0)):
        args, n = windowed_args(Q, rad)
        wcalls.append(args)
        n_pass += n
    odd = windowed_args(1000, 15.0, K=1000)[0]           # no 128-multiple
    err = max(same("hamming_best2_windowed",
                   hamming.hamming_best2_windowed(*a),
                   hamming.hamming_best2_windowed_plain(*a))
              for a in wcalls + [odd])
    for Q, K in TIE_SHAPES:
        a = tie_case(rng, Q, K, f)
        err = max(err, same(f"hamming_best2_windowed ({Q} x {K}, ties)",
                            hamming.hamming_best2_windowed(*a),
                            hamming.hamming_best2_windowed_plain(*a)))
        b = (a[0], a[7], a[10])
        same(f"hamming_best2 ({Q} x {K}, ties)", hamming.hamming_best2(*b),
             hamming.hamming_best2_plain(*b))
    n_pairs = sum(a[0].shape[0] * n_feat for a in wcalls)
    nbytes = sum(a[0].shape[0] * (32 + 8 + 4 * 4 + 1 + 12) for a in wcalls) \
        + 2 * n_feat * (32 + 8 + 4 + 1)
    # 8 gate operations per pair; per pair that passes, 8 XOR + 8 ADD and 2
    # best-2 compares (integer rate) and 8 __popc (popcount rate)
    b, by = bound_ms(nbytes, n_int=8 * n_pairs + 18 * n_pass,
                     n_popc=8 * n_pass, rates=rates)
    rec.append(timed(dict(
        name="hamming_best2_windowed", route="cuda",
        source=f"{PKG}/csrc/hamming.cu",
        replaces="orb_slam3_detailed_comments_tpu/ops/pallas_hamming.py:133",
        max_abs_err=err, bound_ms=b, bound_by=by,
        unit="one frame: 2 calls, 1024x1024 and 4096x1024"),
        lambda: [hamming.hamming_best2_windowed(*a) for a in wcalls],
        lambda: [hamming.hamming_best2_windowed_plain(*a) for a in wcalls],
        plain_reps=5))

    # 4. hamming_best2 (match_nn's unmasked branch): 1024 x 1024, timed as
    # the two calls of match_nn(mutual=True) on a reference-keyframe frame
    da = db[rng.permutation(n_feat)] ^ (
        rng.uniform(size=(n_feat, 8)) < 0.05).astype(np.uint32)
    da[0] = db[3]
    db2 = db.copy()
    db2[8] = db[3]                                       # tie
    args = (f(da.view(np.int32)), f(db2.view(np.int32)), f(tv))
    err = same("hamming_best2", hamming.hamming_best2(*args),
               hamming.hamming_best2_plain(*args))
    err = max(err, same("hamming_best2 (all masked)",
                        hamming.hamming_best2(args[0], args[1],
                                              torch.zeros_like(args[2])),
                        hamming.hamming_best2_plain(args[0], args[1],
                                                    torch.zeros_like(args[2]))))
    odd = (args[0][:1000], args[1][:1000], args[2][:1000])
    err = max(err, same("hamming_best2 (1000 x 1000)",
                        hamming.hamming_best2(*odd),
                        hamming.hamming_best2_plain(*odd)))
    va = f(rng.uniform(size=n_feat) < 0.98)
    back = (args[1], args[0], va)                        # targets -> queries
    err = max(err, same("hamming_best2 (the mutual call)",
                        hamming.hamming_best2(*back),
                        hamming.hamming_best2_plain(*back)))
    n_pass = n_feat * (int(tv.sum()) + int(va.sum()))
    b, by = bound_ms(2 * (n_feat * 32 * 2 + n_feat + 3 * n_feat * 4),
                     n_int=18 * n_pass, n_popc=8 * n_pass, rates=rates)
    rec.append(timed(dict(
        name="hamming_best2", route="cuda", source=f"{PKG}/csrc/hamming.cu",
        replaces="orb_slam3_detailed_comments_tpu/ops/pallas_hamming.py:52",
        max_abs_err=err, bound_ms=b, bound_by=by,
        unit="one reference-keyframe frame: the 2 calls of "
             "match_nn(mutual=True), 1024x1024 each"),
        lambda: [hamming.hamming_best2(*args), hamming.hamming_best2(*back)],
        lambda: [hamming.hamming_best2_plain(*args),
                 hamming.hamming_best2_plain(*back)], plain_reps=5))
    rec[-1]["one_call_ms"] = device_ms(lambda: hamming.hamming_best2(*args),
                                       what="hamming_best2, one call")
    rec.append(frontend_kernel_check(dev))
    for r in rec:
        held = ("equal to plain" if r["max_abs_err"] == 0 else
                f"within {r['max_abs_err']:.4f} of plain")
        log(f"kernel {r['name']}: {held}; device {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.5f} by {r['bound_by']}); CUDA events "
            f"{r['event_ms']:.4f} ms (plain {r['plain_event_ms']:.4f}) per "
            f"{r['unit']}")
        if "one_call_ms" in r:
            log(f"  {r['name']}, one 1024x1024 call: device "
                f"{r['one_call_ms']:.4f} ms")
        if "atlas" in r:
            q = r["atlas"]
            log(f"  {r['name']} on an atlas: equal to plain; device "
                f"{q['ms']:.4f} ms (bound {q['bound_ms']:.5f} by "
                f"{q['bound_by']}) per {q['unit']}")
    return rec


def stereo_gather_check(dev, rng, f, same):
    """gather_patches' one-image case at the stereo matcher's shapes: 1024
    windows of 12x12 and of 12x22 from a 752x480 image, at corners clipped
    as ops/stereo.bilinear_windows clips them (the JAX package's
    stereo.py:83-86), those at 0 and at H - (P + 1), W - (w + 1) included.
    Against the plain version, the unfold index (the library call) and
    the bound, per call; a rectified frame makes one call of each shape, a
    fisheye frame 12 of 12x12."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import patches, stereo
    H, W = CAM_KW["height"], CAM_KW["width"]
    img = f(np.round(rng.uniform(0, 255, (H, W))).astype(np.float32))
    n = 1024
    P = 2 * stereo.SAD_W + 1
    out = {}
    for half_w in (stereo.SAD_W, stereo.SAD_W + stereo.SLIDE_L):
        w = 2 * half_w + 1
        uc = rng.uniform(-3, W + 3, n).astype(np.float32)
        vc = rng.uniform(-3, H + 3, n).astype(np.float32)
        y0 = np.clip(np.floor(vc).astype(np.int32) - stereo.SAD_W, 0,
                     H - (P + 1))
        x0 = np.clip(np.floor(uc).astype(np.int32) - half_w, 0, W - (w + 1))
        y0[:4] = [0, H - (P + 1), 0, H - (P + 1)]
        x0[:4] = [0, W - (w + 1), W - (w + 1), 0]
        rc = f(np.stack([y0, x0], 1).astype(np.int32))
        ph, pw = P + 1, w + 1
        name = f"{ph}x{pw}"
        gat = lambda: patches.gather_patches(img, rc, ph, pw)
        plain = lambda: patches.gather_patches_plain(img, rc, ph, pw)
        view = img.unfold(0, ph, 1).unfold(1, pw, 1)
        r0, c0 = rc[:, 0].long(), rc[:, 1].long()
        library = lambda: view[r0, c0]
        err = same(f"gather_patches (one image, {name})", [gat()], [plain()])
        same(f"gather_patches' library call ({name})", [library()],
             [plain()])
        n_cov = covered_pixels([(H, W)], [(r0, c0)], ph, pw)
        b, by = bound_ms(n * 8 + n_cov * 4 + n * ph * pw * 4, 0)
        out[name] = dict(
            max_abs_err=err, bound_ms=b, bound_by=by,
            ms=device_ms(gat, what=f"gather_patches, {name}"),
            event_ms=cuda_ms(gat),
            plain_ms=device_ms(plain, what=f"gather_patches, {name}, plain"),
            library_ms=device_ms(library,
                                 what=f"gather_patches, {name}, library"),
            unit=f"one call: {n} windows of {name} covering {n_cov} pixels "
                 f"of a {W}x{H} image")
        q = out[name]
        log(f"  gather_patches, stereo {name}: equal to plain; device "
            f"{q['ms']:.4f} ms (plain {q['plain_ms']:.4f}, unfold index "
            f"{q['library_ms']:.4f}, bound {q['bound_ms']:.5f} by {by}, "
            f"{q['bound_ms'] / q['ms']:.0%} of it); CUDA events "
            f"{q['event_ms']:.4f} ms per {q['unit']}")
    return out


def must_raise(name, fn):
    """fn must refuse its arguments with a ValueError, before any launch."""
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{name}: no error raised")


def score_maps_case(rng, shapes, f):
    """NMS-like score maps of the given level shapes with negative scores
    (NMS keeps them) and scores in the last row and column, past every
    level's content, which the mask must zero. Level 0's cells (1, 1) ..
    (1, 4) and (2, 1), inside its mask: three tied maxima; negative scores
    with two tied maxima; -inf but for three values; all -inf; all zero.
    The last level is all negative."""
    maps = []
    for h, w in shapes:
        s = np.where(rng.uniform(size=(h, w)) < 0.08,
                     rng.integers(1, 120, (h, w)), 0).astype(np.float32)
        neg = rng.uniform(size=(h, w)) < 0.03
        s[neg] = -rng.integers(1, 60, int(neg.sum())).astype(np.float32)
        s[:, -1] = 90.0
        s[h - 1, :] = 91.0
        maps.append(s)
    s = maps[0]
    s[32:64, 32:64] = 0.0
    s[40, 40] = s[40, 50] = s[41, 33] = 77.0
    s[32:64, 64:96] = -rng.integers(2, 60, (32, 32)).astype(np.float32)
    s[35, 70] = s[60, 66] = -1.0
    s[32:64, 96:160] = -np.inf
    s[[33, 50, 63], [97, 120, 96]] = [12.0, 12.0, -3.0]
    s[64:96, 32:64] = 0.0
    maps[-1] = -np.abs(maps[-1]) - 1.0
    return [f(m) for m in maps]


def corners_case(rng, shapes, contents, budgets, f):
    """(level [N] int32, rc [N, 2] int32), level-major: each level's budget
    of 37x37 patch corners as the extractor computes them
    (brief.patch_corners on keypoints in and around the image), and in each
    level two raw corners outside the image, one negative (counted from
    the far end) and one past it (clamped)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import brief
    rcs, lvs = [], []
    for lv, ((h, w), c, n) in enumerate(zip(shapes, contents, budgets)):
        yx = np.stack([rng.integers(-5, h + 5, n),
                       rng.integers(-5, w + 5, n)], 1).astype(np.int32)
        rc = brief.patch_corners(f(yx), brief.PATCH_R, c)
        rc[:2] = f(np.array([[-4, -9], [h - 2, w - 1]], np.int32))
        rcs.append(rc)
        lvs.append(np.full(n, lv, np.int32))
    return f(np.concatenate(lvs)), torch.cat(rcs)


def patch_starts(shapes, budgets, rc, pw):
    """Each level's window starts (r0, c0) of its keypoints' corners, by
    lax.dynamic_slice's rule: the corners the kernel reads at."""
    import torch
    out = []
    for (h, w), r in zip(shapes, rc.long().split(budgets)):
        out.append(tuple(
            torch.clamp(torch.where(x < 0, x + d, x), 0, d - pw)
            for x, d in ((r[:, 0], h), (r[:, 1], w))))
    return out


def covered_pixels(shapes, starts, p, pw=0):
    """Pixels of the images that at least one p x pw window (pw defaults to
    p) covers, the windows at the (r0, c0) starts of patch_starts: the
    least the gather must read."""
    n = 0
    pw = pw or p
    for (h, w), (r0, c0) in zip(shapes, starts):
        cov = np.zeros((h, w), bool)
        for r, c in zip(r0.tolist(), c0.tolist()):
            cov[r:r + p, c:c + pw] = True
        n += int(cov.sum())
    return n


# shapes at which both best-2 searches are held with planted ties: one
# target, fewer targets than lanes, no multiple of anything, the main path's
# largest call, and more targets than one staged tile
TIE_SHAPES = ((1, 1), (5, 31), (1000, 1000), (4096, 1024), (64, 5000))


def tie_case(rng, Q, K, f):
    """Arguments of hamming_best2_windowed with wide-open gates on most
    pairs and ties where the kernel's lanes could get them wrong: query 0's
    descriptor sits at targets j and j + 1 (neighbouring lanes), query 1's
    at j and j + 32 (one lane, successive steps), query 2's two best are
    equal but not zero, query 3 has every target gated out, query 4's only
    admissible target is the last one."""
    desc = lambda n: rng.integers(0, 2 ** 32, (n, 8),
                                  dtype=np.uint64).astype(np.uint32)
    da, db = desc(Q), desc(K)
    t_xy = rng.uniform(0, 700, (K, 2)).astype(np.float32)
    q_uv = rng.uniform(0, 700, (Q, 2)).astype(np.float32)
    q_r = np.full(Q, 1000.0, np.float32)
    t_lv = rng.integers(0, 8, K).astype(np.int32)
    q_lv = rng.integers(0, 8, Q).astype(np.int32)
    lo, hi = np.full(Q, -8, np.int32), np.full(Q, 8, np.int32)
    qv, tv = np.ones(Q, bool), rng.uniform(size=K) < 0.9
    j = int(rng.integers(0, K))
    hit = db[j].copy()
    for q, other in ((0, j + 1), (1, j + 32)):
        if q < Q:
            da[q] = hit
            db[other % K] = hit
            tv[[j, other % K]] = True
    if Q > 2:                    # distance 8 to both (one bit in each word)
        da[2] = db[(j + 5) % K] ^ np.uint32(1)
        db[(j + 70) % K] = db[(j + 5) % K] ^ np.uint32(3)
        tv[[(j + 5) % K, (j + 70) % K]] = True
    if Q > 3:
        q_r[3] = 0.0
        q_uv[3] = -50.0
    if Q > 4:
        q_r[4] = 0.25
        q_uv[4] = t_xy[K - 1]
        q_lv[4] = t_lv[K - 1]
        tv[K - 1] = True
    return (f(da.view(np.int32)), f(q_uv), f(q_lv), f(q_r), f(lo), f(hi),
            f(qv), f(db.view(np.int32)), f(t_xy), f(t_lv), f(tv))


# float operations per pixel that dense_frontend's four maps need, counted
# from the cheapest form in the repo, the plain version of ops/frontend.py
# (a bound is the least work of the function, not of one implementation):
#   moments  running row sums over |u| <= 1 .. 15, shared by every row that
#            uses a half-width: 15 x (2 add for the sum, sub + mul + add for
#            the u-weighted sum) = 75; then 31 adds for m10 and 30 mul + 30
#            add for m01 = 91;
#   blur     separable, 7 mul + 6 add each way, one round = 27;
#   FAST     16 differences; per sign, 9-long arc minima by window doubling
#            (4 x 16 min) and 15 max, the negated sign by min/max duality;
#            1 negation, 1 max = 176;
#   NMS      separable 3x3 max (2 + 2), compare, select = 6.
# csrc/frontend.cu takes this form too, but recomputes the row sums of the
# 30 halo rows for every run of 32 output rows.
FRONTEND_OPS_PER_PIXEL = (75 + 91) + 27 + 176 + 6
MOMENT_TOL = 5.0       # absolute, on moments of order 1e5 (summation order)
ANGLE_TOL = 1e-3       # rad, at interior points


def frontend_kernel_check(dev):
    """dense_frontend against its plain version on the 8 level shapes of a
    rendered 752x480 frame, a small odd shape, a constant image and two
    step edges between 0 and 255 (where the moments' conditioning constant,
    a tile's centre pixel, is 255 away from half the tile), each as a call
    of its own, and the 8 levels again as the frame's one
    dense_frontend_levels call: score and blur exactly equal over the whole
    image, each moment map within MOMENT_TOL, angles read from the maps
    within ANGLE_TOL at random interior points (1024 a level) whose moments
    do not vanish. Then timed as the frame's one call."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import (
        brief, extractor, frontend, pyramid)
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    rng = np.random.default_rng(5)
    cam = cameras.pinhole(**CAM_KW)
    planes = sr.default_world(np.random.default_rng(3))
    R, t = sr.orbit_trajectory(N_TRAJ)
    img = np.round(sr.render_frame_raycast(cam, planes, R[7], t[7])[0])
    orb = extractor.OrbConfig()
    levels = pyramid.build_pyramid(
        torch.from_numpy(img.astype(np.float32)).to(dev), orb.n_levels,
        orb.scale)
    extra = [torch.from_numpy(np.round(rng.uniform(0, 255, (37, 53))).astype(
        np.float32)).to(dev), torch.full((64, 96), 77.0, device=dev)]
    # the edges lie off the 64-pixel tiles' centres (row and column 32)
    step = torch.zeros((96, 160), device=dev)
    step[:, 40:] = 255.0
    extra.append(step)
    step = torch.full((96, 160), 255.0, device=dev)
    step[20:] = 0.0
    extra.append(step)
    worst = dict(m10=0.0, m01=0.0, angle=0.0)
    n_angles = 0
    levels = [l.contiguous() for l in levels]
    together = frontend.dense_frontend_levels(levels)
    torch.cuda.synchronize()
    if len(together) != len(levels):
        raise AssertionError("dense_frontend_levels: one result per level")
    cases = ([(f"level {k} of the frame's one call", l, g)
              for k, (l, g) in enumerate(zip(levels, together))]
             + [(f"image {k} alone", l, None)
                for k, l in enumerate(levels + extra)])
    for k, (what, lvl, got) in enumerate(cases):
        if got is None:
            got = frontend.dense_frontend(lvl)
            torch.cuda.synchronize()
        ref = frontend.dense_frontend_plain(lvl)
        H, W = lvl.shape
        for name, g, r in zip(("score", "blur"), got[:2], ref[:2]):
            if g.shape != r.shape or not torch.equal(g, r):
                bad = int((g != r).sum())
                raise AssertionError(
                    f"dense_frontend {name} differs from its plain version "
                    f"on {bad} pixels of the {H}x{W} image ({what})")
        for name, g, r in zip(("m10", "m01"), got[2:], ref[2:]):
            err = float((g - r).abs().max())
            worst[name] = max(worst[name], err)
            if not err < MOMENT_TOL:
                raise AssertionError(f"dense_frontend {name}: {err} from its "
                                     f"plain version on the {H}x{W} image "
                                     f"({what})")
        if min(H, W) > 40:
            yx = torch.from_numpy(np.stack(
                [rng.integers(16, H - 16, 1024),
                 rng.integers(16, W - 16, 1024)], 1).astype(np.int32)).to(dev)
            d = (brief.angle_from_maps(got[2], got[3], yx)
                 - brief.angle_from_maps(ref[2], ref[3], yx))
            # an angle is defined only where the moments do not vanish: a
            # moment error of MOMENT_TOL turns the angle by at most
            # ANGLE_TOL where |m| >= MOMENT_TOL / ANGLE_TOL
            flat = yx[:, 0].long() * W + yx[:, 1].long()
            strong = torch.hypot(ref[2].reshape(-1)[flat],
                                 ref[3].reshape(-1)[flat]) >= (
                                     MOMENT_TOL / ANGLE_TOL)
            n_angles += int(strong.sum())
            d = float((torch.atan2(torch.sin(d), torch.cos(d)).abs()
                       * strong).max())
            worst["angle"] = max(worst["angle"], d)
            if not d < ANGLE_TOL:
                raise AssertionError(f"dense_frontend angles: {d} rad from "
                                     f"the plain version's on {what}")
    log(f"  dense_frontend: score and blur equal on {len(levels)} levels in "
        f"one call, the same {len(levels)} alone and {len(extra)} extra "
        f"shapes; worst moment error m10 "
        f"{worst['m10']:.4f} m01 {worst['m01']:.4f} (tolerance "
        f"{MOMENT_TOL}), worst angle error {worst['angle']:.2e} rad over "
        f"{n_angles} interior points with non-vanishing moments")
    if n_angles < 1024:
        raise AssertionError(f"only {n_angles} points to compare angles at")
    n_px = sum(int(l.numel()) for l in levels)
    b, by = bound_ms(n_px * 20, n_px * FRONTEND_OPS_PER_PIXEL)
    log(f"  dense_frontend bounds over {n_px} pixels: bytes "
        f"{bound_ms(n_px * 20)[0]:.5f} ms (1 read + 4 writes of float32), "
        f"operations {bound_ms(0, n_px * FRONTEND_OPS_PER_PIXEL)[0]:.5f} ms "
        f"({FRONTEND_OPS_PER_PIXEL} a pixel)")
    return timed(dict(
        name="dense_frontend", route="cuda",
        source=f"{PKG}/csrc/frontend.cu",
        replaces="orb_slam3_detailed_comments_tpu/ops/pallas_frontend.py:187",
        max_abs_err=max(worst["m10"], worst["m01"]), bound_ms=b, bound_by=by,
        unit=f"one frame: 1 call, {len(levels)} levels, {n_px} pixels"),
        lambda: frontend.dense_frontend_levels(levels),
        lambda: [frontend.dense_frontend_plain(l) for l in levels],
        plain_reps=5)


# ---------------------------------------------------------------- phase 4
# what a tracker carries from frame to frame, besides its map
TRACKER_STATE = ("last", "velocity", "ref_kf", "last_kf_id",
                 "last_kf_frame_id", "state", "frame_id", "trajectory",
                 "_seed_from_kfs")


def snapshot(tk):
    """A tracker's state and its map's arrays: the tracker inserts
    keyframes, so a restored one needs the map as it was, too."""
    snap = {key: getattr(tk, key) for key in TRACKER_STATE}
    snap["trajectory"] = list(tk.trajectory)
    snap["map"] = map_arrays(tk.map)
    return snap


def map_arrays(m):
    return {**m.to_numpy(), "tombstones": copy.deepcopy(m.tombstones)}


def _restore(tracking, cam, map_cfg, track_cfg, orb_cfg, dev, snap,
             tracker_kw=None):
    """A tracker (of tracker_kw's sensor, if given), on a copy of the map,
    in the state another tracker had at a snapshot; the map's device copies
    are made here, as the tracker that was snapshotted had them already."""
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    m = MapStore.from_numpy(snap["map"], map_cfg, device=dev)
    m.device_points()
    m.device_kf_obs()
    tk = tracking.Tracker(cam, m, track_cfg, orb_cfg, device=dev,
                          **(tracker_kw or {}))
    for key, val in snap.items():
        if key != "map":
            setattr(tk, key, list(val) if isinstance(val, list) else val)
    return tk


def main_path(dev, cam_kw=CAM_KW, n_traj=N_TRAJ, kf_every=KF_EVERY,
              n_track=N_TRACK, map_cfg=None, orb_cfg=None, track_cfg=None,
              cpu_frames=CPU_FRAMES, probe_from=PROBE_FROM):
    """Seed a map, track frames through Tracker.track_monocular (which
    adds keyframes to the seeded map), check the launch counts and the
    poses, re-run cpu_frames on the CPU, and on the card count the host
    syncs of 3 frames and profile 5, from probe_from on, with a tracker
    and map restored to their state there."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.lie import SE3
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops.extractor import OrbConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import tracking
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr

    cam = cameras.pinhole(**cam_kw)
    map_cfg = map_cfg or MapConfig()
    orb_cfg = orb_cfg or OrbConfig()
    track_cfg = track_cfg or tracking.TrackingConfig(local_pts_cap=4096)
    planes = sr.default_world(np.random.default_rng(3))
    R, t = sr.orbit_trajectory(n_traj)
    t0 = time.perf_counter()
    m = sr.seed_map(cam, planes, R, t, kf_every, map_cfg, dev, orb_cfg)
    seed_s = time.perf_counter() - t0
    cov = m.covisibility_matrix()
    log(f"seeded map: {m.n_kf} keyframes (one every {kf_every} of {n_traj} "
        f"frames), {m.n_points} points, {int((cov >= 15).sum())} covisibility "
        f"pairs >= 15, in {seed_s:.1f} s")
    frames = list(range(1, n_track + 1))
    probe = frames[frames.index(probe_from):][:8]
    imgs = {i: sr.render_frame_raycast(cam, planes, R[i], t[i])[0]
            for i in frames}
    C = sr.camera_centers(R, t)

    tk = tracking.Tracker(cam, m, track_cfg, orb_cfg, device=dev)
    tk.start_from_map(SE3(R[0], t[0]), 0.0, last_kf_id=int(m.kf_ids()[0]))
    snaps = {}
    errs, times, cands, out, kf_frames = [], [], [], {}, []
    native.reset_launches()                 # the main path's run starts here
    for i in frames:
        if i in (cpu_frames[0], probe[0], probe[3]):
            snaps[i] = snapshot(tk)
        n_kf0 = len(tk.new_keyframes)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = tk.track_monocular(imgs[i], 0.05 * i)
        times.append(time.perf_counter() - t0)
        cands.append(tk.n_candidates2)
        if len(tk.new_keyframes) > n_kf0:
            kf_frames.append(i)
        if T is not None:
            errs.append(float(np.linalg.norm(-T[:3, :3].T @ T[:3, 3] - C[i])))
            out[i] = (T, tk.cur_match.copy())
    launches = dict(native.launches)        # ... and ends here
    n = len(frames)
    log(f"stage-2 candidates per frame (ids2 >= 0): {cands}")
    log(f"tracked {len(errs)}/{n} frames; centre error median "
        f"{np.median(errs):.5f} m, max {np.max(errs):.5f} m; the tracker "
        f"inserted {len(kf_frames)} keyframes (frames {kf_frames}), the map "
        f"now holds {m.n_kf}")
    if track_cfg.frontend != "fused":
        raise AssertionError("the main path runs the fused front end")
    expect = dict(dense_frontend=n, cell_topk=n, gather_patches=n,
                  hamming_best2_windowed=2 * tk.n_steps)
    log(f"launches in the main path: {launches} (expected {expect}; "
        f"dense_frontend, cell_topk and gather_patches launch once per "
        f"frame for all pyramid levels)")
    if dev.type == "cuda":
        for name, want in expect.items():
            if launches[name] != want or want == 0:
                raise AssertionError(f"{name}: {launches[name]} launches, "
                                     f"expected {want}")
    if len(errs) < GATES["tracked"] * n:
        raise AssertionError(f"tracked {len(errs)} of {n} frames")
    if np.median(errs) >= GATES["median_m"] or np.max(errs) >= GATES["max_m"]:
        raise AssertionError(f"pose error median {np.median(errs):.4f} m / "
                             f"max {np.max(errs):.4f} m over the gates")
    # frame 1 warms the allocator; keyframe frames are timed apart
    ms = np.array([t for i, t in zip(frames, times)
                   if i != frames[0] and i not in kf_frames]) * 1e3
    kf_ms = {i: t * 1e3 for i, t in zip(frames, times) if i in kf_frames}
    log(f"frame time (host clock, image upload to pose): median "
        f"{np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms over "
        f"{len(ms)} frames without a keyframe; keyframe frames "
        f"{ {i: round(v, 1) for i, v in kf_ms.items()} } ms")

    syncs = prof = None
    if dev.type == "cuda":
        restore = lambda i: _restore(tracking, cam, map_cfg, track_cfg,
                                     orb_cfg, dev, snaps[i])
        syncs = count_syncs(restore(probe[0]), imgs, probe[:3])
        prof = profile_frames(lambda: restore(probe[3]), imgs, probe[3:8])
        # the device's busy share of a frame: its kernel time (profiled)
        # over the frame's unprofiled host-clock time
        prof["busy_share"] = prof["device_ms"] / float(np.median(ms))
        log(f"device busy share of a frame: {prof['busy_share']:.3f}")

    # the same two frames on the CPU, from the same map and tracker state
    cpu = torch.device("cpu")
    tkc = _restore(tracking, cam, map_cfg, track_cfg, orb_cfg, cpu,
                   snaps[cpu_frames[0]])
    worst_match, worst_pose = 1.0, 0.0
    for i in cpu_frames:
        Tc = tkc.track_monocular(imgs[i], 0.05 * i)
        if Tc is None or i not in out:
            raise AssertionError(f"frame {i} not tracked on both devices")
        Tg, mg = out[i]
        agree = float((tkc.cur_match == mg).mean())
        dpose = float(np.abs(Tc - Tg).max())
        worst_match, worst_pose = min(worst_match, agree), max(worst_pose,
                                                               dpose)
    log(f"CPU re-run of frames {cpu_frames}: match_pt agreement "
        f"{worst_match:.4f}, pose difference {worst_pose:.2e}")
    if worst_match < GATES["cpu_match"] or worst_pose > GATES["cpu_pose"]:
        raise AssertionError("card and CPU disagree")
    return dict(launches=launches, frame_ms_median=float(np.median(ms)),
                frame_ms_p90=float(np.percentile(ms, 90)), syncs=syncs,
                profile=prof, kf_inserted=len(kf_frames), kf_frame_ms=kf_ms)


# ---------------------------------------------------------------- phase 5
# bootstrap configuration: phase 4's world on test_pipeline_mono's 60-frame
# orbit, fed from the first image on the fused front end, to a bare
# Tracker: it inserts keyframes but no local mapper adds points, so the map
# keeps its initial points. On the CPU both packages initialise at frame 4
# and have inserted 24 keyframes more by frame 48; the port tracks every
# frame to 55, the JAX package all but frame 53
# (tests/run_bootstrap_fullsize.py prints both).
N_BOOT = 48
BOOT_GATES = dict(init_by=15, min_points=100, steady_frames=10, ate_m=0.05,
                  cpu_match=0.99, cpu_pose=1e-3)


def bootstrap_path(dev, cam_kw=CAM_KW, n_frames=N_BOOT, map_cfg=None,
                   orb_cfg=None, track_cfg=None, gates=BOOT_GATES):
    """A fresh map and tracker fed the rendered orbit from NO_IMAGES_YET:
    two-view initialisation, initial BA, one frame through reference-
    keyframe + local-map tracking, then the steady fused step. Gates the
    map, the path each frame took, the launch counts and the scale-aligned
    ATE; re-runs two steady frames on the CPU; on the card counts the host
    syncs of 3 frames, profiles prepare_frame on both front ends and times
    whole steady frames on either."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig, MapStore)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops.extractor import OrbConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import tracking
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr)

    cam = cameras.pinhole(**cam_kw)
    map_cfg = map_cfg or MapConfig()
    orb_cfg = orb_cfg or OrbConfig()
    track_cfg = track_cfg or tracking.TrackingConfig()
    planes = sr.default_world(np.random.default_rng(3))
    R, t = sr.orbit_trajectory(60)
    imgs = {i: sr.render_frame_raycast(cam, planes, R[i], t[i])[0]
            for i in range(n_frames)}
    C = sr.camera_centers(R, t)
    ts = 0.05 * np.arange(len(C))

    m = MapStore(map_cfg, dev)
    tk = tracking.Tracker(cam, m, track_cfg, orb_cfg, device=dev)
    init_at = None
    how, est, times, out, snaps, kf_frames = {}, [], [], {}, {}, []
    native.reset_launches()                 # the bootstrap path's run starts
    for i in range(n_frames):
        if init_at is not None and i in (init_at + 1, init_at + 5,
                                         init_at + 8, init_at + 11):
            snaps[i] = snapshot(tk)
        steps0, nn0 = tk.n_steps, native.launches["hamming_best2"]
        n_kf0 = len(tk.new_keyframes)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = tk.track_monocular(imgs[i], float(ts[i]))
        times.append(time.perf_counter() - t0)
        if init_at is not None and len(tk.new_keyframes) > n_kf0:
            kf_frames.append(i)
        if T is None:
            how[i] = "none"
            continue
        est.append((ts[i], -T[:3, :3].T @ T[:3, 3]))
        out[i] = (T, tk.cur_match.copy())
        if init_at is None:
            init_at, how[i] = i, "init"
            n_pts, errs = m.n_points, m.check_invariants()
            log(f"initialised at frame {i}: {m.n_kf} keyframes, {n_pts} "
                f"points after the initial BA, invariants {errs}; the "
                f"two-view solve had {tk.n_init_matches} matches and "
                f"triangulated {tk.n_init_good} of them, so "
                f"{n_pts / max(tk.n_init_matches, 1):.3f} of the matches "
                f"became map points")
            if n_pts < gates["min_points"] or errs:
                raise AssertionError(f"initial map: {n_pts} points, {errs}")
        elif tk.n_steps > steps0:
            how[i] = "steady"
        else:
            how[i] = "ref_kf"
            nn = native.launches["hamming_best2"] - nn0
            if dev.type == "cuda" and nn < 2:
                raise AssertionError(f"reference-keyframe tracking launched "
                                     f"hamming_best2 {nn} times")
    launches = dict(native.launches)        # ... and ends here
    log(f"frames by path: {how}")
    if init_at is None or init_at >= gates["init_by"]:
        raise AssertionError(f"not initialised within {gates['init_by']} "
                             f"frames")
    if how.get(init_at + 1) != "ref_kf":
        raise AssertionError(f"frame {init_at + 1} took path "
                             f"{how.get(init_at + 1)}, not the reference "
                             f"keyframe + local map")
    steady = 0
    for i in range(init_at + 2, n_frames):
        if how[i] != "steady":
            break
        steady += 1
    if steady < gates["steady_frames"]:
        raise AssertionError(f"only {steady} frames on the steady step")
    rmse, n_ate, scale = evaluate_ate.ate_rmse(
        ts, C, np.array([e[0] for e in est]), np.array([e[1] for e in est]))
    log(f"{steady} consecutive steady frames after frame {init_at + 1}; "
        f"{len(est)} frames tracked in all; scale-aligned ATE {rmse:.5f} m "
        f"over {n_ate} poses (scale {scale:.4f}); the tracker inserted "
        f"{len(kf_frames)} keyframes after the initial two (frames "
        f"{kf_frames}; no local mapper runs here, so the map keeps "
        f"{m.n_points} points)")
    if not rmse < gates["ate_m"]:
        raise AssertionError(f"ATE {rmse} m over the gate")
    # two best-2 scans a reference-keyframe search, two projection
    # searches a fused step and one a local-map stage outside it
    expect = dict(dense_frontend=n_frames, cell_topk=n_frames,
                  gather_patches=n_frames,
                  hamming_best2=2 * tk.n_ref_kf_searches,
                  hamming_best2_windowed=2 * tk.n_steps
                  + tk.n_local_map_searches)
    log(f"launches on the bootstrap path: {launches} (expected {expect})")
    if dev.type == "cuda":
        for name, want in expect.items():
            if launches[name] != want or want == 0:
                raise AssertionError(f"{name}: {launches[name]} launches, "
                                     f"expected {want}")
    ms = np.array([times[i] for i in range(n_frames)
                   if how[i] == "steady" and i not in kf_frames][1:]) * 1e3
    kf_ms = {i: times[i] * 1e3 for i in kf_frames}
    log(f"steady frame time on the fused front end (host clock): median "
        f"{np.median(ms):.2f} ms over {len(ms)} frames without a keyframe; "
        f"keyframe frames { {i: round(v, 1) for i, v in kf_ms.items()} } "
        f"ms; the initialising frame took {times[init_at] * 1e3:.1f} ms, "
        f"the reference-keyframe frame {times[init_at + 1] * 1e3:.1f} ms")

    cpu_frames = (init_at + 5, init_at + 6)
    syncs = prep = prof = None
    if dev.type == "cuda":
        restore = lambda i: _restore(tracking, cam, map_cfg, track_cfg,
                                     orb_cfg, dev, snaps[i])
        syncs = count_syncs(restore(init_at + 8), imgs,
                            [init_at + 8 + j for j in range(3)])
        prof = profile_frames(lambda: restore(init_at + 11), imgs,
                              [init_at + 11 + j for j in range(3)],
                              table="profile_frames_bootstrap.txt",
                              alone=False)
        prof["busy_share"] = prof["device_ms"] / float(np.median(ms))
        log(f"device busy share of a frame: {prof['busy_share']:.3f}")
        # the frame after initialisation once more, profiled: the only
        # frame that launches hamming_best2
        nn0 = native.launches["hamming_best2"]
        prof["ref_kf_frame"] = profile_frames(
            lambda: restore(init_at + 1), imgs, [init_at + 1],
            table="profile_frame_ref_kf.txt", alone=False)
        if native.launches["hamming_best2"] - nn0 < 2:
            raise AssertionError("the profiled frame did not go through "
                                 "the reference keyframe")
        img_d = torch.from_numpy(imgs[init_at + 8]).to(dev)
        frontends_agree(*(tracking.kernels.prepare_frame(
            img_d, cam, orb_cfg, fe).feat for fe in ("fused", "xla")))
        prep = {fe: profile_call(
            lambda fe=fe: tracking.kernels.prepare_frame(img_d, cam, orb_cfg,
                                                         fe),
            table=f"profile_prepare_{fe}.txt") for fe in ("xla", "fused")}
        # the host clock of one call wanders within a run: read it again
        # in turns (xla, fused, fused, xla), three rounds of 5 calls each
        turns = {"xla": [], "fused": []}
        for fe in ("xla", "fused", "fused", "xla") * 3:
            turns[fe].append(host_ms(
                lambda: tracking.kernels.prepare_frame(img_d, cam, orb_cfg,
                                                       fe)))
        for fe, r in prep.items():
            r["host_ms_turns"] = turns[fe]
            r["host_ms"] = float(np.median(turns[fe]))
            log(f"  prepare_frame alone, front end {fe!r}: device "
                f"{r['device_ms']:.2f} ms in {r['kernels']} kernels, host "
                f"clock median {r['host_ms']:.2f} ms over turns "
                f"{[round(x, 1) for x in turns[fe]]}")
        # whole steady frames on either front end, from one tracker state,
        # in turns (xla, fused, fused, xla)
        ab = {"xla": [], "fused": []}
        ab_frames = [init_at + 8 + j for j in range(4)]
        for fe in ("xla", "fused", "fused", "xla"):
            tka = _restore(tracking, cam, map_cfg, dataclasses.replace(
                track_cfg, frontend=fe), orb_cfg, dev, snaps[init_at + 8])
            for i in ab_frames:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if tka.track_monocular(imgs[i], float(ts[i])) is None:
                    raise AssertionError(f"frame {i} lost on front end {fe}")
                ab[fe].append((time.perf_counter() - t0) * 1e3)
        prep["frame_ms_median"] = {fe: float(np.median(v))
                                   for fe, v in ab.items()}
        log(f"  whole steady frames {ab_frames} in turns, host clock ms: "
            f"xla {[round(x, 1) for x in ab['xla']]}, fused "
            f"{[round(x, 1) for x in ab['fused']]}")

    # the same two steady frames on the CPU, from the same map and state
    cpu = torch.device("cpu")
    tkc = _restore(tracking, cam, map_cfg, track_cfg, orb_cfg, cpu,
                   snaps[cpu_frames[0]])
    worst_match, worst_pose = 1.0, 0.0
    for i in cpu_frames:
        Tc = tkc.track_monocular(imgs[i], float(ts[i]))
        if Tc is None or i not in out:
            raise AssertionError(f"frame {i} not tracked on both devices")
        Tg, mg = out[i]
        worst_match = min(worst_match, float((tkc.cur_match == mg).mean()))
        worst_pose = max(worst_pose, float(np.abs(Tc - Tg).max()))
    log(f"CPU re-run of frames {cpu_frames}: match_pt agreement "
        f"{worst_match:.4f}, pose difference {worst_pose:.2e}")
    if worst_match < gates["cpu_match"] or worst_pose > gates["cpu_pose"]:
        raise AssertionError("card and CPU disagree on the bootstrap path")
    return dict(launches=launches, init_at=init_at, n_points=n_pts,
                n_init_matches=tk.n_init_matches, n_init_good=tk.n_init_good,
                steady=steady, tracked=len(est), ate_m=rmse,
                kf_inserted=len(kf_frames), kf_frame_ms=kf_ms,
                frame_ms_median=float(np.median(ms)), syncs=syncs,
                profile=prof, prepare_frame=prep)


# ---------------------------------------------------------------- phase 6
# the monocular System of test_pipeline_mono.py's test_mono_end_to_end with
# loop closing off, at full width: the 60-frame orbit in world seed 7,
# rendered by ray casting, ts = 0.05 i, OrbConfig(), MapConfig(), the fused
# front end. On the CPU (tests/run_bootstrap_fullsize.py system-torch and
# system-jax) both packages initialise at frame 3 and keep 57 trajectory
# rows; the port ends at 18 keyframes and 1,354 points, the JAX package at
# 15 and 1,207.
N_SYS = 60
SYS_GATES = dict(tracked=0.7, min_kf=3, min_points=200, last_tracked=30,
                 rows=0.7, ate_m=0.05, ate_poses=0.6, max_cams=48,
                 replay_new=0.05)
SYS_STAGES = ("KF insertion", "MP culling", "MP creation", "local BA",
              "KF culling")


def system_path(dev, cam_kw=CAM_KW, n_frames=N_SYS, world_seed=7,
                map_cfg=None, orb_cfg=None, track_cfg=None, mapping_cfg=None,
                gates=SYS_GATES, replay_from=45, profile_from=50):
    """System(cam, MONOCULAR, enable_loop_closing=False) fed the orbit:
    gates the run with test_mono_end_to_end's gates, checks that each
    kernel launched as often as the frames and keyframe events require,
    logs each keyframe event (host clock by span, the local BA's camera
    count, points created, culled and fused, keyframes culled), replays
    one event on the CPU from a snapshot of the map taken before it and
    compares (the first from frame replay_from on that culled a keyframe,
    else the first from there on); on the card also profiles that event
    and 3 frames from profile_from on, and holds the fuse passes' searches
    against the plain version at their own shapes."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig, MapStore)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import hamming
    from orb_slam3_detailed_comments_tpu_torch.ops.extractor import OrbConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        local_mapping, system, tracking)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr, timing)

    cam = cameras.pinhole(**cam_kw)
    map_cfg = map_cfg or MapConfig()
    track_cfg = track_cfg or tracking.TrackingConfig()
    orb_cfg = orb_cfg or OrbConfig(n_features=track_cfg.n_features)
    mapping_cfg = mapping_cfg or local_mapping.LocalMappingConfig()
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(60)
    imgs = {i: sr.render_frame_raycast(cam, planes, R[i], t[i])[0]
            for i in range(n_frames)}
    C = sr.camera_centers(R, t)
    ts = 0.05 * np.arange(len(C))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    slam = system.System(cam, system.MONOCULAR, map_cfg=map_cfg,
                         tracking_cfg=track_cfg, mapping_cfg=mapping_cfg,
                         enable_loop_closing=False, orb_cfg=orb_cfg,
                         device=dev)
    tk, lm = slam.tracker, slam.local_mapper
    events, replay, frame = [], {}, [0]
    process = lm.process_keyframe

    def logged_process(k):
        snap = None
        if "index" not in replay and frame[0] >= replay_from:
            snap = dict(index=len(events), frame=frame[0], kf=int(k),
                        map=map_arrays(lm.map), recent=dict(lm.recent_points))
            replay.setdefault("first", snap)
        n0 = {st: len(timing.samples(st)) for st in SYS_STAGES}
        sync()
        t0 = time.perf_counter()
        if snap is None:
            process(k)
        else:
            snap["fuse_matches"] = fuse_matches(lm, lambda: process(k))
        sync()
        host = (time.perf_counter() - t0) * 1e3
        events.append(dict(lm.last_event, frame=frame[0], host_ms=host,
                           span_ms={st: 1e3 * sum(timing.samples(st)[n0[st]:])
                                    for st in SYS_STAGES}))
        ev = events[-1]
        log(f"  keyframe event at frame {frame[0]}: keyframe {ev['kf']}, "
            f"{host:.1f} ms host clock ("
            + ", ".join(f"{st} {v:.1f}" for st, v in ev["span_ms"].items())
            + f"); local BA C = {ev['ba_cams']}; points +{ev['new_points']} "
            f"created, {ev['culled_points']} culled, {ev['fused']} fuse "
            f"links; keyframes culled {ev['culled_kfs']}; "
            f"{ev['fuse_searches']} fuse searches")
        if ev["ba_cams"] > gates["max_cams"]:
            raise AssertionError(f"local BA with {ev['ba_cams']} cameras: "
                                 f"the table tier stops at "
                                 f"{gates['max_cams']}")
        if snap is not None and ev["culled_kfs"]:
            replay.update(snap)

    lm.process_keyframe = logged_process
    poses, times, how, prof_snap = [], [], {}, None
    native.reset_launches()                 # the System path's run starts
    for i in range(n_frames):
        frame[0] = i
        if i == profile_from:
            prof_snap = snapshot(tk)
        steps0, ref0, n_ev0 = tk.n_steps, tk.n_ref_kf_searches, len(events)
        sync()
        t0 = time.perf_counter()
        T = slam.track_monocular(imgs[i], float(ts[i]))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        poses.append(T)
        how[i] = ("none" if T is None else "init" if tk.n_steps == steps0
                  and tk.n_ref_kf_searches == ref0 else "steady"
                  if tk.n_ref_kf_searches == ref0 else "ref_kf")
        if len(events) > n_ev0:
            how[i] += "+kf"
    launches = dict(native.launches)        # ... and ends here
    lm.process_keyframe = process
    log(f"frames by path: {how}")

    # launches: extraction once a frame; the reference-keyframe search's
    # two best-2 scans; two projection searches a fused step, one for each
    # local-map stage outside it, one for each fuse search of an event
    n_fuse = sum(ev["fuse_searches"] for ev in events)
    expect = dict(dense_frontend=n_frames, cell_topk=n_frames,
                  gather_patches=n_frames,
                  hamming_best2=2 * tk.n_ref_kf_searches,
                  hamming_best2_windowed=2 * tk.n_steps
                  + tk.n_local_map_searches + n_fuse)
    log(f"launches on the System path: {launches} (expected {expect}: "
        f"{tk.n_steps} fused steps, {tk.n_ref_kf_searches} reference-"
        f"keyframe and {tk.n_local_map_searches} local-map stages, "
        f"{len(events)} keyframe events with {n_fuse} fuse searches)")
    if dev.type == "cuda":
        for name, want in expect.items():
            if launches[name] != want or want == 0:
                raise AssertionError(f"{name}: {launches[name]} launches, "
                                     f"expected {want}")
    if n_fuse == 0:
        raise AssertionError("no keyframe event ran a fuse search")

    # test_mono_end_to_end's gates
    tracked = [i for i, p in enumerate(poses) if p is not None]
    mp = slam.get_tracked_map_points()
    rows = slam.trajectory_tum()
    rmse, n_ate, scale = evaluate_ate.ate_rmse(
        ts, C, np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    errs = slam.check_map_consistency()
    rec = dict(tracked=len(tracked), keyframes=slam.n_keyframes,
               points=slam.n_map_points, state=slam.get_tracking_state(),
               lost=slam.is_lost(), last_tracked=int((mp >= 0).sum()),
               consistency=errs, rows=len(rows), ate_m=rmse, ate_poses=n_ate,
               ate_scale=scale, init_at=tracked[0] if tracked else None,
               n_events=len(events), launches=launches)
    log(f"System: initialised at frame {rec['init_at']}; {len(tracked)}/"
        f"{n_frames} frames tracked; {slam.n_keyframes} keyframes, "
        f"{slam.n_map_points} points; state {rec['state']}, lost "
        f"{rec['lost']}; {rec['last_tracked']} map points in the last "
        f"frame; consistency {errs}; {len(rows)} trajectory rows; "
        f"scale-aligned ATE {rmse:.5f} m over {n_ate} poses (scale "
        f"{scale:.4f}); {len(events)} keyframe events, "
        f"{sum(len(ev['culled_kfs']) for ev in events)} keyframes culled")
    n = n_frames
    fails = [name for name, bad in (
        ("frames tracked", len(tracked) <= gates["tracked"] * n),
        ("keyframes", slam.n_keyframes < gates["min_kf"]),
        ("map points", slam.n_map_points <= gates["min_points"]),
        ("final state", rec["state"] != tracking.OK or rec["lost"]),
        ("last frame's map points", rec["last_tracked"]
         <= gates["last_tracked"]),
        ("map consistency", errs != []),
        ("trajectory rows", len(rows) <= gates["rows"] * n),
        ("ATE", not (n_ate > gates["ate_poses"] * n
                     and rmse < gates["ate_m"]))) if bad]
    if fails:
        raise AssertionError(f"the System missed the gates: {fails}")

    steady = [i for i in range(1, n_frames) if how[i] == "steady"]
    ms = np.array([times[i] for i in steady])
    rec.update(frame_ms_median=float(np.median(ms)),
               frame_ms_p90=float(np.percentile(ms, 90)),
               kf_frame_ms={i: times[i] for i in range(n_frames)
                            if how[i].endswith("+kf")},
               events=[{k: v for k, v in ev.items()} for ev in events])
    log(f"frame time (host clock, image upload to pose): median "
        f"{rec['frame_ms_median']:.2f} ms, p90 {rec['frame_ms_p90']:.2f} ms "
        f"over {len(ms)} steady frames without a keyframe event; keyframe "
        f"frames (tracking + local mapping) "
        f"{ {i: round(v, 1) for i, v in rec['kf_frame_ms'].items()} } ms")

    if "first" not in replay:
        raise AssertionError(f"no keyframe event from frame {replay_from} "
                             f"on to replay")
    replay = {**replay.pop("first"), **replay}
    k, ev_card = replay["kf"], events[replay["index"]]
    fuse_card = replay["fuse_matches"]

    def mapper(device):
        m = MapStore.from_numpy(replay["map"], map_cfg, device=device)
        lm2 = local_mapping.LocalMapper(m, cam, mapping_cfg)
        lm2.recent_points = dict(replay["recent"])
        return lm2

    # the event once more on the CPU, from the snapshot taken before it
    t0 = time.perf_counter()
    lm_cpu = mapper(torch.device("cpu"))
    fuse_cpu = fuse_matches(lm_cpu, lambda: lm_cpu.process_keyframe(k))
    ev_cpu = lm_cpu.last_event
    rec["replay"] = dict(frame=replay["frame"], kf=k, card=ev_card,
                         cpu=dict(ev_cpu), cpu_s=time.perf_counter() - t0)
    log(f"keyframe event of frame {replay['frame']} replayed on the CPU in "
        f"{rec['replay']['cpu_s']:.1f} s: new points {ev_cpu['new_points']} "
        f"(card {ev_card['new_points']}), culled points "
        f"{ev_cpu['culled_points']} (card {ev_card['culled_points']}), "
        f"culled keyframes {ev_cpu['culled_kfs']} (card "
        f"{ev_card['culled_kfs']}), fuse links {ev_cpu['fused']} (card "
        f"{ev_card['fused']})")
    rec["replay"]["fuse_diff"] = fuse_diff(fuse_card, fuse_cpu)
    if (abs(ev_cpu["new_points"] - ev_card["new_points"])
            > gates["replay_new"] * ev_card["new_points"]
            or ev_cpu["culled_kfs"] != ev_card["culled_kfs"]
            or ev_cpu["culled_points"] != ev_card["culled_points"]):
        raise AssertionError("the keyframe event differs between the card "
                             "and the CPU")

    if dev.type == "cuda":
        rec["event_profile"] = profile_event(mapper, dev, k)
        rec["fuse_search_check"] = fuse_search_check(mapper, dev, k, hamming)
        rec["profile"] = profile_frames(
            lambda: _restore(tracking, cam, map_cfg, track_cfg, orb_cfg, dev,
                             prof_snap), imgs,
            [profile_from + j for j in range(3)],
            table="profile_frames_system.txt", alone=False)
        rec["profile"]["busy_share"] = (rec["profile"]["device_ms"]
                                        / rec["frame_ms_median"])
        log(f"device busy share of a steady frame: "
            f"{rec['profile']['busy_share']:.3f}")
    return rec


# ---------------------------------------------------------------- phase 7
# stereo, fisheye stereo and RGB-D at full width, the cases of
# tests/test_pipeline_stereo_rgbd.py and test_pipeline_fisheye.py's
# test_fisheye_stereo_end_to_end: a rectified pinhole pair (EuRoC's camera,
# baseline 0.11 m) and RGB-D on world seed 9's 40-frame orbit, a KB8 rig
# (TUM-VI-like, T_c1c2 = +0.11 m in x) on world seed 17's first 30 frames;
# ts = 0.05 i, ray-cast frames, loop closing off.
STEREO_N, FISHEYE_N, BASELINE = 40, 30, 0.11
KB8_KW = dict(fx=380.0, fy=380.0, cx=376.0, cy=240.0, width=752, height=480,
              k1=0.0034, k2=0.0008, k3=-0.0007, k4=0.0001)
STEREO_GATES = dict(
    depth=dict(min_matches=200, median_rel=0.03, within_01=0.85),
    stereo=dict(tracked=0.8, ate_poses=0.7, ate_m=0.05, scale=0.03),
    rgbd=dict(tracked=0.8, ate_poses=0.7, ate_m=0.04),
    fisheye=dict(tracked=0.7, ate_poses=0.6, ate_m=0.06),
    cpu_valid=0.99, cpu_depth_rel=1e-3, cpu_inv_depth=1e-6,
    # whole-program depths outside cpu_depth_rel, each one with inputs that
    # differ between the devices' front ends: the H100 read 1 (rectified)
    # and 3 (KB8); the cap is those counts and a margin of one or two
    cpu_outside=dict(stereo=2, fisheye=5))
# one-image gathers a frame: the rectified matcher's 12x12 and 12x22, the
# fisheye refinement's 12 of 12x12 (ops/stereo.py)
SAD_GATHERS = dict(stereo=2, rgbd=0, fisheye=12)


def stereo_path(dev, cam_kw=CAM_KW, kb8_kw=KB8_KW, n_frames=STEREO_N,
                n_fisheye=FISHEYE_N, map_cfg=None, orb_cfg=None,
                gates=STEREO_GATES, profile_from=30):
    """Phase 7: System(cam, STEREO / RGBD, ...) and the two-camera rig on
    the card, each gated as its JAX test is, with every kernel's launches
    checked against its frames' paths and keyframe events; frame 0's
    stereo depth against the rendered depth; prepare_frame_stereo and
    prepare_frame_stereo_fisheye on the card against the CPU; on the card
    one steady stereo frame profiled and prepare_frame_stereo alone."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops.extractor import OrbConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        kernels, system, tracking)
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr

    cam = cameras.pinhole(**cam_kw)
    kb8 = cameras.fisheye_kb8(**kb8_kw)
    map_cfg = map_cfg or MapConfig()
    orb_cfg = orb_cfg or OrbConfig()
    bf = BASELINE * cam.fx
    out = {}
    t0 = time.perf_counter()
    planes = sr.default_world(np.random.default_rng(9))
    R, t = sr.orbit_trajectory(n_frames)
    pairs, rgbd = [], []
    for i in range(n_frames):
        img, X, hit = sr.render_frame_raycast(cam, planes, R[i], t[i])
        rgbd.append((img, sr.camera_depth(R[i], t[i], X, hit)))
        pairs.append(sr.render_stereo_pair(cam, planes, R[i], t[i],
                                           BASELINE))
    planes_f = sr.default_world(np.random.default_rng(17))
    Rf, tf = sr.orbit_trajectory(40)
    T_c1c2 = np.eye(4, dtype=np.float32)
    T_c1c2[0, 3] = BASELINE
    fish = [(sr.render_frame_raycast(kb8, planes_f, Rf[i], tf[i])[0],
             sr.render_frame_raycast(kb8, planes_f, Rf[i], (
                 tf[i] - np.array([BASELINE, 0, 0])).astype(np.float32))[0])
            for i in range(n_fisheye)]
    log(f"  rendered {n_frames} stereo pairs with depth maps and "
        f"{n_fisheye} KB8 pairs in {time.perf_counter() - t0:.1f} s")

    # frame 0's depth (test_stereo_match_kernel_depth's gates)
    up = lambda a: torch.from_numpy(a).to(dev)
    prep, depth, _ = kernels.prepare_frame_stereo(
        up(pairs[0][0]), up(pairs[0][1]), cam, bf, orb_cfg)
    d, xy, v = (x.cpu().numpy() for x in (depth, prep.feat.xy,
                                         prep.feat.valid))
    ok = (d > 0) & v
    gt = rgbd[0][1][np.clip(xy[ok][:, 1].astype(int), 0, cam.height - 1),
                    np.clip(xy[ok][:, 0].astype(int), 0, cam.width - 1)]
    rel = np.abs(d[ok][gt > 0] - gt[gt > 0]) / gt[gt > 0]
    g = gates["depth"]
    out["depth"] = dict(matches=int(ok.sum()), median_rel=float(
        np.median(rel)), within_01=float((rel < 0.1).mean()))
    log(f"stereo depth of frame 0: {ok.sum()} matches, median relative "
        f"error {out['depth']['median_rel']:.4f}, "
        f"{out['depth']['within_01']:.3f} within 0.1")
    if not (ok.sum() > g["min_matches"] and np.median(rel) < g["median_rel"]
            and (rel < 0.1).mean() > g["within_01"]):
        raise AssertionError(f"stereo depth missed its gates: "
                             f"{out['depth']}")

    # the card against the CPU on one frame of each stereo program: the
    # whole program, and its matching alone on the CPU's features (the
    # front ends of the two devices may differ in a keypoint now and then:
    # phases 4 and 5 hold them to 99 %)
    out["card_vs_cpu"] = stereo_card_vs_cpu(
        dev, cam, kb8, bf, orb_cfg, pairs[0], fish[0], T_c1c2, gates)
    C = sr.camera_centers(R, t)
    runs = dict(
        stereo=(lambda: system.System(cam, system.STEREO, map_cfg=map_cfg,
                                      orb_cfg=orb_cfg, baseline=BASELINE,
                                      enable_loop_closing=False, device=dev),
                lambda s, i: s.track_stereo(*pairs[i], 0.05 * i), n_frames,
                C),
        rgbd=(lambda: system.System(cam, system.RGBD, map_cfg=map_cfg,
                                    orb_cfg=orb_cfg, baseline=BASELINE,
                                    enable_loop_closing=False, device=dev),
              lambda s, i: s.track_rgbd(*rgbd[i], 0.05 * i), n_frames, C),
        fisheye=(lambda: system.System(kb8, system.STEREO, map_cfg=map_cfg,
                                       orb_cfg=orb_cfg, camera2=kb8,
                                       T_c1c2=T_c1c2,
                                       enable_loop_closing=False,
                                       device=dev),
                 lambda s, i: s.track_stereo(*fish[i], 0.05 * i), n_fisheye,
                 sr.camera_centers(Rf, tf)[:n_fisheye]))
    for name, (make, feed, n, centres) in runs.items():
        snaps = {}
        out[name] = sensor_run(name, make, feed, n, centres, gates[name],
                               dev, snaps,
                               range(profile_from, profile_from + 4)
                               if name == "stereo" else ())
        track_cfg = out[name].pop("track_cfg")
        if name == "stereo" and dev.type == "cuda":
            steady = [i for i in snaps if out[name]["how"][i] == "steady"]
            if not steady:
                raise AssertionError("no steady frame to profile")
            i = steady[0]
            tk_kw = dict(sensor=tracking.SENSOR_STEREO, bf=bf)
            make_tk = lambda: _restore(tracking, cam, map_cfg, track_cfg,
                                       orb_cfg, dev, snaps[i], tk_kw)
            track = lambda tk, j: tk.track_stereo(*pairs[j], 0.05 * j)
            tk = make_tk()
            sites = sync_sites(lambda: track(tk, i))
            prof = profile_frames(make_tk, None, [i],
                                  table="profile_frame_stereo.txt",
                                  alone=False, track=track)
            prof["syncs"] = sum(sites.values())
            prof["sync_sites"] = dict(sites)
            prof["busy_share"] = prof["device_ms"] / out[name][
                "frame_ms_median"]
            pl, pr = up(pairs[i][0]), up(pairs[i][1])
            prof["prepare_frame_stereo"] = profile_call(
                lambda: kernels.prepare_frame_stereo(pl, pr, cam, bf,
                                                     orb_cfg),
                table="profile_prepare_stereo.txt")
            log(f"stereo frame {i} profiled: device {prof['device_ms']:.2f} "
                f"ms in {prof['kernels']:.0f} kernels, {prof['syncs']} host "
                f"syncs ({dict(sites.most_common(6))}), busy share "
                f"{prof['busy_share']:.3f}; prepare_frame_stereo alone: "
                f"device {prof['prepare_frame_stereo']['device_ms']:.2f} ms "
                f"in {prof['prepare_frame_stereo']['kernels']} kernels, host "
                f"clock {prof['prepare_frame_stereo']['host_ms']:.2f} ms")
            out[name]["profile"] = prof
    return out


def stereo_card_vs_cpu(dev, cam, kb8, bf, orb_cfg, pair, fish, T_c1c2,
                       gates):
    """prepare_frame_stereo and prepare_frame_stereo_fisheye on one frame,
    on the card and on the CPU, and their matching after the extraction
    (stereo_match; fisheye_stereo_depth) on the card from the CPU's
    features. Gates: the depth-valid sets agree on
    >= 99 % of the features; on the CPU's own features the card's matching
    (stereo_match; fisheye_stereo_depth) gives every feature valid on both
    a depth within 1e-3 relative (or, past ~1 km, 1e-6 per metre in
    inverse depth); and every feature outside that tolerance in the whole
    programs is one whose inputs differ between the devices (within it on
    the shared features), no more of them than gates["cpu_outside"]. Where
    the devices' front ends part is logged by ``frontend_diff``."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import (
        extractor, pyramid, stereo)
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
    cpu = torch.device("cpu")
    T_rl = np.linalg.inv(T_c1c2.astype(np.float64)).astype(np.float32)

    def match(name, d_, p, fr, imgs):
        """The program's depth from given features, on device d_."""
        mv = lambda x: x.to(d_)
        L, Rr = (torch.from_numpy(a).to(d_) for a in imgs)
        if name == "stereo":
            return stereo.stereo_match(
                mv(p.xy_ud), mv(p.feat.level), mv(p.feat.desc),
                mv(p.feat.valid), mv(fr.xy), mv(fr.level), mv(fr.desc),
                mv(fr.valid), L, Rr, bf, min_z=max(bf / cam.fx * 2.0, 0.3),
                n_levels=orb_cfg.n_levels, scale=orb_cfg.scale).depth
        p = kernels.PreparedFrame(extractor.FrameFeatures(
            *(mv(a) for a in p.feat)), mv(p.xy_ud), mv(p.xyn))
        fr = extractor.FrameFeatures(*(mv(a) for a in fr))
        return kernels.fisheye_stereo_depth(
            p, fr, L, Rr, kb8, kb8, torch.from_numpy(T_rl[:3, :3]).to(d_),
            torch.from_numpy(T_rl[:3, 3]).to(d_))[0]

    def close(a, b):
        rel = np.abs(a - b) / b
        return ((rel < gates["cpu_depth_rel"])
                | (np.abs(1 / a - 1 / b) < gates["cpu_inv_depth"])), rel

    def program(name, d_, imgs):
        L, Rr = (torch.from_numpy(a).to(d_) for a in imgs)
        if name == "stereo":
            return kernels.prepare_frame_stereo(L, Rr, cam, bf, orb_cfg)[1]
        return kernels.prepare_frame_stereo_fisheye(
            L, Rr, kb8, kb8, torch.from_numpy(T_rl[:3, :3]).to(d_),
            torch.from_numpy(T_rl[:3, 3]).to(d_), orb_cfg)[1]

    out = {}
    for name, imgs in (("stereo", pair), ("fisheye", fish)):
        zs, feats = {}, {}
        for d_ in (dev, cpu):
            zs[d_.type] = program(name, d_, imgs).cpu().numpy()
            L, Rr = (torch.from_numpy(a).to(d_) for a in imgs)
            feats[d_.type] = (kernels.prepare_frame(
                L, cam if name == "stereo" else kb8, orb_cfg),
                extractor.extract(Rr, orb_cfg))
        # the matching of the card on the CPU's features
        zx = match(name, dev, *feats["cpu"], imgs).cpu().numpy()
        zg, zc = zs[dev.type], zs["cpu"]
        vg, vc, vx = zg > 0, zc > 0, zx > 0
        both = vg & vc
        ok, rel = close(zg[both], zc[both])
        okx, relx = close(zx[vx & vc], zc[vx & vc])
        shared_ok = np.zeros_like(vc)
        shared_ok[np.where(vx & vc)[0][okx]] = True
        outside = np.where(both)[0][~ok]
        # a feature outside the tolerance whose depth the card's matching
        # does give within it from the CPU's features differs by its inputs
        unexplained = [int(i) for i in outside if not shared_ok[i]]
        differ = {side: frontend_diff(g, c) for side, g, c in (
            ("left", feats[dev.type][0].feat, feats["cpu"][0].feat),
            ("right", feats[dev.type][1], feats["cpu"][1]))}
        # the pyramid is two matrix products a level, summed in another
        # order by each device's library
        pyr = [pyramid.build_pyramid(torch.from_numpy(imgs[0]).to(d_),
                                     orb_cfg.n_levels, orb_cfg.scale)
               for d_ in (dev, cpu)]
        differ["left"]["pyramid_max_diff"] = [
            float((a.cpu() - b).abs().max()) for a, b in zip(*pyr)]
        q = out[name] = dict(
            valid_agree=float((vg == vc).mean()), n_valid=int(vg.sum()),
            max_rel=float(rel.max()), n_outside=len(outside),
            shared_valid_agree=float((vx == vc).mean()),
            shared_max_rel=float(relx.max()),
            shared_n_outside=int((~okx).sum()),
            descriptors_differing=differ, unexplained=unexplained)
        log(f"  {name} frame 0, card against CPU: depth-valid sets agree on "
            f"{q['valid_agree']:.4f} of the features ({q['n_valid']} valid "
            f"on the card), largest relative depth difference "
            f"{q['max_rel']:.2e}, {len(outside)} outside 1e-3 (or 1e-6 per "
            f"metre in inverse depth); where the devices' front ends part "
            f"{differ}; on the CPU's features the "
            f"card's matching agrees on {q['shared_valid_agree']:.4f}, "
            f"largest relative difference {q['shared_max_rel']:.2e}, "
            f"{q['shared_n_outside']} outside")
        if (q["valid_agree"] < gates["cpu_valid"]
                or q["shared_valid_agree"] < gates["cpu_valid"]
                or q["shared_n_outside"] or unexplained
                or len(outside) > gates["cpu_outside"][name]):
            raise AssertionError(f"{name}: card and CPU depths disagree: "
                                 f"{q}")
    return out


def frontend_diff(card, cpu):
    """Where two devices' features of one image part, by the stage that
    makes the difference: keypoints (xy, level) kept on one side only (the
    pyramid, the FAST score, its NMS or the selection), and their levels;
    among the keypoints both keep,
    angles in another of the descriptor's rotation bins (the intensity
    moments), and descriptors that differ within the same bin (the blurred
    intensities flipping pair tests), with the bits that differ in each."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import brief
    fa, fb = ({k: t.cpu() for k, t in f._asdict().items()}
              for f in (card, cpu))

    def keys(f):
        return {(float(x), float(y), int(lv)): i for i, ((x, y), lv, ok)
                in enumerate(zip(f["xy"].tolist(), f["level"].tolist(),
                                 f["valid"].tolist())) if ok}
    ka, kb = keys(fa), keys(fb)
    both = sorted(set(ka) & set(kb))
    ia = torch.tensor([ka[k] for k in both], dtype=torch.long)
    ib = torch.tensor([kb[k] for k in both], dtype=torch.long)
    other_bin = (brief.angle_bin(fa["angle"][ia])
                 != brief.angle_bin(fb["angle"][ib])).numpy()
    xor = (fa["desc"][ia] ^ fb["desc"][ib]).numpy()
    bits = np.unpackbits(xor.view(np.uint8), axis=1).sum(1)
    same_bin = (bits > 0) & ~other_bin
    d = fa["angle"][ia] - fb["angle"][ib]
    dang = torch.atan2(torch.sin(d), torch.cos(d)).abs()
    return dict(keypoints=len(set(ka) ^ set(kb)),
                their_levels=sorted(k[2] for k in set(ka) ^ set(kb)),
                shared=len(both),
                other_bin=int(other_bin.sum()), same_bin=int(same_bin.sum()),
                same_bin_bits=sorted(int(x) for x in bits[same_bin]),
                max_angle_diff=float(dang.max()) if len(both) else 0.0)


def sensor_run(name, make, feed, n, centres, g, dev, snaps, snap_at):
    """One System over n frames: launches counted over the run alone and
    checked, each frame's path and host clock, keyframe events, the metric
    ATE (and for stereo the scale) against its gates. Tracker snapshots
    are taken before the frames of snap_at."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.utils import evaluate_ate
    slam = make()
    tk, lm = slam.tracker, slam.local_mapper
    process, n_fuse, n_events = lm.process_keyframe, [0], [0]

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event["fuse_searches"]
        n_events[0] += 1

    lm.process_keyframe = counted
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ts = 0.05 * np.arange(n)
    poses, times, how = [], [], {}
    native.reset_launches()                 # this path's run starts here
    for i in range(n):
        if i in snap_at:
            snaps[i] = snapshot(tk)
        steps0, ref0, ev0 = tk.n_steps, tk.n_ref_kf_searches, n_events[0]
        sync()
        t0 = time.perf_counter()
        T = feed(slam, i)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        poses.append(T)
        how[i] = ("none" if T is None else "init" if tk.n_steps == steps0
                  and tk.n_ref_kf_searches == ref0 else "steady"
                  if tk.n_ref_kf_searches == ref0 else "ref_kf")
        if n_events[0] > ev0:
            how[i] += "+kf"
    launches = dict(native.launches)        # ... and ends here
    lm.process_keyframe = process
    per_frame = 1 if name == "rgbd" else 2
    expect = dict(dense_frontend=per_frame * n, cell_topk=per_frame * n,
                  gather_patches=(per_frame + SAD_GATHERS[name]) * n,
                  hamming_best2=2 * tk.n_ref_kf_searches,
                  hamming_best2_windowed=2 * tk.n_steps
                  + tk.n_local_map_searches + n_fuse[0])
    log(f"{name}: frames by path {how}")
    log(f"{name}: launches {launches} (expected {expect}: {per_frame} "
        f"extraction(s) and {SAD_GATHERS[name]} one-image gathers a frame, "
        f"{tk.n_steps} fused steps, {tk.n_ref_kf_searches} reference-"
        f"keyframe and {tk.n_local_map_searches} local-map stages, "
        f"{n_events[0]} keyframe events with {n_fuse[0]} fuse searches)")
    if dev.type == "cuda":
        for k, want in expect.items():
            if launches[k] != want or (want == 0 and k != "hamming_best2"):
                raise AssertionError(f"{name}: {k}: {launches[k]} launches, "
                                     f"expected {want}")
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    rmse, n_ate, _ = evaluate_ate.ate_rmse(ts, centres, est_ts, est,
                                           with_scale=False)
    scale = evaluate_ate.ate_rmse(ts, centres, est_ts, est,
                                  with_scale=True)[2]
    tracked = sum(p is not None for p in poses)
    steady = [times[i] for i in range(1, n) if how[i] == "steady"]
    kf = [times[i] for i in range(1, n) if how[i].endswith("+kf")]
    rec = dict(tracked=tracked, n_frames=n, keyframes=slam.n_keyframes,
               points=slam.n_map_points, ate_m=rmse, ate_poses=n_ate,
               scale=scale, consistency=slam.check_map_consistency(),
               n_events=n_events[0], launches=launches, how=how,
               frame_ms_median=float(np.median(steady)),
               frame_ms_p90=float(np.percentile(steady, 90)),
               kf_frame_ms_median=float(np.median(kf)) if kf else None,
               kf_frame_ms_p90=float(np.percentile(kf, 90)) if kf else None,
               n_steady=len(steady), n_kf_frames=len(kf),
               track_cfg=tk.cfg)
    log(f"{name}: {tracked}/{n} frames tracked, {slam.n_keyframes} "
        f"keyframes, {slam.n_map_points} points, consistency "
        f"{rec['consistency']}; metric ATE {rmse:.5f} m over {n_ate} poses, "
        f"scale {scale:.4f}; host clock of {len(steady)} steady frames "
        f"median {rec['frame_ms_median']:.2f} ms, p90 "
        f"{rec['frame_ms_p90']:.2f} ms; of {len(kf)} keyframe frames median "
        f"{rec['kf_frame_ms_median']} ms, p90 {rec['kf_frame_ms_p90']} ms")
    fails = [k for k, bad in (
        ("frames tracked", tracked <= g["tracked"] * n),
        ("ATE", not (n_ate > g["ate_poses"] * n and rmse < g["ate_m"])),
        ("scale", "scale" in g and not abs(scale - 1.0) < g["scale"]),
        ("map consistency", rec["consistency"] != [])) if bad]
    if fails:
        raise AssertionError(f"{name} missed its gates: {fails}")
    return rec


def fuse_matches(lm, run):
    """run() (one process_keyframe of LocalMapper lm) with its fuse searches
    watched from outside: the mapper's projection searches and the map's
    fuse_observations are wrapped for the call. Both run only in the fuse
    passes, search j feeding the j-th fuse_observations (search 0 the
    forward pass, j > 0 the reverse pass into the j-th neighbour). Returns
    for each search (search, keyframe, points, features, projected uv,
    predicted levels, Hamming distances) of its matches, as numpy arrays."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import local_mapping
    matching, m = local_mapping.matching, lm.map
    search, fuse = matching.search_by_projection, m.fuse_observations
    searches, fused = [], []

    def capture_search(uv, visible, desc, level, *a, **kw):
        res = search(uv, visible, desc, level, *a, **kw)
        searches.append((uv, level, res))
        return res

    def capture_fuse(kf, pids, feats):
        fused.append((int(kf), np.asarray(pids), np.asarray(feats)))
        return fuse(kf, pids, feats)

    matching.search_by_projection = capture_search
    m.fuse_observations = capture_fuse
    try:
        run()
    finally:
        matching.search_by_projection = search
        del m.fuse_observations
    if len(searches) != len(fused) or not searches:
        raise AssertionError(f"{len(searches)} fuse searches and {len(fused)} "
                             f"fuse_observations calls in one event")
    out = []
    for s, ((uv, level, res), (kf, pids, feats)) in enumerate(
            zip(searches, fused)):
        sel = np.where(res.valid.cpu().numpy())[0]
        if len(sel) != len(pids):
            raise AssertionError(f"fuse search {s}: {len(sel)} matches, "
                                 f"{len(pids)} fused")
        out.append((s, kf, pids, feats, uv.cpu().numpy()[sel],
                    level.cpu().numpy()[sel], res.dist.cpu().numpy()[sel]))
    return out


def fuse_diff(card, cpu):
    """The fuse matches of one keyframe event that differ between the card
    and the CPU: each (search, keyframe, point) matched on one side only or
    to another feature, with both sides' feature, projection and Hamming
    distance. Search 0 is the forward pass, j > 0 the reverse pass into
    the j-th neighbour (``fuse_matches``)."""
    def by(searches):
        return {(s, kf, int(p)): (int(f), float(u), float(v), int(lv), int(d))
                for s, kf, pids, feats, uv, lvs, ds in searches
                for p, f, (u, v), lv, d in zip(pids, feats, uv, lvs, ds)}
    a, b = by(card), by(cpu)
    diff = [dict(search=key[0], kf=key[1], point=key[2],
                 card=a.get(key), cpu=b.get(key))
            for key in sorted(set(a) | set(b)) if a.get(key) is None
            or b.get(key) is None or a[key][0] != b[key][0]
            or a[key][4] != b[key][4]]
    both = [key for key in set(a) & set(b) if a[key][0] == b[key][0]]
    duv = max((max(abs(a[key][1] - b[key][1]), abs(a[key][2] - b[key][2]))
               for key in both), default=0.0)
    log(f"  fuse matches of the event: card {len(a)}, CPU {len(b)}, "
        f"{len(diff)} differ; largest projection difference among the "
        f"{len(both)} equal matches {duv:.2e} px")
    for d in diff[:20]:
        log(f"    search {d['search']} into keyframe {d['kf']}, point "
            f"{d['point']}: card (feature, u, v, level, distance) "
            f"{d['card']}, CPU {d['cpu']}")
    return dict(n_card=len(a), n_cpu=len(b), n_diff=len(diff),
                diff=diff[:20], max_uv_diff=duv)


def profile_event(mapper, dev, k):
    """One keyframe event (process_keyframe from a snapshot of the map):
    device time, kernels and the hand-written kernels' share from
    torch.profiler; host clock unprofiled (median of 3); host syncs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def run(lm):
        lm.process_keyframe(k)
        torch.cuda.synchronize()

    host = []
    for _ in range(3):
        lm = mapper(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(lm)
        host.append((time.perf_counter() - t0) * 1e3)
    lm = mapper(dev)
    sites = sync_sites(lambda: run(lm))
    avg = profiled(run, [ProfilerActivity.CUDA], setup=lambda: mapper(dev))
    if avg is None:
        raise AssertionError("the profiler saw no kernel of a keyframe event")
    evs = [e for e in avg if e.device_type == DeviceType.CUDA]
    out = dict(host_ms=float(np.median(host)), host_ms_runs=host,
               device_ms=sum(e.self_device_time_total for e in evs) / 1e3,
               kernels=sum(e.count for e in evs),
               syncs=sum(sites.values()), sync_sites=dict(sites),
               own_kernels={name: dict(
                   ms=sum(e.self_device_time_total for e in evs
                          if symbol in e.key) / 1e3,
                   launches=sum(e.count for e in evs if symbol in e.key))
                   for name, symbol in KERNEL_SYMBOLS.items()})
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_keyframe_event.txt").write_text(avg.table(
        sort_by="self_device_time_total", row_limit=60,
        max_name_column_width=80))
    log(f"keyframe event of keyframe {k}, profiled: device "
        f"{out['device_ms']:.2f} ms in {out['kernels']} kernels, host clock "
        f"{out['host_ms']:.1f} ms (runs {[round(x, 1) for x in host]}), "
        f"{out['syncs']} host syncs ({dict(sites.most_common(6))}); "
        f"hamming_best2_windowed {out['own_kernels']['hamming_best2_windowed']}"
        f"; table in chiprun_out/profile_keyframe_event.txt")
    return out


def fuse_search_check(mapper, dev, k, hamming):
    """Every projection search of one keyframe event's fuse passes, at its
    own shape (the forward pass's padded candidates, the reverse passes'
    per-feature points against a neighbour's features), against the plain
    version on the same inputs."""
    import torch
    calls = []
    kernel = hamming.hamming_best2_windowed

    def capture(*a):
        calls.append(a)
        return kernel(*a)

    hamming.hamming_best2_windowed = capture
    try:
        mapper(dev).process_keyframe(k)
    finally:
        hamming.hamming_best2_windowed = kernel
    if len(calls) < 2:
        raise AssertionError(f"the event made {len(calls)} fuse searches")
    shapes = []
    for a in calls:
        got = kernel(*a)
        ref = hamming.hamming_best2_windowed_plain(*a)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError("a fuse search differs from the plain "
                                 "version")
        shapes.append((int(a[0].shape[0]), int(a[7].shape[0]),
                       int(a[6].sum()), int((got[0] < hamming.BIG).sum())))
    log(f"fuse searches of the event against the plain version: all "
        f"{len(calls)} equal, at (queries, targets, valid queries, rows with "
        f"a candidate) = {shapes[0]} (forward) and {shapes[-1]} (last "
        f"reverse)")
    return dict(n_searches=len(calls), shapes=shapes, max_abs_err=0)


def frontends_agree(fused, xla):
    """The "xla" front end, which no path runs any more, against the fused
    one on the same image: the same keypoints (both select from an equal
    score map), angles within 1e-3 rad, >= 97 % of descriptors equal."""
    import torch
    if not torch.equal(fused.valid, xla.valid):
        raise AssertionError("the front ends keep different features")
    v = xla.valid
    if not (torch.equal(fused.xy[v], xla.xy[v])
            and torch.equal(fused.level[v], xla.level[v])):
        raise AssertionError("the front ends select different keypoints")
    d = fused.angle[v] - xla.angle[v]
    dang = float(torch.atan2(torch.sin(d), torch.cos(d)).abs().max())
    same = float((fused.desc[v] == xla.desc[v]).all(1).float().mean())
    log(f"  front end 'xla' against 'fused' on one frame: {int(v.sum())} "
        f"keypoints equal, angles within {dang:.2e} rad, {same:.4f} of the "
        f"descriptors equal")
    if not dang < 1e-3 or same < 0.97:
        raise AssertionError("the front ends' features disagree")


def profile_call(fn, table=None):
    """Device time, kernel count and host-clock time of one call alone; the
    profiler's table by operator goes to chiprun_out/<table> if named."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()

    def run(_):
        fn()
        torch.cuda.synchronize()

    avg = profiled(run, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if avg is None:
        raise AssertionError("the profiler saw no kernel of a profiled call")
    k1 = sum(e.count for e in avg if e.device_type == DeviceType.CUDA)
    if table:
        out_dir = REPO / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / table).write_text(avg.table(
            sort_by="self_cpu_time_total", row_limit=60))
    return dict(device_ms=device_ms(fn, reps=5, what=table or "a call"),
                kernels=k1, host_ms=host_ms(fn))


def count_syncs(tk, imgs, frames):
    """Synchronizing CUDA calls per frame (sync_sites) over frames."""
    sites = sync_sites(lambda: [tk.track_monocular(imgs[i], 0.05 * i)
                                for i in frames])
    n = sum(sites.values()) / len(frames)
    log(f"host syncs per frame: {n:.2f} (sync debug mode, frames {frames}); "
        f"by site: {dict(sites.most_common())}")
    return n


def sync_sites(fn):
    """Synchronizing CUDA calls of fn(), as PyTorch's sync debug mode
    reports them, each placed at the innermost line of the port on the
    Python stack: a Counter by site."""
    import collections
    import traceback
    import torch
    sites = collections.Counter()

    def record(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        frames_in_port = [f for f in traceback.extract_stack()
                          if f"{PKG}/" in f.filename]
        f = frames_in_port[-1] if frames_in_port else None
        sites[f"{f.filename.split(PKG + '/')[-1]}:{f.lineno}" if f
              else "outside the port"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def host_ms(fn, reps=5):
    """Median host-clock milliseconds of fn() ending in a synchronize."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# the port's kernels as the profiler names them
KERNEL_SYMBOLS = {"cell_topk": "cell_topk_levels_kernel",
                  "gather_patches": "gather_patches_levels_kernel",
                  "hamming_best2_windowed": "best2_kernel<true>",
                  "hamming_best2": "best2_kernel<false>",
                  "dense_frontend": "dense_frontend_kernel"}


def profile_frames(make_tk, imgs, frames, table="profile_frames.txt",
                   alone=True, track=None):
    """torch.profiler over frames tracked by make_tk()'s tracker (a fresh
    one for each session, should a session lose its records): device time
    (sum of kernel
    durations) and kernels per frame, and under "own_kernels" the device
    time and launches per frame of each hand-written kernel; the table by
    kernel goes to chiprun_out/<table>. Only the device's activity is
    recorded: recording the host's operators as well slows a frame of ~24k
    kernels many times over. With alone, the first pose_optimization call
    of the window is captured and re-run alone for its device time (kernels
    and ms) and host time (prepare_frame alone is read in phase 5). track
    (tk, i) feeds frame i (default: imgs[i] to track_monocular)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels

    stages = {"pose_optimization": kernels.pose_opt}
    saved = {name: getattr(mod, name) for name, mod in stages.items()}
    calls = {}

    def capture(name):
        def run(*a, **kw):
            calls.setdefault(name, (a, kw))
            return saved[name](*a, **kw)
        return run

    track = track or (lambda tk, i: tk.track_monocular(imgs[i], 0.05 * i))

    def run(tk):
        for i in frames:
            track(tk, i)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for name, mod in stages.items():
            setattr(mod, name, capture(name))
        avg = profiled(run, [ProfilerActivity.CUDA], setup=make_tk)
    finally:
        for name, mod in stages.items():
            setattr(mod, name, saved[name])
    if avg is None:
        raise AssertionError(f"the profiler saw no kernel of frames {frames}")
    n = len(frames)
    dev = [e for e in avg if e.device_type == DeviceType.CUDA]
    out = dict(device_ms=sum(e.self_device_time_total for e in dev) / 1e3 / n,
               kernels=sum(e.count for e in dev) / n)
    out["own_kernels"] = {
        name: dict(ms=sum(e.self_device_time_total for e in dev
                          if symbol in e.key) / 1e3 / n,
                   launches=sum(e.count for e in dev if symbol in e.key) / n)
        for name, symbol in KERNEL_SYMBOLS.items()}
    text = avg.table(sort_by="self_device_time_total", row_limit=100,
                     max_name_column_width=80)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / table).write_text(text)
    log(f"profile of frames {frames}, per frame: device time "
        f"{out['device_ms']:.2f} ms in {out['kernels']:.0f} kernels; table "
        f"in chiprun_out/{table} (profiling took "
        f"{time.perf_counter() - t0:.1f} s)")
    log("\n".join(text.splitlines()[:12]))
    log("  hand-written kernels on these frames, device ms per frame "
        "(launches per frame): " + ", ".join(
            f"{name} {k['ms']:.4f} ({k['launches']:.1f})"
            for name, k in out["own_kernels"].items()))
    for name, (a, kw) in calls.items() if alone else ():
        out[name] = profile_call(lambda: saved[name](*a, **kw))
        log(f"  {name}, one call alone: device {out[name]['device_ms']:.2f} "
            f"ms in {out[name]['kernels']} kernels, host clock "
            f"{out[name]['host_ms']:.2f} ms")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ must sit beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    # exact-integer matmuls (pyramid resize of integer images) need full
    # float32: keep TF32 off for matmuls and cuDNN alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    with open(REPO / "chiprun_out" / "chip_smoke_log.txt", "w") as copy:
        LOG_COPY.append(copy)
        try:
            return run(torch.device("cuda"))
        finally:
            LOG_COPY.remove(copy)


def run(dev) -> int:
    """Phases 1-7 on the card dev; raises on the first failure."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"phase 1 card: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    from orb_slam3_detailed_comments_tpu_torch import native
    t0 = time.perf_counter()
    native.build(force=True)
    native.lib()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc, one process per source)")
    for line in native.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    t_phase = [time.perf_counter()]

    def phase_done(name):
        t_phase.append(time.perf_counter())
        log(f"{name} took {t_phase[-1] - t_phase[-2]:.1f} s")

    log("phase 3 kernels against their plain versions")
    rates = int_rates()
    log(f"  bounds: HBM {HBM_BYTES_PER_S:.3e} B/s, float32 "
        f"{CUDA_CORE_OPS_PER_S:.3e} op/s; {rates['sms']} SMs at "
        f"{rates['sm_clock_hz'] / 1e6:.0f} MHz: int32 "
        f"{rates['int32_ops_per_s']:.3e} op/s ({INT32_PER_SM_CLK}/SM/clock), "
        f"__popc {rates['popc_per_s']:.3e} op/s ({POPC_PER_SM_CLK}/SM/clock)")
    rec = kernel_phase(dev, rates)
    phase_done("phase 3")

    log("phase 4 main path: steady tracking on a seeded map")
    res = main_path(dev)
    phase_done("phase 4")
    log("phase 5 bootstrap path: from the first image")
    boot = bootstrap_path(dev)
    phase_done("phase 5")
    log("phase 6 System: monocular, loop closing off, its own map")
    sys_rec = system_path(dev)
    phase_done("phase 6")
    log("phase 7 System: stereo, RGB-D and fisheye stereo, loop closing off")
    st = stereo_path(dev)
    phase_done("phase 7")
    paths = (("steady", res), ("bootstrap", boot), ("system", sys_rec),
             ("stereo", st["stereo"]), ("rgbd", st["rgbd"]),
             ("fisheye", st["fisheye"]))
    for r in rec:
        r["launches"] = sum(run["launches"][r["name"]] for _, run in paths)
        r["launches_by_path"] = {path: run["launches"][r["name"]]
                                 for path, run in paths}
        # device time per frame on rendered frames, beside "ms" (random
        # inputs of the same shapes): the searches' work depends on how
        # many pairs pass their gates
        r["real_frame_ms"] = {
            path: run["profile"]["own_kernels"][r["name"]]
            for path, run in paths if "profile" in run}
        r["real_frame_ms"]["ref_kf_frame"] = boot["profile"]["ref_kf_frame"][
            "own_kernels"][r["name"]]
        r["real_frame_ms"]["keyframe_event"] = sys_rec["event_profile"][
            "own_kernels"][r["name"]]
        log(f"kernel {r['name']}: {r['ms']:.4f} ms on random inputs per "
            f"{r['unit']}; on rendered frames, per frame: "
            + ", ".join(f"{path} {k['ms']:.4f} ms in {k['launches']:.1f} "
                        f"launches" for path, k in r["real_frame_ms"].items()))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "event_ms", "plain_event_ms", "atlas", "stereo", "unit",
            "launches_by_path", "real_frame_ms")
    summary = dict(frame_ms_median=res["frame_ms_median"],
                   frame_ms_p90=res["frame_ms_p90"],
                   host_syncs_per_frame=res["syncs"], **res["profile"])
    boot_summary = {k: v for k, v in boot.items() if k != "launches"}
    sys_summary = {k: v for k, v in sys_rec.items() if k != "launches"}
    st_summary = {name: {k: v for k, v in run.items()
                         if k not in ("launches", "how")}
                  for name, run in st.items()}
    log(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                for r in rec],
                    "frame": summary, "bootstrap": boot_summary,
                    "system": sys_summary, "stereo": st_summary,
                    "launches_by_path": {path: run["launches"]
                                         for path, run in paths},
                    "bound_rates": rates,
                    "event_time_in_place_of_device_time": EVENT_FALLBACKS}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
