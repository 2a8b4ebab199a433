#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # the whole check, ~16 minutes
    python3 chip_smoke.py --phases 15b    # one long opt-in case, 5-15 min

Phases, each of which raises on failure:
  1. card:   a CUDA card must be present; prints its name and power limit;
  2. build:  compiles the port's CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version at the shapes of
     the 752x480 / 1024-feature main path, with ties, gated rows and -inf
     padding (exact equality; dense_frontend's moment maps within an
     absolute tolerance); the best-2 searches also at shapes from 1 x 1 to
     64 x 5000 with ties planted across and within the kernel's lanes;
     dense_frontend both level by level and as the frame's one call for all
     levels, and over 17 levels in two launches; cell_topk and
     gather_patches as the frame's one call over the 8 levels (all-zero,
     tied, negative and -inf cells, content edges, corners outside the
     image), over tables of 1 and 16 levels and of 17 in two launches,
     the three extraction kernels also at a batch's 16 and 64 levels (2
     and 8 frames, as extractor.extract_batch calls them); cell_topk also at
     cells 16, 48, 64, 80 and 24 (the last on its plain version, the shape
     rule), and in their one-level cases (the [C, 1024], [C, 384] and
     [C, 2304] matrices; the "xla"
     front end's atlas; the stereo matcher's 12x12 and 12x22 windows of one
     image, at corners clipped as ops/stereo.py clips them), and
     hamming_best2_windowed also at place recognition's shapes (the loop
     fuse's and the Sim3 re-verification's 2048 queries, the
     relocalisation rescue's 4096). Timed as
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
  6. System path: System(cam, MONOCULAR) at its defaults (loop closing
     on, the bundled vocabulary) on the card, fed test_pipeline_mono's
     60-frame orbit (world seed 7, ray-cast frames): builds and keeps its
     own map (keyframe insertion, the LocalMapper's triangulation, fusion,
     local BA and culling, place recognition on every keyframe), gated by
     test_mono_end_to_end's gates; every kernel's launches checked against
     the frames' paths, the keyframe events' fuse searches and place
     recognition's searches; each event
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
     System(cam, RGBD, ...) on the first 30 frames of world seed 9's
     40-frame orbit, and the two-camera KB8 rig System(kb8, STEREO,
     camera2=kb8, T_c1c2=...) on the first 20 of world seed 17's (the
     cases of test_pipeline_stereo_rgbd.py and
     test_fisheye_stereo_end_to_end), each held to its JAX test's gates;
     frame 0's stereo depth against the rendered depth; the launches of
     every kernel checked against the frames (two extractions a stereo
     frame, 2 or 12 one-image gathers) and the keyframe events;
     prepare_frame_stereo and prepare_frame_stereo_fisheye on the card
     against the CPU; one steady stereo frame profiled
     (chiprun_out/profile_frame_stereo.txt) and prepare_frame_stereo alone
     (chiprun_out/profile_prepare_stereo.txt);
  8. place recognition, at the cases of the JAX package's tests, frames
     ray-cast on the card, every kernel's launches checked against the
     frames and the searches: (a) the first 40 frames of the 140-frame loop
     around box world 11 (phase 10b runs them in async mode;
     test_loop_detected_and_trajectory_consistent's gates; each closure's
     keyframe count and global BA tier; the host clock of detection and
     correction; the first verified detection replayed on the CPU: the
     same candidates, the Sim3 within 1e-3); (b) relocalisation after a 6-
     frame blackout (test_relocalization_after_blackout's gates, the host
     clock of one relocalisation); (c) two sequences of world 7 in two
     maps, merged (test_multimap_spawn_and_merge's gates);
  9. visual-inertial: the three routes to the inertial optimisers'
     Jacobians timed (torch.func.jacfwd, forward mode with batched
     tangents, written out); (a) System(cam, IMU_MONOCULAR) at its defaults
     on world seed 11's 60 frames of inertial_trajectory
     (test_mono_inertial_end_to_end's and test_gravity_alignment's gates),
     (b) System(cam, IMU_STEREO, baseline=0.11) on the first 35 of world
     seed 13's 45
     (test_stereo_inertial_end_to_end's gates), (c) System(cam, IMU_RGBD)
     on 12 frames of 9b's sequence with exact depth maps (tracked, windows
     preintegrated on the card); each kernel's launches checked; one track_step_inertial_lf and the first IMU initialisation
     replayed on the CPU and compared; the host clock of each IMU
     initialisation stage (with its full inertial BA) and local inertial
     BA; one steady inertial frame of 9b profiled on a copy of the
     tracker (chiprun_out/profile_frames_imu_stereo.txt);
 10. the async mapping worker and the racing global BA (every exception a
     background thread raises fails the phase): (a) the first 40 frames of
     phase 6's case with System(cam, MONOCULAR, async_mapping=True), every
     thread on the default stream, held to test_mono_end_to_end's gates
     with exact launch counts; the host clock of steady and keyframe
     frames beside phase 6's over the same frames, the backpressure waits, the
     device busy share of one profiled steady frame; (b) the first 40
     frames of phase 8a's loop in async mode
     (test_async_loop_closure_with_racing_gba's gates; each global BA's
     time on its thread and camera count; the frames that made a
     closing keyframe and those tracked while a correction ran; the
     worker's first fuse search and Sim3 match search, on its stream,
     against their plain versions); (c) the racing inertial global BA on a
     copy of 9a's final map, card against CPU, and its abort; (d)
     System.from_settings for the 8 files of examples/config/, an atlas
     checkpoint of a 30-frame run loaded into a fresh System and
     localised against (test_localize_against_loaded_atlas's gates), and
     warmup() with the host clock of the first frames after it.
  11. metric and inertial maps, frames ray-cast on the card at fx = fy =
     400: (a) System(cam, RGBD, baseline=0.11) on world seed 7's 50-frame
     orbit with exact depth maps, change_dataset(), its last 30 frames
     again, welded back at fixed scale (test_rgbd_multimap_spawn_and_merge's
     gates, the weld's scale exactly 1); (b) System(cam, IMU_STEREO,
     baseline=0.11, enable_loop_closing=True) around the stress box
     (stress_world(default_rng(29), half=4.0), degraded images) on 160
     frames of inertial_loop_trajectory's 19.2 s loop: VIBA1, VIBA2, the
     gravity gate, the 4DoF essential graph and the full inertial BA of
     each correction (test_fisheye_stereo_inertial_loop_closure's gates on
     a rectified pinhole pair; at this depth every correction comes before
     VIBA2, so the yaw-only branch is counted, not required); exact launch
     counts; each correction's verdict, frames and host clock by part; the
     first correction on the inertial map (and the first applied there)
     replayed on the CPU from the map the card saw: the same verdict,
     poses and velocities within 1e-3 after the graph and after the
     inertial BA; (c) one visual global BA in ba_solve's COO tier on 11b's
     final map, card against CPU (its normal equations, cost and inlier
     verdicts).
 12. the host surfaces: tests/test_examples_cli.py's world (seed 4) at
     752x480, the first 16 frames of a 24-frame orbit, ray-cast on the card and written with the
     port's PNG writer as a EuRoC mav0 sequence, a TUM RGB-D directory with
     16-bit depth and a EuRoC stereo directory with LEFT.* / RIGHT.*
     blocks; every file read back bit for bit; mono_euroc (the sequence
     twice), rgbd_tum and stereo_euroc run through their main(argv) on the
     card with their JAX CLI tests' gates and launch counts; the host's
     PNG decode time a frame and rectify time a pair; then item 1.9 in
     turns on 11b's final map: update_point_stats over every point,
     covisibility_batch over the live keyframes and covisibility_matrix,
     the host library against its numpy twins (and the old incidence
     product), 3 turns each, results equal.
 13. the multi-device layer: (a) phase 6's world (seed 7) at 752x480 with
     OrbConfig(), 16 frames prepared in blocks of 2 and of 8
     (kernels.prepare_frames: one batched extraction a block), every frame
     equal to its own prepare_frame call on the card in every field, each
     extraction kernel launched ceil(8B / 16) times a block; host ms and
     device ms a frame and kernels a frame, per frame against each block
     size, in turns; (b) System.track_monocular_batch on phase 6's first 20
     frames (blocks of 8) against track_monocular on the same frames (loop
     closing off, test_batch_ingest_matches_online_tracking's gates: the
     same None pattern, poses within 1e-5; exact launch counts); (c) two
     processes on the card over gloo (this process starts no group): the
     sharded Schur step, the sharded PCG at C = 192 and the sharded
     inertial BA (on 9a's final map, or a synthetic chain when phase 9
     does not run) each
     against its world-1 solve at the JAX tests' tolerances, their clocks,
     and the racing global BA with dist_gba, rank 1 serving: one run
     applied, the abort bit-exact.
 14. the repo's tools (tools/): (a) tests/test_placerec.py::
     test_vocab_domain_shift_gate's case in full through
     tools.eval_vocab: the three shifted texture domains, 10 worlds x 8
     frames each from seed 50,000, ray-cast on the card and extracted in
     blocks of 8, the bundled vocabulary's retrieval gated at top1 >= 0.88
     and margin >= 3.0; each extraction kernel launched ceil(8B / 16)
     times a block; the first 2 frames of each domain's features and word
     ids equal to the CPU's (the angle within 1e-4 rad); each domain's
     host seconds by stage; (b) tools.train_vocab end to end at L = 3 on
     12 worlds x 10 frames: the saved file loads back equal, the bundled
     default_vocab.npz hashes the same before and after, its blob-domain
     top1 and margin reported; (c) tools.profile_stages on 16 frames: the
     fps line and the stage table.
 15. the JAX package's long acceptance runs, each case built by
     long_case as its test builds it (seed, world, trajectory, IMU
     windows, degradations, camera, System settings; pinhole frames from
     synth_render.render_frame, the JAX helpers' homography renderer bit
     for bit; KB8 frames ray-cast on the card at pixel centres), driven
     through the System at the test's full depth and held to its gates
     with exact launch counts; each correction's branch (Sim3 / SE3, 4DoF,
     yaw-only after VIBA2, refused by the gravity gate), each global BA's
     tier and C, the racing global BA's runs and aborts, the correction's
     host clock by part, the steady frames' median and p90, the seconds.
     (a) in the whole run: the TUM-VI flagship, a non-rectified KB8 pair
     plus IMU over 45 frames (test_fisheye_stereo_inertial_end_to_end),
     with the IMU initialisation's frame, the gyro bias error, the metric
     ATE and scale, and card against CPU on one frame (the same keypoints
     from prepare_frame_stereo_fisheye, track_step_inertial_lf's match_pt
     on >= 99 % and pose within 1e-3); opt-in, one call each: (b) the
     520-frame stress loop (test_long_adversarial_loop), (c) the same
     async (test_long_adversarial_loop_async), (d) the 520-frame
     IMU_MONOCULAR gauntlet (test_long_adversarial_inertial_loop), (e) the
     400-frame stereo gauntlet (test_stereo_gauntlet_fixed_scale_loop),
     (f) the 320-frame KB8 stereo-inertial loop through VIBA2
     (test_fisheye_stereo_inertial_loop_closure).
  ``--phases 3,9,10,11,12,13,14,15a,...,15f`` runs phases 1, 2 and the
  named ones only (10 with 9a first, whose map 10c takes; 12 alone takes
  its turns on its own monocular map; 13 alone takes the synthetic chain);
  ``--phases 15b`` ... ``--phases 15f`` run the long opt-in cases, one a
  call.

Output (copied to chiprun_out/chip_smoke_log.txt): per-phase lines, then
on lines of their own the kernels' JSON
record (with the System phase's record under "system", phase 7's under
"stereo", phase 8's under "phase8", phase 9's under "phase9", phase 10's
under "phase10", phase 11's under "phase11", phase 12's under "phase12",
phase 13's under "phase13", phase 14's under "phase14", phase 15's
under "phase15"), the card's
name
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
import threading
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
N_TRACK = 34         # tracked frames, 1 .. N_TRACK, all inside the seeded span
CPU_FRAMES = (20, 21)
# sync count (3 frames) and profile (5) from here on: steady frames, past
# the tracker's keyframes at frames 1, 20 and 25
PROBE_FROM = 26
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
    from orb_slam3_detailed_comments_tpu_torch import native
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
    # 17 images: one launch a table of 16, each window from its own table
    lv17 = torch.where(torch.arange(level.shape[0], device=dev) % 3 == 0,
                       torch.full_like(level, 16), level)
    n0 = native.launches["gather_patches"]
    err = max(err, same("gather_patches (17 images)",
                        [gat(blurs * 2 + blurs[:1], lv17, rc)],
                        [gat_plain(blurs * 2 + blurs[:1], lv17, rc)]))
    if native.launches["gather_patches"] != n0 + 2:
        raise AssertionError("gather_patches (17 images): not 2 launches")
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
    def windowed_args(Q, rad, K=n_feat, lo=-1, hi=1, level0=False,
                      scaled=True):
        """Stage-like queries near the targets, gated to levels [lo, hi]
        about their own (level 0 for every query with level0, radius not
        scaled by level without scaled); returns (args, pairs that pass
        the gates)."""
        src = rng.integers(0, K, Q)
        q_uv = (t_xy[src] + rng.normal(0, 2.0, (Q, 2))).astype(np.float32)
        q_lv = (np.zeros(Q, np.int32) if level0 else np.clip(
            t_lv[src] + rng.integers(-1, 2, Q), 0, 7).astype(np.int32))
        da = db[src] ^ (rng.uniform(size=(Q, 8)) < 0.05).astype(np.uint32)
        qv = rng.uniform(size=Q) < 0.9
        q_r = ((rad * sf[q_lv]) if scaled else np.full(Q, rad)).astype(
            np.float32)
        q_r[1] = 0.0                                     # all-gated row
        args = (f(da.view(np.int32)), f(q_uv), f(q_lv), f(q_r),
                f(np.full(Q, lo, np.int32)), f(np.full(Q, hi, np.int32)),
                f(qv), f(db[:K].view(np.int32)), f(t_xy[:K]), f(t_lv[:K]),
                f(tv[:K]))
        du = np.abs(q_uv[:, None, 0] - t_xy[None, :K, 0])
        dv = np.abs(q_uv[:, None, 1] - t_xy[None, :K, 1])
        dl = t_lv[None, :K] - q_lv[:, None]
        return args, int(((du <= q_r[:, None]) & (dv <= q_r[:, None])
                          & (dl >= lo) & (dl <= hi) & tv[None, :K]
                          & qv[:, None]).sum())

    def windowed_bound(calls, n_pass):
        """The least time of a set of windowed calls (bytes: each call's
        queries and the targets once; 8 gate operations a pair; per pair
        that passes 8 XOR + 8 ADD + 2 compares and 8 __popc)."""
        n_pairs = sum(a[0].shape[0] * a[7].shape[0] for a in calls)
        nbytes = sum(a[0].shape[0] * (32 + 8 + 4 * 4 + 1 + 12)
                     + a[7].shape[0] * (32 + 8 + 4 + 1) for a in calls)
        return bound_ms(nbytes, n_int=8 * n_pairs + 18 * n_pass,
                        n_popc=8 * n_pass, rates=rates)

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
    # the place-recognition callers' shapes (one call each): the loop fuse
    # (2048 queries, radius 6, levels -2..2), the Sim3 re-verification's
    # guided match (2048 queries at level 0, radius 8, levels -8..8) and
    # the relocalisation rescue (local_pts_cap = 4096 queries, radius 10
    # by level, levels -1..1)
    callers = {}
    for name, Q, kw in (
            ("loop_fuse", 2048, dict(rad=6.0, lo=-2, hi=2, scaled=False)),
            ("projection_pairs", 2048, dict(rad=8.0, lo=-8, hi=8,
                                            level0=True, scaled=False)),
            ("reloc_rescue", 4096, dict(rad=10.0))):
        a, n = windowed_args(Q, **kw)
        e = same(f"hamming_best2_windowed ({name}, {Q}x{n_feat})",
                 hamming.hamming_best2_windowed(*a),
                 hamming.hamming_best2_windowed_plain(*a))
        rec[-1]["max_abs_err"] = max(rec[-1]["max_abs_err"], e)
        b, by = windowed_bound([a], n)
        callers[name] = timed(dict(
            name=f"hamming_best2_windowed, {name}", max_abs_err=e,
            bound_ms=b, bound_by=by, unit=f"one call, {Q}x{n_feat}"),
            lambda a=a: hamming.hamming_best2_windowed(*a),
            lambda a=a: hamming.hamming_best2_windowed_plain(*a),
            plain_reps=3)
    rec[-1]["callers"] = callers

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
        unit="one reference-keyframe frame, or one candidate of the "
             "relocalisation or the Sim3 verification: the 2 calls of "
             "match_nn(mutual=True), 1024x1024 each"),
        lambda: [hamming.hamming_best2(*args), hamming.hamming_best2(*back)],
        lambda: [hamming.hamming_best2_plain(*args),
                 hamming.hamming_best2_plain(*back)], plain_reps=5))
    rec[-1]["one_call_ms"] = device_ms(lambda: hamming.hamming_best2(*args),
                                       what="hamming_best2, one call")
    rec.append(frontend_kernel_check(dev))
    batched_kernel_check(dev, {r["name"]: r for r in rec})
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
        for name, q in r.get("callers", {}).items():
            log(f"  {r['name']} at the {name} shape: equal to plain; device "
                f"{q['ms']:.4f} ms (plain {q['plain_ms']:.4f}, bound "
                f"{q['bound_ms']:.5f} by {q['bound_by']}) per {q['unit']}")
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
    # 17 levels: two launches, each level's maps as one table gives them
    from orb_slam3_detailed_comments_tpu_torch import native
    n0 = native.launches["dense_frontend"]
    lv17 = levels * 2 + levels[:1]
    out17 = frontend.dense_frontend_levels(lv17)
    if native.launches["dense_frontend"] != n0 + 2 or len(out17) != 17:
        raise AssertionError("dense_frontend_levels (17 levels): not 2 "
                             "launches")
    cases = ([(f"level {k} of the frame's one call", l, g)
              for k, (l, g) in enumerate(zip(levels, together))]
             + [(f"level {k} of the 17-level call", l, g)
                for k, (l, g) in enumerate(zip(lv17, out17))]
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
        f"one call, on 17 in two, the same {len(levels)} alone and "
        f"{len(extra)} extra "
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


BATCH_LEVELS = (16, 64)    # 8B levels of B = 2 and 8 frames (phase 13a)


def batched_kernel_check(dev, recs):
    """The three extraction kernels at the shapes of a batch of B = 2 and 8
    frames at 752x480 (``extractor.extract_batch``: 8B levels, one
    dense_frontend_levels and one cell_topk_levels call launching once
    for every 16 levels, gather_patches_levels once for every table of
    2 frames' 16 blur maps), each against its plain version on the same
    inputs with phase 3's gates (score, blur, top-k and windows equal;
    moments within MOMENT_TOL); the launches counted; timed beside B calls
    of the one-frame shapes. Adds a "batched" entry to each record."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import (
        brief, extractor, frontend, layout, patches, pyramid, topk)
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    rng = np.random.default_rng(13)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    orb = extractor.OrbConfig()
    H, W = CAM_KW["height"], CAM_KW["width"]
    shapes = pyramid.level_shapes(H, W, orb.n_levels, orb.scale)
    contents = layout.content_dims(orb, H, W)
    budgets = layout.level_budgets(orb)
    k, margin, pw = orb.k_per_cell, orb.margin, brief.PATCH_W
    cam = cameras.pinhole(**CAM_KW)
    planes = sr.default_world(np.random.default_rng(7))
    R, t = sr.orbit_trajectory(60)

    def launched(name, fn, want, what):
        n0 = native.launches[name]
        out = fn()
        torch.cuda.synchronize()
        if native.launches[name] - n0 != want:
            raise AssertionError(f"{what}: {native.launches[name] - n0} "
                                 f"launches, expected {want}")
        return out

    for n_lv in BATCH_LEVELS:
        B = n_lv // orb.n_levels
        want = -(-n_lv // frontend.MAX_LEVELS)
        what = f"{n_lv} levels ({B} frames)"
        # dense_frontend over the pyramids of B ray-cast frames
        imgs = torch.stack([torch.round(sr.render_image(
            cam, planes, R[i], t[i], dev)) for i in range(B)])
        pyr = pyramid.build_pyramid(imgs, orb.n_levels, orb.scale)
        levels = [lv[b] for b in range(B) for lv in pyr]
        got = launched("dense_frontend",
                       lambda: frontend.dense_frontend_levels(levels), want,
                       f"dense_frontend_levels, {what}")
        worst = 0.0
        for lv, g in zip(levels, got):
            ref = frontend.dense_frontend_plain(lv)
            for name, x, y in zip(("score", "blur"), g[:2], ref[:2]):
                if not torch.equal(x, y):
                    raise AssertionError(f"dense_frontend {name} differs "
                                         f"from its plain version ({what})")
            worst = max(worst, *(float((x - y).abs().max())
                                 for x, y in zip(g[2:], ref[2:])))
        if not worst < MOMENT_TOL:
            raise AssertionError(f"dense_frontend moments {worst} from the "
                                 f"plain version ({what})")
        n_px = sum(int(l.numel()) for l in levels)
        b, by = bound_ms(n_px * 20, n_px * FRONTEND_OPS_PER_PIXEL)
        recs["dense_frontend"].setdefault("batched", {})[n_lv] = dict(
            library_ms=None, levels=n_lv, launches=want, max_abs_err=worst,
            ms=device_ms(lambda: frontend.dense_frontend_levels(levels),
                         what=f"dense_frontend, {what}"),
            per_frame_ms=device_ms(lambda: [frontend.dense_frontend_levels(
                levels[i:i + orb.n_levels])
                for i in range(0, n_lv, orb.n_levels)],
                what=f"dense_frontend, {what} one frame a call"),
            plain_ms=device_ms(lambda: [frontend.dense_frontend_plain(l)
                                        for l in levels], reps=3,
                               what=f"dense_frontend, {what}, plain"),
            bound_ms=b, bound_by=by)

        # cell_topk over B frames' score maps
        maps = [m for _ in range(B) for m in score_maps_case(rng, shapes, f)]
        cont = contents * B
        got = launched("cell_topk", lambda: topk.cell_topk_levels(
            maps, cont, margin, k), want, f"cell_topk_levels, {what}")
        ref = topk.cell_topk_levels_plain(maps, cont, margin, k)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"cell_topk differs from its plain version "
                                 f"({what})")
        n_in = B * sum(max(0, min(lh, ch - margin) - margin)
                       * max(0, min(lw, cw - margin) - margin)
                       for (lh, lw), (ch, cw) in zip(shapes, contents))
        b, by = bound_ms(n_in * 4 + got[0].shape[0] * k * 8, n_in)
        cells = torch.cat([topk.level_cells(m, c, margin)
                           for m, c in zip(maps, cont)])
        recs["cell_topk"].setdefault("batched", {})[n_lv] = dict(
            library_ms=device_ms(lambda: torch.topk(cells, k, dim=1),
                                 what=f"cell_topk, {what}, library"),
            levels=n_lv, launches=want, max_abs_err=0.0,
            ms=device_ms(lambda: topk.cell_topk_levels(maps, cont, margin,
                                                       k),
                         what=f"cell_topk, {what}"),
            per_frame_ms=device_ms(lambda: [topk.cell_topk_levels(
                maps[i:i + orb.n_levels], contents, margin, k)
                for i in range(0, n_lv, orb.n_levels)],
                what=f"cell_topk, {what} one frame a call"),
            plain_ms=device_ms(lambda: topk.cell_topk_levels_plain(
                maps, cont, margin, k), reps=5,
                what=f"cell_topk, {what}, plain"),
            bound_ms=b, bound_by=by)

        # gather_patches: one call a table of 2 frames' 16 blur maps, as
        # extract_batch makes them
        per = patches.MAX_IMAGES // orb.n_levels
        blurs = [f(np.round(rng.uniform(0, 255, sh)).astype(np.float32))
                 for _ in range(B) for sh in shapes]
        lv, rc = zip(*[corners_case(rng, shapes, contents, budgets, f)
                       for _ in range(B)])
        tables = [(blurs[g * orb.n_levels:(g + per) * orb.n_levels],
                   torch.cat([lv[g + j] + orb.n_levels * j
                              for j in range(per)]),
                   torch.cat(rc[g:g + per])) for g in range(0, B, per)]
        got = launched("gather_patches", lambda: [
            patches.gather_patches_levels(im, l, r, pw)
            for im, l, r in tables], B // per,
            f"gather_patches_levels, {what}")
        for (im, l, r), g in zip(tables, got):
            if not torch.equal(g, patches.gather_patches_levels_plain(
                    im, l, r, pw)):
                raise AssertionError(f"gather_patches differs from its plain "
                                     f"version ({what})")
        n_feat = sum(int(r.shape[0]) for _, _, r in tables)
        n_cov = sum(covered_pixels(shapes, patch_starts(shapes, budgets,
                                                        rc[i], pw), pw)
                    for i in range(B))
        b, by = bound_ms(n_feat * 12 + n_cov * 4 + n_feat * pw * pw * 4, 0)
        windows = [(im.unfold(0, pw, 1).unfold(1, pw, 1), r0, c0)
                   for i in range(B)
                   for im, (r0, c0) in zip(
                       blurs[i * orb.n_levels:(i + 1) * orb.n_levels],
                       patch_starts(shapes, budgets, rc[i], pw))]
        if not torch.equal(torch.cat([v[r0, c0] for v, r0, c0 in windows]),
                           torch.cat(got)):
            raise AssertionError(f"gather_patches' library call differs "
                                 f"({what})")
        recs["gather_patches"].setdefault("batched", {})[n_lv] = dict(
            library_ms=device_ms(lambda: [v[r0, c0] for v, r0, c0 in windows],
                                 what=f"gather_patches, {what}, library"),
            levels=n_lv, launches=B // per, max_abs_err=0.0,
            ms=device_ms(lambda: [patches.gather_patches_levels(
                im, l, r, pw) for im, l, r in tables],
                what=f"gather_patches, {what}"),
            per_frame_ms=device_ms(lambda: [patches.gather_patches_levels(
                blurs[i * orb.n_levels:(i + 1) * orb.n_levels], lv[i], rc[i],
                pw) for i in range(B)],
                what=f"gather_patches, {what} one frame a call"),
            plain_ms=device_ms(lambda: [
                patches.gather_patches_levels_plain(im, l, r, pw)
                for im, l, r in tables], reps=5,
                what=f"gather_patches, {what}, plain"),
            bound_ms=b, bound_by=by)
        for name in ("dense_frontend", "cell_topk", "gather_patches"):
            q = recs[name]["batched"][n_lv]
            log(f"  {name} at {what}: equal to plain (max err "
                f"{q['max_abs_err']:.4f}) in {q['launches']} launches; "
                f"device {q['ms']:.4f} ms (one frame a call "
                f"{q['per_frame_ms']:.4f}, plain {q['plain_ms']:.4f}, library "
                f"{q['library_ms']}, bound "
                f"{q['bound_ms']:.5f} by {q['bound_by']})")


def render_host(cam, planes, R_cw, t_cw, dev):
    """A frame ray-cast on dev (``synth_render.render_image``, equal to the
    numpy ray cast on the CPU) and brought to the host as numpy: the paths
    feed host images, as a camera driver would."""
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render
    return synth_render.render_image(cam, planes, R_cw, t_cw,
                                     dev).cpu().numpy()


def render_host_depth(cam, planes, R_cw, t_cw, dev):
    """render_host's image and the exact depth map of the same ray cast
    (``render_image(with_depth=True)``), both brought to the host."""
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render
    return tuple(x.cpu().numpy() for x in synth_render.render_image(
        cam, planes, R_cw, t_cw, dev, with_depth=True))


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
    return {**m.to_numpy(), "tombstones": copy.deepcopy(m.tombstones),
            **{f: getattr(m, f) for f in ("imu_initialized", "imu_ba1",
                                          "imu_ba2")}}


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
    syncs of 3 frames and profile 2, from probe_from on, with a tracker
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
    probe = frames[frames.index(probe_from):][:5]
    imgs = {i: render_host(cam, planes, R[i], t[i], dev)
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
        prof = profile_frames(lambda: restore(probe[3]), imgs, probe[3:4])
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
N_BOOT = 30
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
    imgs = {i: render_host(cam, planes, R[i], t[i], dev)
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
                              [init_at + 11],
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
        ab_frames = [init_at + 8 + j for j in range(2)]
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


def reset_counts():
    """Every kernel's launch count and the place-recognition search counts
    to 0: the start of a path's run."""
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    native.reset_launches()
    for key in loop_closing.SEARCHES:
        loop_closing.SEARCHES[key] = 0


def expected_launches(tk, n_frames, n_fuse, extractions=1):
    """What a System run launches: extraction once a frame (``extractions``
    a frame); two best-2 scans for each mutual match_nn (the
    reference-keyframe search, visual odometry, the Sim3 verification's
    and the relocalisation's matches); one projection search for each
    stage-1 / stage-2 of a fused step, local-map stage outside it, fuse
    search of a keyframe event, guided match of the Sim3 verification,
    loop-fuse keyframe and relocalisation rescue."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    S = loop_closing.SEARCHES
    return dict(dense_frontend=extractions * n_frames,
                cell_topk=extractions * n_frames,
                gather_patches=extractions * n_frames,
                hamming_best2=2 * (tk.n_ref_kf_searches + tk.n_vo_searches
                                   + S["sim3_match"] + S["reloc_match"]),
                hamming_best2_windowed=2 * tk.n_steps
                + tk.n_local_map_searches + n_fuse + S["projection"]
                + S["loop_fuse"] + S["reloc_search"])


def system_path(dev, cam_kw=CAM_KW, n_frames=N_SYS, world_seed=7,
                map_cfg=None, orb_cfg=None, track_cfg=None, mapping_cfg=None,
                gates=SYS_GATES, replay_from=45, profile_from=50):
    """System(cam, MONOCULAR) at its defaults (loop closing on, the
    bundled vocabulary) fed the orbit: gates the run with
    test_mono_end_to_end's gates, checks that each kernel launched as
    often as the frames, keyframe events and place-recognition searches
    require,
    logs each keyframe event (host clock by span, the local BA's camera
    count, points created, culled and fused, keyframes culled), replays
    one event on the CPU from a snapshot of the map taken before it and
    compares (the first from frame replay_from on that culled a keyframe,
    else the first from there on); on the card also profiles that event
    and the frame profile_from, and holds the fuse passes' searches
    against the plain version at their own shapes."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig, MapStore)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import hamming
    from orb_slam3_detailed_comments_tpu_torch.ops.extractor import OrbConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        local_mapping, loop_closing, system, tracking)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr, timing)

    cam = cameras.pinhole(**cam_kw)
    map_cfg = map_cfg or MapConfig()
    track_cfg = track_cfg or tracking.TrackingConfig()
    orb_cfg = orb_cfg or OrbConfig(n_features=track_cfg.n_features)
    mapping_cfg = mapping_cfg or local_mapping.LocalMappingConfig()
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(60)
    imgs = {i: render_host(cam, planes, R[i], t[i], dev)
            for i in range(n_frames)}
    C = sr.camera_centers(R, t)
    ts = 0.05 * np.arange(len(C))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    slam = system.System(cam, system.MONOCULAR, map_cfg=map_cfg,
                         tracking_cfg=track_cfg, mapping_cfg=mapping_cfg,
                         orb_cfg=orb_cfg, device=dev)
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
    n_pr = len(timing.samples("PR detection"))
    reset_counts()                          # the System path's run starts
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

    n_fuse = sum(ev["fuse_searches"] for ev in events)
    expect = expected_launches(tk, n_frames, n_fuse)
    searches = dict(loop_closing.SEARCHES)
    pr_ms = [1e3 * x for x in timing.samples("PR detection")[n_pr:]]
    log(f"launches on the System path: {launches} (expected {expect}: "
        f"{tk.n_steps} fused steps, {tk.n_ref_kf_searches} reference-"
        f"keyframe and {tk.n_local_map_searches} local-map stages, "
        f"{len(events)} keyframe events with {n_fuse} fuse searches, "
        f"place recognition {searches}); PR detection on "
        f"{slam.loop_closer.n_processed} keyframes, host clock median "
        f"{np.median(pr_ms) if pr_ms else 0.0:.1f} ms over {len(pr_ms)} "
        f"spans; {slam.loop_closer.n_loops_closed} loops closed")
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
               n_events=len(events), launches=launches, searches=searches,
               pr_detection_ms=pr_ms,
               loops_closed=slam.loop_closer.n_loops_closed,
               loop_closing=slam.enable_loop_closing)
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
               steady_frame_ms={i: times[i] for i in steady},
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
            [profile_from], table="profile_frames_system.txt", alone=False)
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
# phase 7 feeds the first 30 frames of the JAX tests' 40-frame orbit and
# the KB8 rig's first 20: the whole script must stay inside its time limit
STEREO_ORBIT, STEREO_N, FISHEYE_N, BASELINE = 40, 30, 20, 0.11
KB8_KW = dict(fx=380.0, fy=380.0, cx=376.0, cy=240.0, width=752, height=480,
              k1=0.0034, k2=0.0008, k3=-0.0007, k4=0.0001)
STEREO_GATES = dict(
    depth=dict(min_matches=200, median_rel=0.03, within_01=0.85),
    stereo=dict(tracked=0.8, ate_poses=0.7, ate_m=0.05, scale=0.03),
    rgbd=dict(tracked=0.8, ate_poses=0.7, ate_m=0.04),
    fisheye=dict(tracked=0.7, ate_poses=0.6, ate_m=0.06),
    cpu_valid=0.99, cpu_depth_rel=1e-3, cpu_inv_depth=1e-6,
    # whole-program depths outside cpu_depth_rel: none, since the pyramid's
    # resize rounds in one fixed order on both devices and the front ends
    # keep the same keypoints (the H100 read 0 and 0)
    cpu_outside=dict(stereo=0, fisheye=0))
# one-image gathers a frame: the rectified matcher's 12x12 and 12x22, the
# fisheye refinement's 12 of 12x12 (ops/stereo.py)
SAD_GATHERS = dict(stereo=2, rgbd=0, fisheye=12)


def stereo_path(dev, cam_kw=CAM_KW, kb8_kw=KB8_KW, n_frames=STEREO_N,
                n_fisheye=FISHEYE_N, map_cfg=None, orb_cfg=None,
                gates=STEREO_GATES, profile_from=20):
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
    R, t = sr.orbit_trajectory(STEREO_ORBIT)
    R, t = R[:n_frames], t[:n_frames]
    pairs, rgbd = [], []
    for i in range(n_frames):
        img, depth = render_host_depth(cam, planes, R[i], t[i], dev)
        rgbd.append((img, depth))
        # render_stereo_pair's pair: this left image, the right one cast
        pairs.append((img, render_host(
            cam, planes, R[i], sr.stereo_right_t(R[i], t[i], BASELINE),
            dev)))
    planes_f = sr.default_world(np.random.default_rng(17))
    Rf, tf = sr.orbit_trajectory(STEREO_ORBIT)
    T_c1c2 = np.eye(4, dtype=np.float32)
    T_c1c2[0, 3] = BASELINE
    fish = [(render_host(kb8, planes_f, Rf[i], tf[i], dev),
             render_host(kb8, planes_f, Rf[i], (
                 tf[i] - np.array([BASELINE, 0, 0])).astype(np.float32), dev))
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
    the shared features), no more of them than gates["cpu_outside"]; and
    the devices' front ends must not part (``frontend_diff``: the same
    keypoints on both, and an equal pyramid)."""
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
        # the pyramid's levels on each device (the resize rounds in one
        # fixed order on both)
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
        # the front ends must not part: the same keypoints, an equal pyramid
        parted = (any(d["keypoints"] for d in differ.values())
                  or any(differ["left"]["pyramid_max_diff"]))
        if (q["valid_agree"] < gates["cpu_valid"]
                or q["shared_valid_agree"] < gates["cpu_valid"]
                or q["shared_n_outside"] or unexplained or parted
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


# ---------------------------------------------------------------- phase 8
# place recognition, relocalisation, loop closing with global BA and map
# merging, each at the cases of the JAX package's tests:
# test_loop_closing.py's test_loop_detected_and_trajectory_consistent (8a)
# and test_relocalization_after_blackout (8b), test_atlas_multimap.py's
# test_multimap_spawn_and_merge (8c); ray-cast frames, rendered on the card
LOOP_CAM_KW = dict(fx=400.0, fy=400.0, cx=376.0, cy=240.0, width=752,
                   height=480)
MERGE_CAM_KW = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752,
                    height=480)
LOOP_GATES = dict(tracked=0.7, loops=1, ate_m=0.20, replay_rel=1e-3)
# phases 8a and 10b feed the first 40 of the loop's 140 frames (two
# closures): the whole script must stay well inside its time limit
LOOP_FEED = 40
RELOC_GATES = dict(min_kf=5, matched=15)
MERGE_GATES = dict(tracked1=0.7, tracked2=0.5, rows=0.7, ate_poses=0.6,
                   ate_m=0.18)


def feed_system(slam, feed, n, dev, extractions=1, sad=0, before=None):
    """Feed a System n frames (feed(i) tracks frame i) with the counts at 0
    just before; each frame's host clock, the keyframe events' fuse
    searches and which frames ran one. before(i) runs ahead of frame i,
    outside the clock. Returns (poses, times, event_frames, launches,
    expected launches): extractions and the stereo SAD's one-image
    gathers a frame as given."""
    from orb_slam3_detailed_comments_tpu_torch import native
    sync = torch_sync(dev)
    lm = slam.local_mapper
    n_fuse, events, frame = [0], [], [0]
    process = lm.process_keyframe

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event.get("fuse_searches", 0)
        events.append(frame[0])

    lm.process_keyframe = counted
    poses, times = [], []
    reset_counts()                          # this path's run starts here
    try:
        for i in range(n):
            frame[0] = i
            if before is not None:
                before(i)
            sync()
            t0 = time.perf_counter()
            poses.append(feed(i))
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(native.launches)    # ... and ends here
    finally:
        lm.process_keyframe = process
    expect = expected_launches(slam.tracker, n, n_fuse[0], extractions)
    expect["gather_patches"] += sad * n
    return poses, times, sorted(set(events)), launches, expect


def check_launches(name, launches, expect, dev):
    log(f"{name}: launches {launches} (expected {expect})")
    if dev.type == "cuda":
        for k, want in expect.items():
            if launches[k] != want or want == 0:
                raise AssertionError(f"{name}: {k}: {launches[k]} launches, "
                                     f"expected {want}")


def run_system(slam, frames, ts, name, dev):
    """Feed a System its frames with the counts at 0 just before; returns
    (poses, launches, expected launches, host ms a frame)."""
    poses, times, _, launches, expect = feed_system(
        slam, lambda i: slam.track_monocular(frames[i], float(ts[i])),
        len(frames), dev)
    check_launches(name, launches, expect, dev)
    return poses, launches, expect, times


def torch_sync(dev):
    import torch
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def span_ms(stage, since=0):
    from orb_slam3_detailed_comments_tpu_torch.utils import timing
    return [1e3 * x for x in timing.samples(stage)[since:]]


def loop_path(dev, cam_kw=LOOP_CAM_KW, n_frames=140, gates=LOOP_GATES,
              map_cfg=None, track_cfg=None, n_feed=None):
    """8a: System(cam, MONOCULAR) at its defaults around box world seed
    11 (loop_trajectory(radius=3, closes=1.05)): > 70 % of the frames
    tracked, >= 1 loop closed, scale-aligned ATE < 0.20 m, a consistent
    map; logs the keyframe count at each closure, the global BA's camera
    count and tier, the host clock of the "PR detection" and "loop
    correction" spans and each kernel's launches. The first detection that
    verified a candidate is replayed on the CPU from a snapshot of the map
    and its keyframe database: the same candidates and a Sim3 within
    replay_rel. n_feed: feed only the trajectory's first n_feed frames
    (the gates and the ATE then over those)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        loop_closing, system)
    from orb_slam3_detailed_comments_tpu_torch.placerec import (
        keyframe_db, vocab)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr)
    cam = cameras.pinhole(**cam_kw)
    walls = sr.box_world(np.random.default_rng(11))
    R, t = sr.loop_trajectory(n_frames, radius=3.0, closes=1.05)
    n_frames = n_feed or n_frames
    R, t = R[:n_frames], t[:n_frames]
    frames = [sr.render_image(cam, walls, R[i], t[i], dev)
              for i in range(n_frames)]
    ts = 0.05 * np.arange(n_frames)
    kw = {} if map_cfg is None else dict(map_cfg=map_cfg)
    if track_cfg is not None:
        kw["tracking_cfg"] = track_cfg
    slam = system.System(cam, system.MONOCULAR, device=dev, **kw)
    closures, replay = [], {}
    n_pr, n_lc = len(span_ms("PR detection")), len(span_ms("loop correction"))

    def hooked(lc):
        correct, detect = lc._correct_loop, lc._detect

        def logged_correct(k, c, S):
            n_kf = int(lc.map.n_kf)
            out = correct(k, c, S)
            closures.append(dict(k=int(k), c=int(c), n_kf=n_kf,
                                 gba=list(lc.last_correction.get("gba", []))))
            return out

        def logged_detect(k):
            out = detect(k)
            if out is not None and "k" not in replay:
                # _detect reads the map and the database and changes
                # neither: the state after it is the state it saw
                db = lc.kfdb
                replay.update(
                    k=int(k), c=int(out[0]), S=loop_closing.sim3_np(out[1]),
                    cands=db.detect_candidates(lc.map, k,
                                               lc.cfg.n_candidates),
                    map=map_arrays(lc.map),
                    cfg=dataclasses.replace(lc.map.cfg),
                    db=dict(width=db.width, max_kf=db.max_kf,
                            word_ids=db.word_ids.copy(),
                            word_w=db.word_w.copy(), valid=db.valid.copy()))
            return out
        lc._correct_loop, lc._detect = logged_correct, logged_detect

    build = slam._build_recognition

    def build_hooked(*a, **k):
        build(*a, **k)
        hooked(slam.loop_closer)

    slam._build_recognition = build_hooked
    poses, launches, expect, times = run_system(slam, frames, ts, "8a loop",
                                                dev)
    lc = slam.loop_closer
    rows = slam.trajectory_tum()
    rmse, n_ate, scale = evaluate_ate.ate_rmse(
        ts, sr.camera_centers(R, t), np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    errs = slam.check_map_consistency()
    n_ok = sum(p is not None for p in poses)
    pr, corr = span_ms("PR detection", n_pr), span_ms("loop correction", n_lc)
    rec = dict(tracked=n_ok, keyframes=slam.n_keyframes,
               loops_closed=lc.n_loops_closed, closures=closures,
               ate_m=rmse, ate_poses=n_ate, ate_scale=scale,
               consistency=errs, launches=launches,
               searches=dict(loop_closing.SEARCHES),
               pr_detection_ms=dict(n=len(pr), median=float(np.median(pr)),
                                    p90=float(np.percentile(pr, 90)),
                                    max=float(np.max(pr))),
               loop_correction_ms=corr,
               frame_ms_median=float(np.median(times)))
    log(f"8a loop: {n_ok}/{n_frames} frames tracked, {slam.n_keyframes} "
        f"keyframes, {lc.n_loops_closed} loops closed "
        f"({lc.n_loops_rejected_projgate} rejected at the projection gate); "
        f"closures (keyframe count, global BA C and tier a round): "
        + "; ".join(f"{c['k']}<-{c['c']} at {c['n_kf']} KF, "
                    + ", ".join(f"C={g['C']} {g['tier']}" for g in c["gba"])
                    for c in closures)
        + f"; scale-aligned ATE {rmse:.5f} m over {n_ate} poses (scale "
        f"{scale:.4f}); consistency {errs}; host clock: PR detection median "
        f"{rec['pr_detection_ms']['median']:.1f} ms p90 "
        f"{rec['pr_detection_ms']['p90']:.1f} over {len(pr)} keyframes, loop "
        f"correction {[round(x, 1) for x in corr]} ms; frame median "
        f"{rec['frame_ms_median']:.1f} ms")
    fails = [name for name, bad in (
        ("frames tracked", n_ok <= gates["tracked"] * n_frames),
        ("loops closed", lc.n_loops_closed < gates["loops"]),
        ("ATE", not rmse < gates["ate_m"]),
        ("map consistency", errs != [])) if bad]
    if fails:
        raise AssertionError(f"8a loop missed the gates: {fails}: {rec}")

    # the first verified detection, once more on the CPU
    if "k" not in replay:
        raise AssertionError("8a loop: no detection to replay")
    cpu = torch.device("cpu")
    m = MapStore.from_numpy(replay["map"], replay["cfg"], device=cpu)
    db = keyframe_db.KeyFrameDatabase(vocab.load(vocab.DEFAULT_PATH, cpu),
                                      replay["db"]["max_kf"],
                                      replay["db"]["width"])
    for key in ("word_ids", "word_w", "valid"):
        setattr(db, key, replay["db"][key])
    cands = db.detect_candidates(m, replay["k"], lc.cfg.n_candidates)
    out = loop_closing.verify_sim3_pair(m, replay["k"], m, replay["c"], cam,
                                        lc.cfg)
    if cands != replay["cands"] or out is None:
        raise AssertionError(f"8a replay: candidates {cands} on the CPU, "
                             f"{replay['cands']} on the card; CPU "
                             f"verification {out is not None}")
    Sc = loop_closing.sim3_np(out[1])
    rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))
              for a, b in zip(Sc[:2], replay["S"][:2]))
    rel = max(rel, abs(Sc[2] - replay["S"][2]) / replay["S"][2])
    rec["replay"] = dict(k=replay["k"], c=replay["c"], candidates=cands,
                         sim3_rel=rel, scale_card=replay["S"][2],
                         scale_cpu=Sc[2])
    log(f"8a replay of keyframe {replay['k']}'s detection on the CPU: the "
        f"same candidates {cands}; Sim3 to {replay['c']} within {rel:.2e} "
        f"relative (scale card {replay['S'][2]:.6f}, CPU {Sc[2]:.6f})")
    if not rel < gates["replay_rel"]:
        raise AssertionError(f"8a replay: the Sim3 differs by {rel}")
    return rec


def reloc_path(dev, cam_kw=LOOP_CAM_KW, gates=RELOC_GATES, map_cfg=None,
               track_cfg=None):
    """8b: world seed 5, 46 frames of the orbit, TrackingConfig(max_frames
    =4): 30 frames tracked, 6 blank frames, then frames 26-29 again; the
    tracker must recover, and _relocalize on frame 20 must give >= 15
    matched points and a finite pose. Logs the host clock of one
    relocalisation (3 runs)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        kernels, loop_closing, system, tracking)
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(5))
    R, t = sr.orbit_trajectory(46)
    frames = [sr.render_image(cam, planes, R[i], t[i], dev) for i in range(46)]
    ts = 0.05 * np.arange(46)
    kw = {} if map_cfg is None else dict(map_cfg=map_cfg)
    slam = system.System(cam, system.MONOCULAR, device=dev,
                         tracking_cfg=track_cfg or tracking.TrackingConfig(
                             max_frames=4), **kw)
    blank = torch.full_like(frames[0], 128.0)
    feed = frames[:30] + [blank] * 6 + frames[26:30]
    times = 0.05 * np.arange(36)
    feed_ts = np.concatenate([times, ts[26:30] + 0.6])
    state_30 = []
    track = slam.track_monocular

    def watch(img, t_):
        out = track(img, t_)
        if len(state_30) == 29:
            state_30.append((slam.tracker.state, slam.map.n_kf))
        else:
            state_30.append(None)
        return out

    slam.track_monocular = watch
    poses, launches, expect, _ = run_system(slam, feed, feed_ts, "8b reloc",
                                            dev)
    st30, n_kf30 = state_30[29]
    after_blank = [p is not None for p in poses[30:36]]
    recovered = next((26 + j for j, p in enumerate(poses[36:]) if p is not None),
                     None)
    prep = kernels.prepare_frame(frames[20], cam, slam.tracker.orb_cfg)
    ms, out = [], None
    sync = torch_sync(dev)
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        out = slam._relocalize(prep)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    n_match = int((out[2] >= 0).sum()) if out is not None else 0
    finite = out is not None and bool(np.isfinite(out[0]).all()
                                      and np.isfinite(out[1]).all())
    rec = dict(state_at_30=int(st30), keyframes_at_30=int(n_kf30),
               tracked_in_blackout=int(sum(after_blank)),
               recovered_at=recovered,
               relocalizations=slam.tracker.n_relocalizations,
               reloc_matched=n_match, reloc_finite=finite,
               reloc_ms=ms, launches=launches,
               searches=dict(loop_closing.SEARCHES))
    log(f"8b relocalisation: state {st30} with {n_kf30} keyframes at frame "
        f"30; {sum(after_blank)} of 6 blank frames tracked; recovered at "
        f"frame {recovered} ({slam.tracker.n_relocalizations} "
        f"relocalisations in the tracker); _relocalize on frame 20: "
        f"{n_match} matched points, finite {finite}, host clock "
        f"{[round(x, 1) for x in ms]} ms")
    fails = [name for name, bad in (
        ("tracking at frame 30", st30 != tracking.OK
         or n_kf30 <= gates["min_kf"]),
        ("lost in the blackout", any(after_blank)),
        ("recovery", recovered is None),
        ("relocalisation", n_match < gates["matched"] or not finite)) if bad]
    if fails:
        raise AssertionError(f"8b missed the gates: {fails}: {rec}")
    return rec


def merge_path(dev, cam_kw=MERGE_CAM_KW, n=50, n2=30, gates=MERGE_GATES,
               map_cfg=None, track_cfg=None):
    """8c: world seed 7, n frames of the orbit, change_dataset(), the last
    n2 frames again at ts + 10 s: 2 maps with the second active, >= 1
    merge, joint scale-aligned ATE < 0.18 m over > 60 % of n + n2 poses;
    a consistent map."""
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        loop_closing, system)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr)
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(7))
    R, t = sr.orbit_trajectory(n)
    frames = [sr.render_image(cam, planes, R[i], t[i], dev) for i in range(n)]
    ts = 0.05 * np.arange(n)
    ts2 = ts[-n2:] + 10.0
    kw = {} if map_cfg is None else dict(map_cfg=map_cfg)
    if track_cfg is not None:
        kw["tracking_cfg"] = track_cfg
    slam = system.System(cam, system.MONOCULAR, device=dev, **kw)
    track = slam.track_monocular
    switch = [0]

    def feed(img, t_):
        if switch[0] == n:
            slam.change_dataset()
        switch[0] += 1
        return track(img, t_)

    slam.track_monocular = feed
    poses, launches, expect, _ = run_system(
        slam, frames + frames[-n2:], np.concatenate([ts, ts2]), "8c merge",
        dev)
    ok1 = sum(p is not None for p in poses[:n])
    ok2 = sum(p is not None for p in poses[n:])
    rows = slam.trajectory_tum()
    gt = sr.camera_centers(R, t)
    rmse, npairs, scale = evaluate_ate.ate_rmse(
        np.concatenate([ts, ts2]), np.concatenate([gt, gt[-n2:]]),
        np.array([r[0] for r in rows]), np.array([r[1:4] for r in rows]))
    errs = slam.check_map_consistency()
    rec = dict(tracked1=ok1, tracked2=ok2, maps=len(slam.atlas.maps),
               active=slam.atlas.active_id, merges=slam.atlas.n_merges,
               rows=len(rows), ate_m=rmse, ate_poses=npairs,
               ate_scale=scale, consistency=errs, launches=launches,
               searches=dict(loop_closing.SEARCHES))
    log(f"8c merge: {ok1}/{n} then {ok2}/{n2} frames tracked; "
        f"{len(slam.atlas.maps)} maps, active {slam.atlas.active_id}, "
        f"{slam.atlas.n_merges} merges; {len(rows)} rows; joint ATE "
        f"{rmse:.5f} m over {npairs} poses (scale {scale:.4f}); "
        f"consistency {errs}")
    fails = [name for name, bad in (
        ("first sequence", ok1 <= gates["tracked1"] * n),
        ("second sequence", ok2 <= gates["tracked2"] * n2),
        ("maps", len(slam.atlas.maps) != 2 or slam.atlas.active_id != 1),
        ("merges", slam.atlas.n_merges < 1),
        ("rows", len(rows) <= gates["rows"] * (n + n2)),
        ("ATE", not (npairs > gates["ate_poses"] * (n + n2)
                     and rmse < gates["ate_m"])),
        ("map consistency", errs != [])) if bad]
    if fails:
        raise AssertionError(f"8c missed the gates: {fails}: {rec}")
    return rec


# ---------------------------------------------------------------- phase 9
# visual-inertial SLAM at the cases of the JAX package's tests:
# test_pipeline_mono_inertial.py's test_mono_inertial_end_to_end and
# test_gravity_alignment (9a, loop closing on: the System's defaults) and
# test_pipeline_stereo_inertial.py's test_stereo_inertial_end_to_end (9b,
# loop closing off), frames ray-cast on the card (the JAX tests warp with
# cv2), IMU windows of utils/synth_render.inertial_trajectory
IMU_CAM_KW = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752,
                  height=480)
IMU_MONO_GATES = dict(tracked=0.7, bg=3e-3, scale=0.12, ate_m=0.06,
                      ate_poses=0.6, gravity_cos=0.99, replay_match=0.99,
                      replay_tol=1e-3)
IMU_STEREO_GATES = dict(tracked=0.8, bg=8e-3, ate_m=0.05, ate_poses=0.7,
                        replay_match=0.99, replay_tol=1e-3)
# 9b feeds the first 35 of the JAX test's 45 frames (inertial_trajectory
# integrates frame by frame: a prefix is the same frames), for the whole
# script's time
IMU_STEREO_FEED = 35
IMU_MONO_BG = np.array([0.003, -0.002, 0.004], np.float32)
IMU_STEREO_BG = np.array([-0.002, 0.003, 0.001], np.float32)


def _tensors_to(x, dev):
    """x with every tensor inside (tuples, NamedTuples, dicts) on dev."""
    import torch
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_tensors_to(v, dev) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_tensors_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _tensors_to(v, dev) for k, v in x.items()}
    return x


def _capture(mod, name, keep):
    """Wrap mod.name so that keep(args, kwargs, result) sees each call;
    returns the undo."""
    real = getattr(mod, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        keep(a, kw, out)
        return out

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, real)


def inertial_step_replay(call, dev):
    """One captured track_step_inertial_lf call run again on the card and
    on the CPU from the same inputs: match_pt agreement, pose and velocity
    differences."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
    a, kw = call
    card = kernels.track_step_inertial_lf(*a, **kw)
    cpu = kernels.track_step_inertial_lf(*_tensors_to(a, torch.device("cpu")),
                                         **_tensors_to(kw,
                                                       torch.device("cpu")))
    mc, mp = card.match_pt.cpu().numpy(), cpu.match_pt.numpy()
    d = lambda x, y: float(torch.max(torch.abs(x.cpu() - y)))
    return dict(match_equal=float((mc == mp).mean()),
                n_matched=int((mc >= 0).sum()),
                refine_inliers=(int(card.ni), int(cpu.ni)),
                R=d(card.Ri_cw, cpu.Ri_cw), t=d(card.ti_cw, cpu.ti_cw),
                v=d(card.v_w, cpu.v_w))


def imu_init_replay(snap, args, map_cfg, dev):
    """The first successful try_initialize_imu once more on the CPU, on a
    copy of the map as the card's call found it: scale and R_wg."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.lie import so3
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    from orb_slam3_detailed_comments_tpu_torch.pipeline import inertial
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = MapStore.from_numpy(snap, map_cfg, device=device)
        res = inertial.try_initialize_imu(m, **args)
        if res is None:
            raise AssertionError(f"the IMU initialisation replayed on the "
                                 f"{name} did not take")
        out[name] = res
    (R1, s1), (R2, s2) = out["card"], out["cpu"]
    ang = float(torch.linalg.norm(so3.log(torch.from_numpy(
        np.asarray(R1).T @ np.asarray(R2)))))
    return dict(scale_card=float(s1), scale_cpu=float(s2),
                scale_diff=abs(float(s1) - float(s2)), R_wg_rad=ang)


def jacobian_routes(dev, reps=20):
    """The three routes to the inertial optimisers' Jacobians, timed on the
    card (host clock of one call, ending in a synchronize; device time from
    the profiler): torch.func.jacfwd, forward mode with batched tangents
    (optim/jac.py) and the written-out derivatives (imu/factors.py's
    inertial_jacobians, pose_opt._visual), on the 9-dof inertial residual
    over its 24-dim pair state and on 1024 visual rows over 6 dof."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.imu import (
        factors, preintegration as pre_mod)
    from orb_slam3_detailed_comments_tpu_torch.lie import so3
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.optim import jac, pose_opt
    rng = np.random.default_rng(0)
    cam = cameras.pinhole(**IMU_CAM_KW)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    calib = pre_mod.ImuCalib.default()
    pre = pre_mod.integrate(f(rng.normal(0, 1, (20, 3)) + [0, 0, 9.81]),
                            f(rng.normal(0, 0.1, (20, 3))),
                            f(np.full(20, 0.005)), calib)
    g = f([0, 0, -9.81])
    R1 = so3.exp(f(rng.normal(0, 0.1, 3)))
    p1, v1 = f(rng.normal(0, 1, 3)), f(rng.normal(0, 1, 3))
    R2 = so3.exp(f(rng.normal(0, 0.1, 3)))
    p2, v2 = p1 + 0.1 * v1, v1
    bg, ba = f([0.001, -0.002, 0.003]), f([0.01, 0.0, -0.01])

    def inert(x):
        return factors.inertial_residual(
            R1 @ so3.exp(x[..., 0:3]), p1 + x[..., 3:6], v1 + x[..., 6:9],
            R2 @ so3.exp(x[..., 9:12]), p2 + x[..., 12:15],
            v2 + x[..., 15:18], bg + x[..., 18:21], ba + x[..., 21:24], pre,
            g)

    def inert_written():
        r, Ji, Jj, Jbg, Jba = factors.inertial_jacobians(
            R1, p1, v1, R2, p2, v2, bg, ba, pre, g)
        return r, torch.cat([Ji, Jj, Jbg, Jba], -1)

    X = f(np.stack([rng.uniform(-4, 4, 1024), rng.uniform(-3, 3, 1024),
                    rng.uniform(4, 9, 1024)], 1))
    uv = cameras.project(cam, X)
    eye3, z3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def vis(x):
        x_b = (X - (p2 + x[..., 3:6])[..., None, :]) @ (
            R2 @ so3.exp(x[..., 0:3]))
        return (cameras.project(cam, x_b) - uv).reshape(
            *x.shape[:-1], -1)

    # a batch of one: torch.func gives a 0-dim torch.where a float64
    # tangent, which the float32 products refuse
    z24 = torch.zeros((1, 24), device=dev)
    z6 = torch.zeros((1, 6), device=dev)
    routes = {
        "inertial_9x24: torch.func.jacfwd":
            lambda: torch.func.jacfwd(inert)(z24),
        "inertial_9x24: forward mode, batched tangents":
            lambda: jac.jacobian_fwd(inert, z24),
        "inertial_9x24: written out": inert_written,
        "visual_1024x6: torch.func.jacfwd":
            lambda: torch.func.jacfwd(vis)(z6),
        "visual_1024x6: forward mode, batched tangents":
            lambda: jac.jacobian_fwd(vis, z6),
        "visual_1024x6: written out":
            lambda: pose_opt._visual(R2, p2, X, uv, cam, eye3, z3)}
    ref = routes["inertial_9x24: torch.func.jacfwd"]()[0, :, 0]
    out = dict(inertial_fwd_diff=float(torch.max(torch.abs(
        ref - routes["inertial_9x24: forward mode, batched tangents"]()[1][
            0]))),
        inertial_written_diff=float(torch.max(torch.abs(
            ref - inert_written()[1]))))
    log(f"  Jacobian routes: the inertial 9x24 forward-mode one within "
        f"{out['inertial_fwd_diff']:.2e} of torch.func.jacfwd, the written-"
        f"out one within {out['inertial_written_diff']:.2e}")
    for name, fn in routes.items():
        out[name] = dict(host_ms=host_ms(fn, reps=reps),
                         device_ms=device_ms(fn, reps=5, what=name))
        log(f"  Jacobian route {name}: host clock {out[name]['host_ms']:.3f}"
            f" ms, device {out[name]['device_ms']:.4f} ms a call")
    return out


def inertial_path(dev, sensor="mono", cam_kw=IMU_CAM_KW, n_frames=None,
                  world_seed=None, map_cfg=None, track_cfg=None,
                  gates=None, replay_from=None, profile_from=None,
                  loop_closing=None):
    """9a (sensor "mono"): System(cam, IMU_MONOCULAR) at its defaults on
    world seed 11's 60-frame inertial trajectory; 9b (sensor "stereo"):
    System(cam, IMU_STEREO, baseline=0.11, enable_loop_closing=False) on
    the first 35 of world seed 13's 45 frames (IMU_STEREO_FEED). Each held
    to its JAX tests' gates, every
    kernel's launches checked against the frames and the searches; the
    first track_step_inertial_lf from replay_from on replayed on the CPU;
    the first successful IMU initialisation replayed on the CPU from the
    map it found; the host clock of the IMU initialisation (with its full
    inertial BA) and of each local inertial BA; on the card the steady
    inertial frame profile_from profiled on a copy of the tracker (none
    for profile_from=-1)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        inertial, kernels, loop_closing, system, tracking)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr, timing)

    mono = sensor == "mono"
    n = n_frames or (60 if mono else IMU_STEREO_FEED)
    seed = world_seed or (11 if mono else 13)
    gates = gates or (IMU_MONO_GATES if mono else IMU_STEREO_GATES)
    true_bg = IMU_MONO_BG if mono else IMU_STEREO_BG
    replay_from = replay_from if replay_from is not None else n // 2
    profile_from = profile_from if profile_from is not None else n - 6
    cam = cameras.pinhole(**cam_kw)
    map_cfg = map_cfg or MapConfig()
    planes = sr.default_world(np.random.default_rng(seed))
    traj = sr.inertial_trajectory(n, true_bg=true_bg)
    t0 = time.perf_counter()
    left = [render_host(cam, planes, traj["R_cw"][i], traj["t_cw"][i], dev)
            for i in range(n)]
    right = [] if mono else [render_host(
        cam, planes, traj["R_cw"][i],
        sr.stereo_right_t(traj["R_cw"][i], traj["t_cw"][i], BASELINE), dev)
        for i in range(n)]
    log(f"  rendered {n} frames{'' if mono else ' (pairs)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(map_cfg=map_cfg, device=dev)
    if track_cfg is not None:
        kw["tracking_cfg"] = track_cfg
    if mono:
        slam = system.System(cam, system.IMU_MONOCULAR,
                             enable_loop_closing=(True if loop_closing is None
                                                  else loop_closing), **kw)
    else:
        slam = system.System(cam, system.IMU_STEREO, baseline=BASELINE,
                             enable_loop_closing=bool(loop_closing), **kw)
    tk, lm = slam.tracker, slam.local_mapper
    sync = torch_sync(dev)
    ts = traj["ts"]

    def feed(who, i):
        """Frame i to a System or a bare tracker (the same signature)."""
        if mono:
            return who.track_monocular(left[i], float(ts[i]),
                                       traj["windows"][i])
        return who.track_stereo(left[i], right[i], float(ts[i]),
                                traj["windows"][i])

    # watched from outside: the fuse searches of each keyframe event, the
    # first track_step_inertial_lf from replay_from on, the IMU
    # initialisation's map and host clock, each local inertial BA
    frame, n_fuse, lf_call, init, lba = [0], [0], {}, {}, []
    process = lm.process_keyframe

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event.get("fuse_searches", 0)

    def keep_lf(a, kw_, out):
        if frame[0] >= replay_from and "call" not in lf_call:
            lf_call["call"] = (a, kw_)

    real_init = inertial.try_initialize_imu

    def watched_init(m, **args):
        snap = map_arrays(m) if "snap" not in init else None
        out = real_init(m, **args)
        if out is not None and snap is not None:
            init.update(snap=snap, args=args, frame=frame[0])
        return out

    real_stage = slam._imu_stage

    def timed_stage(*a, **kw_):
        n0 = len(slam.imu_events)
        sync()
        t1 = time.perf_counter()
        took = real_stage(*a, **kw_)
        sync()
        if len(slam.imu_events) > n0:
            slam.imu_events[-1]["host_ms"] = (time.perf_counter() - t1) * 1e3
            slam.imu_events[-1]["frame"] = frame[0]
        return took

    real_lba = inertial.run_local_inertial_ba

    def timed_lba(*a, **kw_):
        sync()
        t1 = time.perf_counter()
        C = real_lba(*a, **kw_)
        sync()
        lba.append(dict(frame=frame[0], C=C,
                        host_ms=(time.perf_counter() - t1) * 1e3))
        return C

    lm.process_keyframe = counted
    undo = [_capture(kernels, "track_step_inertial_lf", keep_lf)]
    inertial.try_initialize_imu = watched_init
    inertial.run_local_inertial_ba = timed_lba
    slam._imu_stage = timed_stage
    poses, times, how, prof_tk = [], [], {}, None
    reset_counts()                          # this path's run starts here
    try:
        for i in range(n):
            frame[0] = i
            if i == profile_from and dev.type == "cuda":
                reloc, tk.relocalizer = tk.relocalizer, None
                # the copy takes a lock of its own (a lock has no copy)
                prof_tk = copy.deepcopy(
                    tk, {id(tk.map_lock): threading.RLock()})
                tk.relocalizer = reloc
            s0 = dict(tk.n_inertial_steps)
            steps0, dr0 = tk.n_steps, tk.n_dead_reckoned
            ev0 = len(slam.imu_events) + len(lba)
            sync()
            t1 = time.perf_counter()
            T = feed(slam, i)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
            poses.append(T)
            how[i] = ("none" if T is None else "dead" if tk.n_dead_reckoned
                      > dr0 else "lf" if tk.n_inertial_steps["lf"] > s0["lf"]
                      else "anchor" if tk.n_inertial_steps["anchor"]
                      > s0["anchor"] else "visual" if tk.n_steps > steps0
                      else "other")
            if len(slam.imu_events) + len(lba) > ev0:
                how[i] += "+imu"
        launches = dict(native.launches)    # ... and ends here
    finally:
        lm.process_keyframe = process
        for u in undo:
            u()
        inertial.try_initialize_imu = real_init
        inertial.run_local_inertial_ba = real_lba
        slam.__dict__.pop("_imu_stage", None)
    name = "9a mono-inertial" if mono else "9b stereo-inertial"
    log(f"{name}: frames by path {how}")
    per = 1 if mono else 2
    S = loop_closing.SEARCHES
    expect = dict(dense_frontend=per * n, cell_topk=per * n,
                  gather_patches=(per + (0 if mono else 2)) * n,
                  hamming_best2=2 * (tk.n_ref_kf_searches + tk.n_vo_searches
                                     + S["sim3_match"] + S["reloc_match"]),
                  hamming_best2_windowed=2 * tk.n_steps
                  + tk.n_local_map_searches + n_fuse[0] + S["projection"]
                  + S["loop_fuse"] + S["reloc_search"])
    log(f"{name}: launches {launches} (expected {expect}: {tk.n_steps} "
        f"fused steps of which {tk.n_inertial_steps} inertial, "
        f"{tk.n_ref_kf_searches} reference-keyframe and "
        f"{tk.n_local_map_searches} local-map stages, {n_fuse[0]} fuse "
        f"searches, place recognition {dict(S)})")
    if dev.type == "cuda":
        for k, want in expect.items():
            if launches[k] != want or (want == 0 and k != "hamming_best2"):
                raise AssertionError(f"{name}: {k}: {launches[k]} launches, "
                                     f"expected {want}")

    m = slam.map
    tracked = sum(p is not None for p in poses)
    chain = m.temporal_chain()
    bg = m.kf_bg[chain[-1]] if len(chain) else np.full(3, np.nan)
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    rmse, n_ate, scale = evaluate_ate.ate_rmse(ts, traj["centers"], est_ts,
                                               est, with_scale=mono)
    if mono:
        FINAL_MAPS["9a"] = dict(map=map_arrays(m), cfg=m.cfg, cam_kw=cam_kw)
    rec = dict(tracked=tracked, n_frames=n, keyframes=slam.n_keyframes,
               points=slam.n_map_points, imu_initialized=m.imu_initialized,
               bg=bg.tolist(), bg_err=float(np.abs(bg - true_bg).max()),
               ate_m=rmse, ate_poses=n_ate, scale=scale,
               consistency=slam.check_map_consistency(),
               imu_events=slam.imu_events, local_inertial_ba=lba,
               inertial_steps=dict(tk.n_inertial_steps),
               loops_closed=(slam.loop_closer.n_loops_closed
                             if slam.loop_closer is not None else 0),
               launches=launches, how=how)
    if mono:
        pairs = evaluate_ate.associate(est_ts, ts)
        _, Rh, _, _ = evaluate_ate.align_horn(est[pairs[:, 0]],
                                              traj["centers"][pairs[:, 1]])
        g_true = traj["gravity"] / np.linalg.norm(traj["gravity"])
        rec["gravity_cos"] = float((Rh @ np.array([0.0, 0.0, -1.0]))
                                   @ g_true)
    steady = [times[i] for i in range(n) if how[i] in ("lf", "anchor")]
    rec.update(frame_ms_median=float(np.median(steady)) if steady else None,
               frame_ms_p90=float(np.percentile(steady, 90))
               if steady else None, n_steady=len(steady))
    log(f"{name}: {tracked}/{n} frames tracked, {slam.n_keyframes} "
        f"keyframes, {slam.n_map_points} points, IMU initialised "
        f"{m.imu_initialized}; bg {np.round(bg, 5).tolist()} (true "
        f"{true_bg.tolist()}, error {rec['bg_err']:.5f}); "
        f"{'scale-aligned' if mono else 'metric'} ATE {rmse:.5f} m over "
        f"{n_ate} poses, scale {scale:.4f}"
        + (f", gravity cos {rec['gravity_cos']:.5f}" if mono else "")
        + f"; {rec['loops_closed']} loops; consistency {rec['consistency']}")
    log(f"{name}: steady inertial frames (host clock, image upload to "
        f"pose): median {rec['frame_ms_median']} ms, p90 "
        f"{rec['frame_ms_p90']} ms over {len(steady)}; IMU stages "
        f"{slam.imu_events}; local inertial BAs {lba}")
    fails = [k for k, bad in (
        ("frames tracked", tracked <= gates["tracked"] * n),
        ("IMU initialised", not m.imu_initialized),
        ("gyro bias", not rec["bg_err"] < gates["bg"]),
        ("scale", "scale" in gates and not abs(scale - 1) < gates["scale"]),
        ("ATE", not (n_ate > gates["ate_poses"] * n
                     and rmse < gates["ate_m"])),
        ("gravity", "gravity_cos" in gates
         and not rec["gravity_cos"] > gates["gravity_cos"])) if bad]
    if fails:
        raise AssertionError(f"{name} missed its gates: {fails}: "
                             f"{ {k: v for k, v in rec.items() if k not in ('how', 'launches')} }")

    # card against CPU: one track_step_inertial_lf frame, the first IMU
    # initialisation
    if "call" not in lf_call:
        raise AssertionError(f"{name}: no track_step_inertial_lf from frame "
                             f"{replay_from} on")
    if "snap" not in init:
        raise AssertionError(f"{name}: no IMU initialisation to replay")
    rec["step_replay"] = inertial_step_replay(lf_call["call"], dev)
    rec["init_replay"] = dict(imu_init_replay(init["snap"], init["args"],
                                              map_cfg, dev),
                              frame=init["frame"])
    log(f"{name}: track_step_inertial_lf card against CPU: "
        f"{rec['step_replay']}; first IMU initialisation (frame "
        f"{init['frame']}) card against CPU: {rec['init_replay']}")
    sr_, ir = rec["step_replay"], rec["init_replay"]
    tol = gates["replay_tol"]
    if not (sr_["match_equal"] >= gates["replay_match"] and sr_["R"] < tol
            and sr_["t"] < tol and sr_["v"] < tol
            and ir["scale_diff"] < tol and ir["R_wg_rad"] < tol):
        raise AssertionError(f"{name}: card and CPU part: {sr_}, {ir}")

    if prof_tk is not None:
        fixed_key = prof_tk._imu_prior_key

        def make():
            tk2 = copy.deepcopy(prof_tk,
                                {id(prof_tk.map_lock): threading.RLock()})
            if fixed_key is not None:
                tk2._imu_prior_key = (id(tk2.map),) + tuple(fixed_key[1:])
            return tk2

        rec["profile"] = profile_frames(
            make, None, [profile_from],
            table=f"profile_frames_imu_{sensor}.txt", alone=False,
            track=feed)
        if steady:
            rec["profile"]["busy_share"] = (rec["profile"]["device_ms"]
                                            / rec["frame_ms_median"])
            log(f"{name}: device busy share of a steady inertial frame: "
                f"{rec['profile']['busy_share']:.3f}")
    return rec


# ---------------------------------------------------------------- phase 10
# what a background thread raised during phase 10 (threading.excepthook)
THREAD_ERRORS = []
# 9a's final map, for 10c
FINAL_MAPS = {}
LOOP_ASYNC_GATES = dict(tracked=0.7, loops=1, gba=1, ate_m=0.30)
# 10a feeds the first 40 of phase 6's 60 frames, for the whole script's
# time, and compares with phase 6's record of the same 40 frames
ASYNC_FEED = 40
RESUME_GATES = dict(localised=5, of=10)


def _watch_threads():
    """Record every exception a thread raises (and still print it)."""
    prev = threading.excepthook

    def hook(args):
        name = args.thread.name if args.thread is not None else "?"
        THREAD_ERRORS.append(f"{name}: {args.exc_type.__name__}: "
                             f"{args.exc_value}")
        prev(args)

    threading.excepthook = hook
    return prev


def _stats(ms):
    ms = [float(x) for x in ms]
    return dict(n=len(ms), median=float(np.median(ms)) if ms else None,
                p90=float(np.percentile(ms, 90)) if ms else None)


def _mono_gates(slam, poses, ts, C, gates):
    """test_mono_end_to_end's gates on a System run; (record, failures)."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import tracking
    from orb_slam3_detailed_comments_tpu_torch.utils import evaluate_ate
    n = len(poses)
    tracked = sum(p is not None for p in poses)
    rows = slam.trajectory_tum()
    rmse, n_ate, scale = evaluate_ate.ate_rmse(
        ts[:n], C[:n], np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    errs = slam.check_map_consistency()
    last = int((slam.get_tracked_map_points() >= 0).sum())
    rec = dict(tracked=tracked, keyframes=slam.n_keyframes,
               points=slam.n_map_points, state=slam.get_tracking_state(),
               last_tracked=last, consistency=errs, rows=len(rows),
               ate_m=rmse, ate_poses=n_ate, ate_scale=scale)
    fails = [name for name, bad in (
        ("frames tracked", tracked <= gates["tracked"] * n),
        ("keyframes", slam.n_keyframes < gates["min_kf"]),
        ("map points", slam.n_map_points <= gates["min_points"]),
        ("final state", rec["state"] != tracking.OK or slam.is_lost()),
        ("last frame's map points", last <= gates["last_tracked"]),
        ("map consistency", errs != []),
        ("trajectory rows", len(rows) <= gates["rows"] * n),
        ("ATE", not (n_ate > gates["ate_poses"] * n
                     and rmse < gates["ate_m"]))) if bad]
    return rec, fails


def time_part(parts, obj, name, label, sync=lambda: None):
    """Patch obj.name to add its host ms (between sync() calls) to
    parts[label]; returns the undo."""
    real = getattr(obj, name)

    def timed(*a, **k):
        sync()
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            sync()
            parts[label] = parts.get(label, 0.0) + 1e3 * (
                time.perf_counter() - t0)
    setattr(obj, name, timed)
    return lambda: setattr(obj, name, real)


def timed_system_run(slam, frames, ts, dev, profile_at=None):
    """Feed a System its frames with the counts at 0 just before; each
    frame's host clock, whether it made a keyframe (the tracker queued one)
    and took the fused step; the frame profile_at (if steady) under
    torch.profiler: the kernels of every stream in its window. Ends with
    shutdown() (the worker and a racing global BA drained); returns
    (poses, times, kf_frames, steady, launches, n_fuse, busy)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync = torch_sync(dev)
    tk, lm = slam.tracker, slam.local_mapper
    n_fuse = [0]
    process, post = lm.process_keyframe, slam._post_track
    made_kf = []

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event.get("fuse_searches", 0)

    def post_track(pose, t_=0.0):
        made_kf.append(bool(tk.new_keyframes))
        return post(pose, t_)

    lm.process_keyframe, slam._post_track = counted, post_track
    poses, times, steady, busy = [], [], [], None
    reset_counts()
    for i, (img, t) in enumerate(zip(frames, ts)):
        steps0, ref0 = tk.n_steps, tk.n_ref_kf_searches
        prof = None
        if i == profile_at and dev.type == "cuda":
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        sync()
        t0 = time.perf_counter()
        poses.append(slam.track_monocular(img, float(t)))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            prof.__exit__(None, None, None)
            d_ms = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3
            busy = dict(frame=i, device_ms=d_ms, host_ms_profiled=times[-1])
        if (poses[-1] is not None and tk.n_steps > steps0
                and tk.n_ref_kf_searches == ref0 and not made_kf[-1]
                and i != profile_at):
            steady.append(i)
    slam.shutdown()
    launches = dict(native.launches)
    lm.process_keyframe = process
    slam.__dict__.pop("_post_track", None)
    kf_frames = [i for i, k in enumerate(made_kf) if k]
    return poses, times, kf_frames, steady, launches, n_fuse[0], busy


def async_mono_path(dev, sync_rec=None, cam_kw=CAM_KW, n_frames=N_SYS,
                    world_seed=7, map_cfg=None, track_cfg=None,
                    gates=SYS_GATES, profile_at=50):
    """10a: System(cam, MONOCULAR, async_mapping=True) at its defaults on
    the first n_frames of phase 6's case, every thread on the default
    stream, held to test_mono_end_to_end's gates with exact launch counts;
    the host clock of steady and keyframe frames beside the synchronous
    System's over the same frames (phase 6's record of this call, or a
    synchronous run here when phase 6 did not run); the backpressure
    waits; the device busy share of one profiled steady frame (all
    streams)."""
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(60)
    frames = [render_host(cam, planes, R[i], t[i], dev)
              for i in range(n_frames)]
    C = sr.camera_centers(R, t)
    ts = 0.05 * np.arange(len(C))
    kw = dict(device=dev)
    if map_cfg is not None:
        kw["map_cfg"] = map_cfg
    if track_cfg is not None:
        kw["tracking_cfg"] = track_cfg
    out = {}
    modes = ("async",) if sync_rec is not None else ("sync", "async")
    for mode in modes:
        slam = system.System(cam, system.MONOCULAR,
                             async_mapping=mode != "sync", **kw)
        poses, times, kf_frames, steady, launches, n_fuse, busy = \
            timed_system_run(slam, frames, ts, dev,
                             profile_at if mode != "sync" else None)
        expect = expected_launches(slam.tracker, n_frames, n_fuse)
        rec, fails = _mono_gates(slam, poses, ts, C, gates)
        st = _stats([times[i] for i in steady])
        kf = _stats([times[i] for i in kf_frames])
        rec.update(mode=mode, launches=launches, expected=expect,
                   frame_ms_median=st["median"], frame_ms_p90=st["p90"],
                   n_steady=st["n"], kf_frame_ms_median=kf["median"],
                   kf_frame_ms_p90=kf["p90"], n_kf_frames=kf["n"],
                   kf_frame_ms=[round(times[i], 2) for i in kf_frames],
                   steady_frame_ms=[round(times[i], 2) for i in steady],
                   backpressure_waits=slam.n_backpressure_waits,
                   loops_closed=slam.loop_closer.n_loops_closed,
                   gba_log=list(slam.loop_closer.gba_log))
        if busy is not None and st["median"]:
            busy["busy_share"] = busy["device_ms"] / st["median"]
            rec["busy"] = busy
        out[mode] = rec
        log(f"10a {mode}: {rec['tracked']}/{n_frames} tracked, "
            f"{rec['keyframes']} KF, {rec['points']} points, ATE "
            f"{rec['ate_m']:.5f} m over {rec['ate_poses']}; steady frames "
            f"median {st['median']:.2f} ms p90 {st['p90']:.2f} over "
            f"{st['n']}; keyframe frames median {kf['median']:.2f} p90 "
            f"{kf['p90']:.2f} over {kf['n']}; backpressure waits "
            f"{slam.n_backpressure_waits}; busy {busy}; launches {launches}")
        if fails:
            raise AssertionError(f"10a {mode} missed the gates: {fails}: "
                                 f"{rec}")
        if dev.type == "cuda":
            for k, want in expect.items():
                if launches[k] != want or want == 0:
                    raise AssertionError(f"10a {mode}: {k}: {launches[k]} "
                                         f"launches, expected {want}")
    if sync_rec is not None:
        # phase 6's record over the same frames as this run
        st_ref = [v for i, v in sync_rec["steady_frame_ms"].items()
                  if i < n_frames]
        kf_ref = [v for i, v in sync_rec["kf_frame_ms"].items()
                  if i < n_frames]
        source = f"phase 6, its first {n_frames} frames"
    else:
        ref = out.pop("sync")
        st_ref, kf_ref = ref["steady_frame_ms"], ref["kf_frame_ms"]
        source = "10a"
    out["sync"] = dict(source=source, n_steady=len(st_ref),
                       frame_ms_median=float(np.median(st_ref)),
                       frame_ms_p90=float(np.percentile(st_ref, 90)),
                       n_kf_frames=len(kf_ref),
                       kf_frame_ms_median=float(np.median(kf_ref)),
                       kf_frame_ms_p90=float(np.percentile(kf_ref, 90)))
    log(f"10a: synchronous ({out['sync']['source']}) steady median "
        f"{out['sync']['frame_ms_median']:.2f} p90 "
        f"{out['sync']['frame_ms_p90']:.2f} ms over {out['sync']['n_steady']}, "
        f"keyframe frames median {out['sync']['kf_frame_ms_median']:.2f} p90 "
        f"{out['sync']['kf_frame_ms_p90']:.2f} ms over "
        f"{out['sync']['n_kf_frames']}")
    out["launches"] = out["async"]["launches"]
    return out


def _capture_worker_searches(slam, keep):
    """Wrap the two best-2 searches: the first call of each from the
    mapping worker keeps its inputs, outputs and stream. Returns undo."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import hamming
    undo = []
    for name in ("hamming_best2", "hamming_best2_windowed"):
        real = getattr(hamming, name)

        def wrapped(*args, _real=real, _name=name):
            out = _real(*args)
            if (threading.current_thread() is slam._worker
                    and _name not in keep):
                dev = args[0].device
                on = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                      else None)
                if on is not None:
                    on.synchronize()
                keep[_name] = dict(
                    args=[a.clone() for a in args],
                    out=[o.clone() for o in out],
                    stream=None if on is None else (
                        "default" if on == torch.cuda.default_stream(dev)
                        else "own"))
            return out

        setattr(hamming, name, wrapped)
        undo.append(lambda n=name, r=real: setattr(hamming, n, r))
    return lambda: [u() for u in undo]


def async_loop_path(dev, cam_kw=LOOP_CAM_KW, n_frames=140,
                    gates=LOOP_ASYNC_GATES, map_cfg=None, track_cfg=None,
                    n_feed=None):
    """10b: phase 8a's loop with async_mapping=True (the worker and the
    racing global BA on the default stream), its first n_feed frames where
    given (the gates and the ATE then over those):
    test_async_loop_closure_with_racing_gba's gates (> 70 % tracked, >= 1
    loop, runs + aborts of the global BA >= 1, scale-aligned ATE < 0.30 m,
    a consistent map after shutdown()), exact launch counts; the host clock
    of the frames that made a closing keyframe and of the frames tracked
    while a correction ran, against 8a's; each global BA's time on its
    thread and camera count; the first fuse search and the first Sim3
    match search that the worker launched on its stream, held against
    their plain versions on the same inputs."""
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import hamming
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        loop_closing, system)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr)
    cam = cameras.pinhole(**cam_kw)
    walls = sr.box_world(np.random.default_rng(11))
    R, t = sr.loop_trajectory(n_frames, radius=3.0, closes=1.05)
    n_frames = n_feed or n_frames
    R, t = R[:n_frames], t[:n_frames]
    frames = [sr.render_image(cam, walls, R[i], t[i], dev)
              for i in range(n_frames)]
    ts = 0.05 * np.arange(n_frames)
    kw = dict(device=dev)
    if map_cfg is not None:
        kw["map_cfg"] = map_cfg
    if track_cfg is not None:
        kw["tracking_cfg"] = track_cfg
    slam = system.System(cam, system.MONOCULAR, async_mapping=True, **kw)
    corrections, keep, parts = [], {}, {}
    build = slam._build_recognition

    def part(obj, name, label):
        return time_part(parts, obj, name, label)

    # a correction's parts (module functions, patched for this run)
    undo_parts = [part(loop_closing, "_chain_covis_edges", "edges"),
                  part(loop_closing, "_solve_essential_graph",
                       "essential graph"),
                  part(loop_closing, "_apply_pose_graph", "apply graph")]

    def build_hooked(*a, **k):
        build(*a, **k)
        lc = slam.loop_closer
        correct = lc._correct_loop
        part(lc, "_fuse_loop_points", "loop fuse")
        part(lc, "_launch_global_ba", "GBA launch")
        part(lc.map, "update_point_stats", "point stats")

        def logged(k_, c, S):
            parts.clear()
            t0 = time.perf_counter()
            out = correct(k_, c, S)
            corrections.append(dict(k=int(k_), c=int(c), closed=bool(out),
                                    frame=int(lc.map.kf_frame_id[k_]),
                                    start=t0, end=time.perf_counter(),
                                    n_kf=int(lc.map.n_kf),
                                    parts_ms={k2: round(v, 1)
                                              for k2, v in parts.items()}))
            return out
        lc._correct_loop = logged

    slam._build_recognition = build_hooked
    undo = _capture_worker_searches(slam, keep)
    starts = []
    n_lc = len(span_ms("loop correction"))
    real_track = slam.track_monocular

    def stamped(img, t_):
        starts.append(time.perf_counter())
        return real_track(img, t_)

    slam.track_monocular = stamped
    try:
        poses, times, kf_frames, steady, launches, n_fuse, _ = \
            timed_system_run(slam, frames, ts, dev)
    finally:
        undo()
        for u in undo_parts:
            u()
        slam.__dict__.pop("track_monocular", None)
    expect = expected_launches(slam.tracker, n_frames, n_fuse)
    lc = slam.loop_closer
    rows = slam.trajectory_tum()
    rmse, n_ate, scale = evaluate_ate.ate_rmse(
        ts, sr.camera_centers(R, t), np.array([r[0] for r in rows]),
        np.array([r[1:4] for r in rows]))
    errs = slam.check_map_consistency()
    n_ok = sum(p is not None for p in poses)
    ends = [s + ms / 1e3 for s, ms in zip(starts, times)]
    for c in corrections:
        c["frame_ms"] = times[c["frame"]] if c["frame"] < len(times) else None
        during = [times[i] for i in range(n_frames)
                  if starts[i] < c["end"] and ends[i] > c["start"]]
        c["overlapping_frames"] = len(during)
        c["max_overlapping_frame_ms"] = max(during) if during else None
        c["ms"] = 1e3 * (c.pop("end") - c.pop("start"))
    rec = dict(tracked=n_ok, keyframes=slam.n_keyframes,
               loops_closed=lc.n_loops_closed, gba_runs=lc.n_gba_runs,
               gba_aborted=lc.n_gba_aborted, gba_log=list(lc.gba_log),
               corrections=corrections, ate_m=rmse, ate_poses=n_ate,
               ate_scale=scale, consistency=errs, launches=launches,
               expected=expect,
               loop_correction_ms=span_ms("loop correction", n_lc),
               frame_ms=_stats(times), steady=_stats([times[i]
                                                      for i in steady]),
               kf_frames=_stats([times[i] for i in kf_frames]),
               backpressure_waits=slam.n_backpressure_waits)
    log(f"10b async loop: {n_ok}/{n_frames} tracked, {slam.n_keyframes} KF, "
        f"{lc.n_loops_closed} loops closed, global BA {lc.n_gba_runs} "
        f"applied / {lc.n_gba_aborted} aborted; GBAs "
        + "; ".join(f"{g['kind']} C={g['C']} {g['seconds'] * 1e3:.1f} ms "
                    f"{'applied' if g['applied'] else 'aborted'}"
                    for g in lc.gba_log)
        + f"; corrections (worker thread): "
        + "; ".join(f"KF {c['k']} of frame {c['frame']} -> {c['c']} at "
                    f"{c['n_kf']} KF: {c['ms']:.1f} ms ({c['parts_ms']}), "
                    f"that frame {c['frame_ms']} ms, "
                    f"{c['overlapping_frames']} frames during it, the "
                    f"longest {c['max_overlapping_frame_ms']} ms"
                    for c in corrections)
        + f"; ATE {rmse:.5f} m over {n_ate} (scale {scale:.4f}); "
        f"consistency {errs}; frames {rec['frame_ms']}, steady "
        f"{rec['steady']}, keyframe frames {rec['kf_frames']}; "
        f"backpressure waits {slam.n_backpressure_waits}; launches "
        f"{launches}")
    fails = [name for name, bad in (
        ("frames tracked", n_ok <= gates["tracked"] * n_frames),
        ("loops closed", lc.n_loops_closed < gates["loops"]),
        ("global BA", lc.n_gba_runs + lc.n_gba_aborted < gates["gba"]),
        ("ATE", not rmse < gates["ate_m"]),
        ("map consistency", errs != [])) if bad]
    if fails:
        raise AssertionError(f"10b missed the gates: {fails}: {rec}")
    if dev.type == "cuda":
        for k, want in expect.items():
            if launches[k] != want or want == 0:
                raise AssertionError(f"10b: {k}: {launches[k]} launches, "
                                     f"expected {want}")
    plain = dict(hamming_best2=hamming.hamming_best2_plain,
                 hamming_best2_windowed=hamming.hamming_best2_windowed_plain)
    rec["worker_searches"] = {}
    for name, fn in plain.items():
        if name not in keep:
            raise AssertionError(f"10b: the worker launched no {name}")
        got, args = keep[name]["out"], keep[name]["args"]
        ref = fn(*args)
        equal = all(bool((a == b).all()) for a, b in zip(got, ref))
        rec["worker_searches"][name] = dict(
            queries=int(args[0].shape[0]), stream=keep[name]["stream"],
            equal=equal)
        if not equal:
            raise AssertionError(f"10b: {name} from the worker: "
                                 f"{rec['worker_searches'][name]}")
    log(f"10b: the worker's searches against their plain versions: "
        f"{rec['worker_searches']}")
    return rec


def chain_residual(m, calib):
    """The largest 9-dof preintegration residual along the map's temporal
    chain at its current states."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.imu import factors
    from orb_slam3_detailed_comments_tpu_torch.imu import preintegration
    from orb_slam3_detailed_comments_tpu_torch.pipeline import inertial
    chain = [int(k) for k in m.temporal_chain()]
    R_bc, t_bc = inertial.extrinsic(calib)
    g = torch.tensor([0.0, 0.0, -inertial.GRAVITY_MAG], dtype=torch.float64)
    worst = 0.0
    for a, b in zip(chain[:-1], chain[1:]):
        if m.kf_prev[b] != a or m.kf_pre_dT[b] <= 0:
            continue
        pre = preintegration.index(m.get_kf_preintegration([b]), 0)
        pre = preintegration.Preintegrated(*[x.cpu().double() for x in pre])
        (R_i, p_i), (R_j, p_j) = (inertial.body_from_camera(
            m.kf_R[k], m.kf_t[k], R_bc, t_bc) for k in (a, b))
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64))
        r = factors.inertial_residual(
            f(R_i), f(p_i), f(m.kf_vel[a]), f(R_j), f(p_j), f(m.kf_vel[b]),
            f(m.kf_bg[a]), f(m.kf_ba[a]), pre, g)
        worst = max(worst, float(r.abs().max()))
    return worst


# 10c: the temporal chain's largest preintegration residual after the JAX
# package's racing inertial global BA of 9a's final map (0.0035201609
# before), on the CPU: replay_card_map of tests/test_torch_async.py on the
# map that 10c exports; the port's solve is held to it within JAX_10C_MARGIN.
# 9a's map is the one built since the points' descriptors take the upper
# middle distance (ROADMAP fault 3.1)
JAX_10C_RESIDUAL_AFTER = 0.005968302488327026
JAX_10C_MARGIN = 0.05


def inertial_gba_path(dev, snap, tol=1e-3, reduce=0.25, vel_noise=0.4):
    """10c: the racing inertial global BA on a copy of 9a's final map (IMU
    initialised), on the card and on the CPU: launched and waited for, one
    run applied, the velocities changed, every state finite, the card's
    states within tol of the CPU's, and the chain's preintegration residual
    after the solve within JAX_10C_MARGIN of the JAX package's on the same
    map (on this converged map the solve, at zero bias priors as in the JAX
    package, trades that residual against the visual terms: it rises from
    its value before in both packages). Then
    test_post_loop_inertial_gba_reconciles_velocities' gate on a copy whose
    velocities are perturbed by N(0, vel_noise) m/s but the gauge
    keyframe's: the residual falls below reduce x its value before. Then a
    long run (gba_iters=400, gba_chunk=1) aborted at once: counted, poses
    and velocities equal to the bit."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.imu.preintegration import (
        ImuCalib)
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    cam = cameras.pinhole(**snap["cam_kw"])
    calib = ImuCalib.default()
    state = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")

    def solve(where, perturb=False):
        d = dev if where != "cpu" else torch.device("cpu")
        m = MapStore.from_numpy(snap["map"], snap["cfg"], device=d)
        if perturb:
            chain = m.temporal_chain()[1:]
            m.kf_vel[chain] += np.random.default_rng(0).normal(
                0, vel_noise, (len(chain), 3)).astype(np.float32)
        r0 = chain_residual(m, calib)
        v0 = m.kf_vel.copy()
        lc = loop_closing.LoopCloser(m, cam, None,
                                     loop_closing.LoopClosingConfig(
                                         async_gba=True))
        lc.map_lock, lc.imu_calib = threading.RLock(), calib
        window = [int(k) for k in m.kf_ids()]
        lc._launch_global_ba(window, window[:1])
        lc.wait_gba()
        finite = all(np.isfinite(getattr(m, f)).all() for f in state) and \
            np.isfinite(m.pt_xyz).all()
        r = dict(runs=lc.n_gba_runs, aborted=lc.n_gba_aborted,
                 residual_before=r0, residual_after=chain_residual(m, calib),
                 vel_changed=bool((m.kf_vel != v0).any()),
                 finite=bool(finite), gba=lc.gba_log[-1])
        log(f"10c {where}: {r}")
        return m, lc, r

    (mc, lc, rec_card), (mp, _, rec_cpu) = solve("card"), solve("cpu")
    _, _, rec_pert = solve("card, velocities perturbed", perturb=True)
    rec = dict(card=rec_card, cpu=rec_cpu, perturbed=rec_pert)
    rec["card_vs_cpu"] = {f: float(np.abs(getattr(mc, f)
                                          - getattr(mp, f)).max())
                          for f in state}
    log(f"10c card against CPU (largest difference): {rec['card_vs_cpu']}")
    before = {f: getattr(mc, f).copy() for f in ("kf_t", "kf_vel")}
    lc.cfg.gba_iters, lc.cfg.gba_chunk = 400, 1
    window = [int(k) for k in mc.kf_ids()]
    lc._launch_global_ba(window, window[:1])
    lc.abort_gba()
    rec["abort"] = dict(aborted=lc.n_gba_aborted, runs=lc.n_gba_runs,
                        unchanged=all(np.array_equal(getattr(mc, f), a)
                                      for f, a in before.items()))
    log(f"10c abort: {rec['abort']}")
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    # the map, for replaying this solve off the card
    cfg = snap["cfg"]
    np.savez_compressed(out_dir / "map_9a.npz", **{
        k: v for k, v in snap["map"].items() if isinstance(v, np.ndarray)},
        imu_flags=np.asarray([snap["map"][f] for f in (
            "imu_initialized", "imu_ba1", "imu_ba2")]),
        map_cfg=np.asarray([cfg.max_kf, cfg.max_pt, cfg.n_feat,
                            cfg.n_levels]), cam=np.asarray([
                                snap["cam_kw"][k] for k in (
                                    "fx", "fy", "cx", "cy", "width",
                                    "height")], np.float64))
    fails = []
    for where, r in (("card", rec_card), ("cpu", rec_cpu)):
        if not (r["runs"] == 1 and r["vel_changed"] and r["finite"]):
            fails.append(f"{where}: {r}")
        if abs(r["residual_after"] / JAX_10C_RESIDUAL_AFTER
               - 1) > JAX_10C_MARGIN:
            fails.append(f"{where}: chain residual {r['residual_before']} -> "
                         f"{r['residual_after']}, the JAX package's -> "
                         f"{JAX_10C_RESIDUAL_AFTER} (within "
                         f"{JAX_10C_MARGIN:.0%}; if 9a's map changed, "
                         f"replay its export with tests/test_torch_async.py)")
    if max(rec["card_vs_cpu"].values()) > tol:
        fails.append(f"card and CPU part: {rec['card_vs_cpu']}")
    if not (rec_pert["runs"] == 1 and rec_pert["residual_after"]
            < reduce * rec_pert["residual_before"]):
        fails.append(f"perturbed: {rec_pert}")
    if not (lc.n_gba_aborted >= 1 and lc.n_gba_runs == 1
            and rec["abort"]["unchanged"]):
        fails.append(f"abort: {rec['abort']}")
    rec["failed"] = fails
    return rec


def _atlas_equal(a, b):
    """Every array of the checkpoint format, IMU flag and capacity of two
    Atlases equal."""
    from orb_slam3_detailed_comments_tpu_torch.utils import serialization
    if len(a.maps) != len(b.maps) or a.active_id != b.active_id:
        return False
    for ma, mb in zip(a.maps, b.maps):
        if not all(np.array_equal(getattr(ma, k), getattr(mb, k))
                   for k in serialization._MAP_ARRAYS):
            return False
        if ((ma.imu_initialized, ma.imu_ba1, ma.imu_ba2)
                != (mb.imu_initialized, mb.imu_ba1, mb.imu_ba2)):
            return False
    return True


def settings_path(dev, cam_kw=CAM_KW, n=30, world_seed=7,
                  gates=RESUME_GATES, map_cfg=None, track_cfg=None,
                  n_orbit=None):
    """10d: System.from_settings on the card for every shipped settings
    file (EuRoC.yaml as IMU_STEREO with test_from_settings_wires_configs'
    checks); save_atlas after a 30-frame run (world seed 7, the case of
    test_localize_against_loaded_atlas), load_atlas into a fresh card
    System (every array equal), then that test's gates in localisation
    mode; warmup() on a fresh card System (no nvcc build after it) and the
    host clock of its first frames beside a steady frame's. n_orbit: the
    orbit's length, of which the first n frames are fed (n by default)."""
    import tempfile
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        system, tracking)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        config, synth_render as sr)
    rec = {}
    cfg_dir = REPO / "examples" / "config"
    built = {}
    for f in sorted(cfg_dir.glob("*.yaml")):
        s = config.load_settings(str(f))
        slam = system.System.from_settings(s, system.MONOCULAR, device=dev)
        built[f.name] = dict(n_features=slam.tracker.orb_cfg.n_features,
                             width=slam.cam.width,
                             device=str(slam.map.device))
    s = config.load_settings(str(cfg_dir / "EuRoC.yaml"))
    slam = system.System.from_settings(s, system.IMU_STEREO, device=dev)
    n_pad = int(np.ceil(s.n_features / 128.0)) * 128
    wired = dict(
        n_features=slam.tracker.orb_cfg.n_features == n_pad,
        n_levels=slam.tracker.orb_cfg.n_levels == s.n_levels,
        scale=abs(slam.tracker.orb_cfg.scale - s.scale_factor) < 1e-9,
        max_frames=slam.tracker.cfg.max_frames == int(round(s.fps)),
        map_n_feat=slam.map.cfg.n_feat == n_pad,
        imu=slam.tracker.imu is not None and abs(
            slam.tracker.imu.calib.noise_gyro - s.imu_noise_gyro) < 1e-12,
        ref_ratio=slam.tracker.cfg.ref_ratio == 0.75)
    rec["from_settings"] = dict(built=built, euroc_imu_stereo=wired)
    log(f"10d from_settings on the card: {built}; EuRoC IMU_STEREO {wired}")
    if len(built) != 8 or not all(wired.values()) or any(
            b["device"] != str(dev) and dev.type == "cuda"
            for b in built.values()):
        raise AssertionError(f"10d from_settings: {rec['from_settings']}")

    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(n_orbit or n)
    frames = [sr.render_image(cam, planes, R[i], t[i], dev)
              for i in range(n)]
    kw = dict(device=dev)
    if map_cfg is not None:
        kw["map_cfg"] = map_cfg
    if track_cfg is not None:
        kw["tracking_cfg"] = track_cfg
    slam = system.System(cam, system.MONOCULAR, **kw)
    for i in range(n):
        slam.track_monocular(frames[i], 0.05 * i)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "session.zip")
        slam.save_atlas(path)
        size = Path(path).stat().st_size
        slam2 = system.System(cam, system.MONOCULAR, **kw)
        slam2.load_atlas(path)
    equal = _atlas_equal(slam.atlas, slam2.atlas)
    slam2.activate_localization_mode()
    slam2._build_recognition()
    for kk in slam2.map.kf_ids():
        slam2.kfdb.add(kk, slam2.map.kf_feat_desc[kk],
                       slam2.map.kf_feat_valid[kk])
    n_kf = slam2.map.n_kf
    ok = sum(slam2.track_monocular(frames[i], 100.0 + 0.05 * i) is not None
             for i in range(10, 10 + gates["of"]))
    rec["atlas"] = dict(keyframes=int(slam.map.n_kf), bytes=size,
                        arrays_equal=equal, localised=ok, of=gates["of"],
                        keyframes_frozen=slam2.map.n_kf == n_kf)
    log(f"10d atlas round trip: {rec['atlas']}")
    if not (slam.map.n_kf >= 3 and equal and ok >= gates["localised"]
            and slam2.map.n_kf == n_kf):
        raise AssertionError(f"10d atlas: {rec['atlas']}")

    builds0 = native.n_builds
    fresh = system.System(cam, system.MONOCULAR, **kw)
    t0 = time.perf_counter()
    fresh.warmup()
    warm_s = time.perf_counter() - t0
    untouched = (fresh.map.n_kf == 0
                 and fresh.get_tracking_state() == tracking.NO_IMAGES_YET)
    sync = torch_sync(dev)
    times = []
    for i in range(12):
        sync()
        t1 = time.perf_counter()
        fresh.track_monocular(frames[i], 0.05 * i)
        sync()
        times.append((time.perf_counter() - t1) * 1e3)
    rec["warmup"] = dict(seconds=warm_s, untouched=untouched,
                         builds=native.n_builds - builds0,
                         first_frames_ms=[round(x, 2) for x in times[:5]],
                         later_frames_ms_median=float(np.median(times[8:])))
    log(f"10d warmup: {rec['warmup']}")
    if not untouched or native.n_builds != builds0:
        raise AssertionError(f"10d warmup: {rec['warmup']}")
    return rec


# ---------------------------------------------------------------- phase 12
# the host surfaces: tests/test_examples_cli.py's world at 752x480, written
# by the port's PNG writer in the reference layouts and run through the
# dataset entry points' main(argv) on the card, each held to its JAX CLI
# test's gates. The frames are the first 16 of a 24-frame orbit: on the
# port's ray-cast frames the JAX test's own 16-frame orbit reads a
# monocular ATE of 0.0511 m in the port and 0.0513 m in the JAX package
# (both on the CPU), over the 0.05 m gate in both; that test's frames come
# from the JAX package's OpenCV warp renderer, which the card's machine
# lacks. The first 16 of 24 read 0.0076 m on the CPU.
P12_FRAMES = 16
P12_ORBIT = 24
P12_GATES = dict(mono_rows=1.2, mono_first=0.6, mono_ate_m=0.05,
                 rgbd_rows=0.8, rgbd_scale=0.05, rgbd_ate_m=0.05,
                 stereo_rows=0.6, stereo_ate_m=0.08, stereo_scale=0.05)
P12_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera.width: {width}
Camera.height: {height}
Camera.fps: 20
{extra}ORBextractor.nFeatures: 1024
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _p12_rectification(cam_kw, bf):
    """Legacy LEFT.* / RIGHT.* blocks of an identity rig (the case of
    test_stereo_euroc_cli_with_rectification)."""
    k = (f"[{cam_kw['fx']}, 0.0, {cam_kw['cx']}, 0.0, {cam_kw['fy']}, "
         f"{cam_kw['cy']}, 0.0, 0.0, 1.0]")
    mat = "!!opencv-matrix\n  rows: {r}\n  cols: {c}\n  dt: d\n  data: {d}\n"
    out = f"Camera.bf: {bf}\n"
    for side, tx in (("LEFT", 0.0), ("RIGHT", -bf)):
        P = (f"[{cam_kw['fx']}, 0.0, {cam_kw['cx']}, {tx}, 0.0, "
             f"{cam_kw['fy']}, {cam_kw['cy']}, 0.0, 0.0, 0.0, 1.0, 0.0]")
        out += (f"{side}.width: {cam_kw['width']}\n"
                f"{side}.height: {cam_kw['height']}\n"
                f"{side}.K: {mat.format(r=3, c=3, d=k)}"
                f"{side}.D: {mat.format(r=1, c=5, d='[0.0, 0.0, 0.0, 0.0, 0.0]')}"
                f"{side}.R: {mat.format(r=3, c=3, d='[1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]')}"
                f"{side}.P: {mat.format(r=3, c=4, d=P)}")
    return out


class _SystemsBuilt:
    """Keeps each System that System.from_settings builds meanwhile (the
    entry points build theirs inside main)."""

    def __enter__(self):
        from orb_slam3_detailed_comments_tpu_torch.pipeline import system
        self.cls, self.orig, self.built = system.System, None, []
        self.orig = system.System.__dict__["from_settings"]
        built, orig = self.built, self.orig

        def from_settings(cls, *a, **kw):
            slam = orig.__func__(cls, *a, **kw)
            built.append(slam)
            return slam

        system.System.from_settings = classmethod(from_settings)
        return self

    def __exit__(self, *exc):
        self.cls.from_settings = self.orig
        return False


def _p12_run(name, main, argv, dev):
    """One entry point's main(argv) with the counts at 0 just before:
    the System it built, its launches and its host seconds."""
    from orb_slam3_detailed_comments_tpu_torch import native
    sync = torch_sync(dev)
    with _SystemsBuilt() as sb:
        reset_counts()                       # this path's run starts here
        sync()
        t0 = time.perf_counter()
        rc = main([*map(str, argv), "--device", dev.type])
        sync()
        secs = time.perf_counter() - t0
        launches = dict(native.launches)     # ... and ends here
    if rc != 0 or len(sb.built) != 1:
        raise AssertionError(f"12 {name}: exit code {rc}, "
                             f"{len(sb.built)} Systems built")
    log(f"12 {name}: {secs:.1f} s, launches {launches}")
    return sb.built[0], launches, secs


def _p12_check_launches(name, launches, n_frames, extractions, sad, dev):
    """Extraction exactly once a frame (twice a stereo frame), the stereo
    SAD's one-image gathers twice a frame, and the projection search
    launched."""
    if dev.type != "cuda":
        return
    want = dict(dense_frontend=extractions * n_frames,
                cell_topk=extractions * n_frames,
                gather_patches=(extractions + sad) * n_frames)
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"12 {name}: {k} launched {launches[k]} "
                                 f"times, expected {v}")
    for k in ("hamming_best2_windowed",):
        if launches[k] == 0:
            raise AssertionError(f"12 {name}: {k} never launched")


def host_surfaces_path(dev, cam_kw=CAM_KW, n=P12_FRAMES, n_orbit=P12_ORBIT,
                       gates=P12_GATES):
    """Phase 12: three synthetic directories written with the port's PNG
    writer (a 16-frame EuRoC mav0 sequence, a TUM RGB-D directory with
    16-bit depth, a EuRoC stereo directory with LEFT.* / RIGHT.* blocks),
    read back bit for bit, and run through mono_euroc (the sequence twice),
    rgbd_tum and stereo_euroc's main(argv) on dev with the gates of their
    JAX CLI tests; the median PNG decode time a frame and rectify time a
    pair on the host."""
    import shutil
    from orb_slam3_detailed_comments_tpu_torch.examples import (
        mono_euroc, rgbd_tum, stereo_euroc)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        config, datasets, evaluate_ate, png, synth_render as sr)
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(4))
    R, t = sr.orbit_trajectory(n_orbit)
    R, t = R[:n], t[:n]
    C = sr.camera_centers(R, t)
    ts = 1 + np.arange(n) * 0.05
    root = REPO / "build" / "phase12"
    shutil.rmtree(root, ignore_errors=True)
    written = {}

    def put(path, img):
        path.parent.mkdir(parents=True, exist_ok=True)
        png.write_png(str(path), img)
        written[path] = img

    u8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)
    rgb_l, d_l = [], []
    t0 = time.perf_counter()
    for i in range(n):
        ns = int(round(1e9 * ts[i]))
        img, depth = render_host_depth(cam, planes, R[i], t[i], dev)
        right = render_host(cam, planes, R[i],
                            sr.stereo_right_t(R[i], t[i], BASELINE), dev)
        put(root / "mono" / "mav0" / "cam0" / "data" / f"{ns}.png", u8(img))
        put(root / "stereo" / "mav0" / "cam0" / "data" / f"{ns}.png",
            u8(img))
        put(root / "stereo" / "mav0" / "cam1" / "data" / f"{ns}.png",
            u8(right))
        put(root / "tum" / "rgb" / f"{ts[i]:.6f}.png", u8(img))
        put(root / "tum" / "depth" / f"{ts[i]:.6f}.png",
            np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
        rgb_l.append(f"{ts[i]:.6f} rgb/{ts[i]:.6f}.png")
        d_l.append(f"{ts[i]:.6f} depth/{ts[i]:.6f}.png")
    (root / "tum" / "rgb.txt").write_text("# ts f\n" + "\n".join(rgb_l)
                                          + "\n")
    (root / "tum" / "depth.txt").write_text("# ts f\n" + "\n".join(d_l)
                                            + "\n")
    rec = dict(write_s=time.perf_counter() - t0, n_files=len(written))
    # read-back: every file bit for bit; decode time a frame (grey 8-bit)
    bad = [str(p) for p, img in written.items()
           if not np.array_equal(png.imread_unchanged(str(p)), img)]
    if bad:
        raise AssertionError(f"12: {len(bad)} PNGs read back otherwise: "
                             f"{bad[:3]}")
    grey = sorted((root / "mono" / "mav0" / "cam0" / "data").iterdir())
    dec = []
    for p in grey:
        t0 = time.perf_counter()
        datasets.read_gray(str(p))
        dec.append((time.perf_counter() - t0) * 1e3)
    rec["png_decode_ms"] = float(np.median(dec))
    y = root / "mono" / "s.yaml"
    y.write_text(P12_YAML.format(extra="", **cam_kw))
    (root / "tum" / "s.yaml").write_text(P12_YAML.format(
        extra="RGBD.DepthMapFactor: 5000.0\nStereo.ThDepth: 40.0\n"
              "Stereo.b: 0.08\n", **cam_kw))
    (root / "stereo" / "s.yaml").write_text(P12_YAML.format(
        extra=_p12_rectification(cam_kw, cam_kw["fx"] * BASELINE),
        **cam_kw))
    maps = config.stereo_rectify_maps(config.load_settings(
        str(root / "stereo" / "s.yaml")))
    pair = [datasets.read_gray(str(p)) for p in (
        grey[0], root / "stereo" / "mav0" / "cam1" / "data" / grey[0].name)]
    rect = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = (config.rectify(pair[0], maps[0]),
               config.rectify(pair[1], maps[1]))
        rect.append((time.perf_counter() - t0) * 1e3)
    rec["rectify_pair_ms"] = float(np.median(rect))
    if not all(np.array_equal(a, b) for a, b in zip(out, pair)):
        raise AssertionError("12: the identity rig's rectification changed "
                             "the images")
    log(f"12 wrote {rec['n_files']} PNGs in {rec['write_s']:.1f} s, read "
        f"back bit for bit; PNG decode median {rec['png_decode_ms']:.2f} ms "
        f"a 752x480 grey frame, rectify median {rec['rectify_pair_ms']:.2f} "
        f"ms a pair (host)")

    g = gates
    # mono_euroc, the sequence twice (ChangeDataset between)
    out = root / "mono" / "traj.txt"
    slam, launches, secs = _p12_run(
        "mono_euroc", mono_euroc.main,
        [y, root / "mono", root / "mono", out], dev)
    FINAL_MAPS["12"] = dict(map=map_arrays(slam.map),
                            map_cfg=dataclasses.replace(slam.map.cfg))
    _p12_check_launches("mono_euroc", launches, 2 * n, 1, 0, dev)
    rows = np.loadtxt(out, ndmin=2)
    wraps = np.flatnonzero(np.diff(rows[:, 0]) < 0)
    first = rows[:wraps[0] + 1] if wraps.size else rows
    ate, _, scale = (evaluate_ate.ate_rmse(ts, C, first[:, 0], first[:, 1:4])
                     if len(first) > 2 else (np.inf, 0, 0.0))
    rec["mono"] = dict(rows=len(rows), first_pass=len(first), ate_m=ate,
                       scale=scale, seconds=secs, launches=launches,
                       maps=len(slam.atlas.maps))
    log(f"12 mono_euroc: {len(rows)} rows, first pass {len(first)}/{n}, "
        f"ATE {ate:.5f} m (scale {scale:.3f}), {len(slam.atlas.maps)} maps")
    fails = [k for k, bad in (
        ("rows", not len(rows) > g["mono_rows"] * n),
        ("first pass", not len(first) > g["mono_first"] * n),
        ("ATE", not ate < g["mono_ate_m"])) if bad]
    # rgbd_tum
    out = root / "tum" / "traj.txt"
    slam, launches, secs = _p12_run(
        "rgbd_tum", rgbd_tum.main, [root / "tum" / "s.yaml", root / "tum",
                                    out], dev)
    _p12_check_launches("rgbd_tum", launches, n, 1, 0, dev)
    rows = np.loadtxt(out, ndmin=2)
    ate, _, scale = (evaluate_ate.ate_rmse(ts, C, rows[:, 0], rows[:, 1:4])
                     if len(rows) > 2 else (np.inf, 0, 0.0))
    rec["rgbd"] = dict(rows=len(rows), ate_m=ate, scale=scale, seconds=secs,
                       launches=launches)
    log(f"12 rgbd_tum: {len(rows)}/{n} rows, ATE {ate:.5f} m, scale "
        f"{scale:.4f}")
    fails += [k for k, bad in (
        ("rgbd rows", not len(rows) > g["rgbd_rows"] * n),
        ("rgbd scale", not abs(scale - 1.0) < g["rgbd_scale"]),
        ("rgbd ATE", not ate < g["rgbd_ate_m"])) if bad]
    # stereo_euroc with the legacy rectification blocks
    out = root / "stereo" / "traj.txt"
    slam, launches, secs = _p12_run(
        "stereo_euroc", stereo_euroc.main,
        [root / "stereo" / "s.yaml", root / "stereo", out], dev)
    _p12_check_launches("stereo_euroc", launches, n, 2, 2, dev)
    rows = np.loadtxt(out, ndmin=2)
    ate, _, scale = (evaluate_ate.ate_rmse(ts, C, rows[:, 0], rows[:, 1:4])
                     if len(rows) > 2 else (np.inf, 0, 0.0))
    rec["stereo"] = dict(rows=len(rows), ate_m=ate, scale=scale,
                         seconds=secs, launches=launches)
    log(f"12 stereo_euroc: {len(rows)}/{n} rows, ATE {ate:.5f} m, scale "
        f"{scale:.4f}")
    fails += [k for k, bad in (
        ("stereo rows", not len(rows) > g["stereo_rows"] * n),
        ("stereo ATE", not ate < g["stereo_ate_m"]),
        ("stereo scale", not abs(scale - 1.0) < g["stereo_scale"])) if bad]
    shutil.rmtree(root, ignore_errors=True)
    if fails:
        raise AssertionError(f"12 missed the gates: {fails}: "
                             f"{ {k: v for k, v in rec.items()} }")
    rec["launches"] = {k: sum(rec[p]["launches"][k] for p in
                              ("mono", "rgbd", "stereo"))
                       for k in rec["mono"]["launches"]}
    return rec


def host_native_turns(snap, turns=3):
    """Item 1.9 in turns on one map (11b's final map in a whole run): the
    host library against its numpy twins, and the covisibility matrix
    against the numpy incidence product the port used before, turn and
    turn about; the results equal. Host clock, ms."""
    from orb_slam3_detailed_comments_tpu_torch import host_native
    from orb_slam3_detailed_comments_tpu_torch.host_native import plain
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    m = MapStore.from_numpy(snap["map"], snap["map_cfg"], device="cpu")
    pids = np.nonzero(m.pt_valid)[0]
    ks = m.kf_ids()
    sf = m._scale_factors.astype(np.float32)
    P = m.cfg.max_pt

    def stats(fn):
        out = dict(desc=np.zeros_like(m.pt_desc), normal=np.zeros_like(
            m.pt_normal), mind=np.zeros_like(m.pt_min_dist),
            maxd=np.zeros_like(m.pt_max_dist), ref=m.pt_ref_kf.copy())
        fn(m.kf_valid, m.kf_feat_point, m.kf_feat_desc, m.kf_feat_level,
           m.kf_R, m.kf_t, m.pt_xyz, out["ref"], pids, sf, out["desc"],
           out["normal"], out["mind"], out["maxd"])
        return out

    def covis(lib):
        bits = lib.build_incidence_bits(m.kf_valid, m.kf_feat_point, P)
        return lib.covis_counts(bits, m.kf_valid, ks)

    def old_matrix():
        inc = np.zeros((m.cfg.max_kf, P), bool)
        kk, ff = np.where(m.kf_feat_point >= 0)
        inc[kk, m.kf_feat_point[kk, ff]] = True
        inc &= m.kf_valid[:, None]
        cov = np.zeros((m.cfg.max_kf, m.cfg.max_kf), np.int32)
        f = inc.astype(np.float32)
        cov[ks] = np.rint(f[ks] @ f.T).astype(np.int32)
        return cov

    def new_matrix():
        m.version += 1                      # no cached bits or matrix
        return m.covisibility_matrix()

    pairs = {"update_point_stats": (lambda: stats(
        host_native.update_point_stats), lambda: stats(
        plain.update_point_stats)),
        "covisibility_batch": (lambda: covis(host_native),
                               lambda: covis(plain)),
        "covisibility_matrix": (new_matrix, old_matrix)}
    rec = dict(points=int(len(pids)), keyframes=int(len(ks)),
               max_kf=int(m.cfg.max_kf), max_pt=int(P))
    for name, (cpp, twin) in pairs.items():
        t_cpp, t_twin = [], []
        for _ in range(turns):
            for fn, acc in ((cpp, t_cpp), (twin, t_twin)):
                t0 = time.perf_counter()
                res = fn()
                acc.append((time.perf_counter() - t0) * 1e3)
                if acc is t_cpp:
                    got = res
                else:
                    want = res
        if name == "update_point_stats":
            same = (np.array_equal(got["desc"], want["desc"])
                    and np.array_equal(got["ref"], want["ref"])
                    and np.allclose(got["normal"], want["normal"], atol=1e-6)
                    and np.allclose(got["maxd"], want["maxd"], rtol=1e-6))
        else:
            same = np.array_equal(got, want)
        rec[name] = dict(cpp_ms=t_cpp, numpy_ms=t_twin, equal=bool(same))
        log(f"12 1.9 turns {name}: C++ {[round(x, 3) for x in t_cpp]} ms, "
            f"numpy {[round(x, 3) for x in t_twin]} ms; equal {same}")
        if not same:
            raise AssertionError(f"12: {name}: the host library and its "
                                 f"numpy twin disagree")
    return rec


def host_phase(dev) -> dict:
    """Phase 12: the host surfaces on the card, then item 1.9's turns on
    11b's final map (phase 12's own monocular map when phase 11 did not
    run)."""
    log("phase 12 host surfaces: PNG directories through the dataset entry "
        "points, and the host library against its numpy twins")
    out = dict(surfaces=host_surfaces_path(dev))
    snap = FINAL_MAPS.get("11b")
    if snap is None:
        snap = FINAL_MAPS.get("12")
        log("12: 11b's map is absent (phase 11 did not run); the turns run "
            "on phase 12's monocular map")
    out["turns"] = host_native_turns(snap)
    return out


def phase_summary(ph) -> dict:
    """Phase 10's or 11's record for the JSON line (launch counts
    apart)."""
    return {name: ({k: v for k, v in r.items() if k != "launches"}
                   if isinstance(r, dict) else r)
            for name, r in ph.items()}


def async_phase(dev, sync_rec=None) -> dict:
    """Phase 10: 10a-10d, each sub-phase's time logged; fails if any
    background thread raised."""
    log("phase 10 async mapping: 10a the monocular System with the mapping "
        "worker, 10b the loop with the racing global "
        "BA, 10c the racing inertial global BA, 10d settings, atlas "
        "checkpoints and warmup")
    THREAD_ERRORS.clear()
    prev = _watch_threads()
    out, t = {}, [time.perf_counter()]

    def sub(name):
        t.append(time.perf_counter())
        out.setdefault("seconds", {})[name] = t[-1] - t[-2]
        log(f"{name} took {t[-1] - t[-2]:.1f} s")

    try:
        out["mono"] = async_mono_path(dev, sync_rec, n_frames=ASYNC_FEED,
                                      profile_at=ASYNC_FEED - 10)
        sub("10a")
        out["loop"] = async_loop_path(dev, n_feed=LOOP_FEED)
        sub("10b")
        if "9a" not in FINAL_MAPS:
            raise AssertionError("10c needs 9a's final map: run phase 9a "
                                 "first")
        out["inertial_gba"] = inertial_gba_path(dev, FINAL_MAPS["9a"])
        sub("10c")
        out["settings"] = settings_path(dev)
        sub("10d")
    finally:
        threading.excepthook = prev
    if out["inertial_gba"]["failed"]:
        raise AssertionError(f"10c missed its gates: "
                             f"{out['inertial_gba']['failed']}")
    if THREAD_ERRORS:
        raise AssertionError(f"phase 10: background threads raised: "
                             f"{THREAD_ERRORS}")
    return out


# ---------------------------------------------------------------- phase 11
# loop closing and merging on metric and inertial maps: 11a the RGB-D
# two-session merge at fixed scale (test_pipeline_metric_loops.py's
# test_rgbd_multimap_spawn_and_merge), 11b a stereo-inertial loop through
# VIBA2, the gravity gate, the 4DoF essential graph and the full inertial
# BA (test_pipeline_fisheye.py's test_fisheye_stereo_inertial_loop_closure
# with a rectified pinhole pair in place of the KB8 one: the KB8 frame
# program costs ~0.8 s a frame on the card's host)
METRIC_CAM_KW = LOOP_CAM_KW
RGBD_MERGE_GATES = dict(tracked1=0.7, tracked2=0.5, rows=0.7, ate_poses=0.6,
                        ate_m=0.12, scale=0.02)
VI_LOOP_GATES = dict(tracked=0.8, bg=8e-3, ate_m=0.25, ate_poses=0.7,
                     scale=0.06, replay_tol=1e-3)
VI_LOOP_BG = np.array([-0.002, 0.003, 0.001], np.float32)
# 11b's depth: the trajectory keeps its 19.2 s (VIBA2 runs 15 s after the
# IMU initialisation) at 160 frames of 24 IMU samples, the first setting
# on which the JAX package holds every gate of the case on the CPU
# (tests/test_torch_inertial_loops.py's slow reference)
VI_LOOP_FRAMES, VI_LOOP_IMU = 160, 24


def stress_world(rng, half=8.0):
    """tests/test_pipeline_stress.py's box world with one low-texture wall
    (350 blobs against 4000), from the port's _texture and Plane: the same
    textures from the same rng. half: the box's half-extent."""
    from orb_slam3_detailed_comments_tpu_torch.utils.synth_render import (
        Plane, _texture)
    tex = 1400
    ppm = tex / (2 * half)
    e_y = np.array([0, 1 / ppm, 0.0])
    blobs = [4000, 4000, 350, 4000]
    origins = [np.array([-half, -half, half]), np.array([half, -half, half]),
               np.array([half, -half, -half]),
               np.array([-half, -half, -half])]
    e1s = [np.array([1 / ppm, 0, 0]), np.array([0, 0, -1 / ppm]),
           np.array([-1 / ppm, 0, 0]), np.array([0, 0, 1 / ppm])]
    return [Plane(o, e1, e_y, _texture(rng, tex, n_blobs=nb))
            for o, e1, nb in zip(origins, e1s, blobs)]


def box_blur_9x1(img):
    """cv2.blur(img, (9, 1)) without OpenCV: the mean of 9 horizontal
    neighbours, the border reflected without repeating the edge pixel
    (cv2's default, BORDER_REFLECT_101); float64 sums, float32 out."""
    W = img.shape[1]
    p = np.pad(np.asarray(img, np.float64), ((0, 0), (4, 4)), mode="reflect")
    return (sum(p[:, j:j + W] for j in range(9)) / 9.0).astype(np.float32)


def degrade(img, i, n):
    """tests/test_pipeline_stress.py's degradations of frame i of n:
    exposure steps, a horizontal motion-blur burst, a moving occluder."""
    u = i / n
    if 0.18 < u < 0.30:
        img = img * 0.55
    elif 0.70 < u < 0.80:
        img = np.clip(img * 1.5 + 30.0, 0, 255)
    if 0.38 < u < 0.46:
        img = box_blur_9x1(img)
    if 0.86 < u < 0.94:
        h, w = img.shape
        ow, oh = w // 4, h // 3
        x = int((w - ow) * (0.5 + 0.5 * np.sin(i * 0.7)))
        y = int((h - oh) * (0.5 + 0.5 * np.cos(i * 0.5)))
        img = img.copy()
        img[y:y + oh, x:x + ow] = 70.0 + 10.0 * np.sin(i)
    return img


def stress_trajectory(n, radius=3.0, closes=1.06):
    """tests/test_pipeline_stress.py's loop with a nonuniform angle
    schedule: a 2.5x fast-rotation burst in the third quadrant."""
    u = np.linspace(0, 1, n)
    rate = np.where((u > 0.55) & (u < 0.65), 2.5, 1.0)
    a_acc = np.cumsum(rate)
    a_acc = a_acc / a_acc[-1] * 2 * np.pi * closes
    Rs, ts = [], []
    for a in a_acc:
        cw = np.array([radius * np.sin(a), 0.0, radius * np.cos(a)])
        z = np.array([np.sin(a), 0.0, np.cos(a)])
        x = np.array([np.cos(a), 0.0, -np.sin(a)])
        y = np.cross(z, x)
        R_cw = np.stack([x, y, z], axis=1).T
        Rs.append(R_cw.astype(np.float32))
        ts.append((-R_cw @ cw).astype(np.float32))
    return np.stack(Rs), np.stack(ts)


# phase 15: the JAX package's long acceptance runs, each case built as its
# test builds it (seed, world, trajectory, IMU windows, degradations,
# camera, System settings), at its full depth
LONG_CAM_KW = LOOP_CAM_KW
LONG_BG = np.array([-0.002, 0.003, 0.001], np.float32)
LONG_TESTS = dict(
    flagship="tests/test_pipeline_fisheye.py:51 "
             "test_fisheye_stereo_inertial_end_to_end",
    stress="tests/test_pipeline_stress.py:78 test_long_adversarial_loop",
    stress_async="tests/test_pipeline_stress.py:147 "
                 "test_long_adversarial_loop_async",
    stress_inertial="tests/test_pipeline_stress.py:217 "
                    "test_long_adversarial_inertial_loop",
    stereo_gauntlet="tests/test_pipeline_metric_loops.py:31 "
                    "test_stereo_gauntlet_fixed_scale_loop",
    kb8_loop="tests/test_pipeline_fisheye.py:148 "
             "test_fisheye_stereo_inertial_loop_closure")
LONG_PHASES = dict(zip(("15a", "15b", "15c", "15d", "15e", "15f"),
                       LONG_TESTS))


def long_case(name):
    """The case of the JAX test LONG_TESTS[name], as the test builds it.
    A dict: n frames, the port's camera, the System's sensor and keyword
    arguments, the frame times ts and the true camera centres, IMU windows
    (or None), extractions and the stereo matcher's one-image gathers a
    frame, and frame(i, dev): frame i's image (a stereo pair: a tuple),
    rendered on dev, degraded as the test degrades it, as host numpy.
    Pinhole frames come from synth_render.render_frame (the test's
    homography renderer, equal to its OpenCV output bit for bit), KB8
    frames from synth_render.render_image at pixel centres (the test's
    render_frame_raycast)."""
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    kb8 = name in ("flagship", "kb8_loop")
    cam = (cameras.fisheye_kb8(**KB8_KW) if kb8
           else cameras.pinhole(**LONG_CAM_KW))
    case = dict(name=name, test=LONG_TESTS[name], cam=cam, windows=None,
                extractions=1, sad=0)
    T_c1c2 = np.eye(4, dtype=np.float32)
    T_c1c2[0, 3] = BASELINE
    if name in ("stress", "stress_async", "stereo_gauntlet"):
        walls = stress_world(np.random.default_rng(21))
        n = 400 if name == "stereo_gauntlet" else 520
        R, t = stress_trajectory(n)
        case.update(ts=np.arange(n) * 0.05, R=R, t=t,
                    centers=sr.camera_centers(R, t))
    elif name == "stress_inertial":
        walls = stress_world(np.random.default_rng(33))
        n = 520
        traj = sr.inertial_loop_trajectory(n, imu_per_frame=10,
                                           yaw_burst=(0.62, 0.72, 2.0))
    elif name == "kb8_loop":
        walls = stress_world(np.random.default_rng(29), half=4.0)
        n = 320
        traj = sr.inertial_loop_trajectory(n, imu_per_frame=12,
                                           true_bg=LONG_BG)
    else:
        walls = sr.default_world(np.random.default_rng(23))
        n = 45
        traj = sr.inertial_trajectory(n, true_bg=LONG_BG)
    if "R" not in case:
        R, t = traj["R_cw"], traj["t_cw"]
        case.update(ts=traj["ts"], R=R, t=t, centers=traj["centers"],
                    windows=traj["windows"])
    case["n"] = n
    if name in ("stress", "stress_async"):
        case.update(sensor=system.MONOCULAR, system_kw=dict(
            enable_loop_closing=True, async_mapping=name == "stress_async"))

        def frame(i, dev):
            return degrade(sr.render_frame(cam, walls, R[i], t[i], dev), i, n)
    elif name == "stress_inertial":
        case.update(sensor=system.IMU_MONOCULAR,
                    system_kw=dict(enable_loop_closing=True))
        blank = np.full((cam.height, cam.width), 85.0, np.float32)

        def frame(i, dev):
            if 0.30 < i / n < 0.36:          # full visual blackout (~1.5 s)
                return blank
            return degrade(sr.render_frame(cam, walls, R[i], t[i], dev), i, n)
    elif name == "stereo_gauntlet":
        case.update(sensor=system.STEREO, extractions=2,
                    sad=SAD_GATHERS["stereo"], system_kw=dict(
                        baseline=BASELINE, enable_loop_closing=True))

        def frame(i, dev):
            # the JAX renderer's right camera (float64 t, not rounded)
            c_r = -R[i].T @ t[i] + R[i].T @ np.array([BASELINE, 0.0, 0.0])
            return tuple(degrade(sr.render_frame(cam, walls, R[i], ti, dev),
                                 i, n) for ti in (t[i], -R[i] @ c_r))
    else:
        case.update(sensor=system.IMU_STEREO, extractions=2,
                    sad=SAD_GATHERS["fisheye"], system_kw=dict(
                        camera2=cam, T_c1c2=T_c1c2,
                        enable_loop_closing=name == "kb8_loop"))

        def frame(i, dev):
            pair = tuple(sr.render_image(cam, walls, R[i], ti, dev,
                                         centre=0.5).cpu().numpy()
                         for ti in (t[i], sr.stereo_right_t(R[i], t[i],
                                                            BASELINE)))
            if name == "flagship":
                return pair
            return tuple(degrade(img, i, n) for img in pair)
    case["frame"] = frame
    return case


def rgbd_merge_path(dev, cam_kw=METRIC_CAM_KW, n=50, n2=30, world_seed=7,
                    gates=RGBD_MERGE_GATES, map_cfg=None, track_cfg=None,
                    orb_cfg=None):
    """11a: System(cam, RGBD, baseline=0.11) on world seed 7's n-frame
    orbit with exact depth maps (ray-cast on dev), change_dataset(), the last n2 frames again
    at ts + 10 s: test_rgbd_multimap_spawn_and_merge's gates (> 70 % and
    > 50 % tracked, 1 map after the first session, 2 at the end with the
    second active, >= 1 merge, fix_scale, > 70 % rows, joint metric ATE
    below 0.12 m over > 60 % of n + n2 poses, Horn scale within 0.02 of 1)
    and a weld at scale exactly 1; exact launch counts."""
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        loop_closing, system)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr)
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(n)
    t0 = time.perf_counter()
    frames = [render_host_depth(cam, planes, R[i], t[i], dev)
              for i in range(n)]
    log(f"  rendered {n} frames with depth maps in "
        f"{time.perf_counter() - t0:.1f} s")
    ts = 0.05 * np.arange(n)
    ts2 = ts[-n2:] + 10.0
    kw = dict(device=dev)
    for key, val in (("map_cfg", map_cfg), ("tracking_cfg", track_cfg),
                     ("orb_cfg", orb_cfg)):
        if val is not None:
            kw[key] = val
    slam = system.System(cam, system.RGBD, baseline=BASELINE, **kw)
    welds, maps_after_1 = [], []
    merge = slam.atlas.merge_map_into_active

    def logged_merge(mid, S):
        welds.append(dict(map=int(mid), scale=loop_closing.sim3_np(S)[2]))
        return merge(mid, S)

    slam.atlas.merge_map_into_active = logged_merge
    order = list(range(n)) + list(range(n - n2, n))
    stamps = np.concatenate([ts, ts2])

    def before(j):
        if j == n:
            maps_after_1.append(len(slam.atlas.maps))
            slam.change_dataset()

    poses, times, _, launches, expect = feed_system(
        slam, lambda j: slam.track_rgbd(*frames[order[j]], float(stamps[j])),
        n + n2, dev, before=before)
    check_launches("11a RGB-D merge", launches, expect, dev)
    ok1 = sum(p is not None for p in poses[:n])
    ok2 = sum(p is not None for p in poses[n:])
    rows = slam.trajectory_tum()
    gt = sr.camera_centers(R, t)
    gt_all = np.concatenate([gt, gt[-n2:]])
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    rmse, npairs, _ = evaluate_ate.ate_rmse(stamps, gt_all, est_ts, est,
                                            with_scale=False)
    _, _, scale = evaluate_ate.ate_rmse(stamps, gt_all, est_ts, est,
                                        with_scale=True)
    lc = slam.loop_closer
    rec = dict(tracked1=ok1, tracked2=ok2, maps_after_1=maps_after_1[0],
               maps=len(slam.atlas.maps), active=slam.atlas.active_id,
               merges=slam.atlas.n_merges, welds=welds,
               fix_scale=bool(lc is not None and lc.cfg.fix_scale),
               rows=len(rows), ate_m=rmse, ate_poses=npairs, scale=scale,
               consistency=slam.check_map_consistency(), launches=launches,
               frame_ms=_stats(times))
    log(f"11a RGB-D merge: {ok1}/{n} then {ok2}/{n2} frames tracked; "
        f"{rec['maps_after_1']} map(s) after the first session, "
        f"{rec['maps']} at the end, active {rec['active']}, {rec['merges']} "
        f"merges, welds {welds}, fix_scale {rec['fix_scale']}; "
        f"{len(rows)} rows; joint metric ATE {rmse:.5f} m over {npairs} "
        f"poses, Horn scale {scale:.5f}; consistency {rec['consistency']}; "
        f"frames {rec['frame_ms']}")
    fails = [name for name, bad in (
        ("first session", ok1 <= gates["tracked1"] * n),
        ("one map after it", rec["maps_after_1"] != 1),
        ("second session", ok2 <= gates["tracked2"] * n2),
        ("maps", rec["maps"] != 2 or rec["active"] != 1),
        ("merges", rec["merges"] < 1),
        ("fix_scale", not rec["fix_scale"]),
        ("weld scale", not welds or any(w["scale"] != 1.0 for w in welds)),
        ("rows", len(rows) <= gates["rows"] * (n + n2)),
        ("ATE", not (npairs > gates["ate_poses"] * (n + n2)
                     and rmse < gates["ate_m"])),
        ("scale", not abs(scale - 1.0) < gates["scale"])) if bad]
    if fails:
        raise AssertionError(f"11a missed the gates: {fails}: {rec}")
    return rec


def _kf_state(m, fields=("kf_R", "kf_t", "kf_vel")):
    kfs = m.kf_ids()
    return {f: getattr(m, f)[kfs].copy() for f in fields}


def _state_diff(a, b):
    return {f: float(np.abs(a[f] - b[f]).max()) for f in a}


INERTIAL_STATE = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")


def vi_correction_replay(snap, tol):
    """One _correct_loop of 11b once more on the CPU, from the map the card
    saw just before it and with the same Sim3: the gate's decision, the
    keyframe poses and velocities after the 4DoF graph and after the full
    inertial BA against the card's (largest differences)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    m = MapStore.from_numpy(snap["map"], snap["map_cfg"],
                            device=torch.device("cpu"))
    lc = loop_closing.LoopCloser(m, snap["cam"], None, snap["cfg"])
    lc.imu_calib = snap["calib"]
    graph = {}
    apply = loop_closing._apply_pose_graph

    def kept(*a, **k):
        apply(*a, **k)
        graph.update(_kf_state(m))

    loop_closing._apply_pose_graph = kept
    try:
        t0 = time.perf_counter()
        closed = lc._correct_loop(snap["k"], snap["c"],
                                  loop_closing.host_sim3(*snap["S"]))
        cpu_ms = (time.perf_counter() - t0) * 1e3
    finally:
        loop_closing._apply_pose_graph = apply
    out = dict(k=snap["k"], c=snap["c"], card_closed=snap["closed"],
               cpu_closed=bool(closed), cpu_ms=cpu_ms)
    if closed and snap["closed"]:
        out["after_graph"] = _state_diff(graph, snap["graph"])
        out["after_inertial_ba"] = _state_diff(
            _kf_state(m, INERTIAL_STATE), snap["final"])
    out["ok"] = (out["cpu_closed"] == out["card_closed"] and all(
        v < tol for part in ("after_graph", "after_inertial_ba")
        for v in out.get(part, {}).values()))
    return out


def vi_loop_path(dev, cam_kw=METRIC_CAM_KW, n=VI_LOOP_FRAMES,
                 imu_per_frame=VI_LOOP_IMU, world_seed=29,
                 gates=VI_LOOP_GATES, map_cfg=None, track_cfg=None,
                 orb_cfg=None):
    """11b: System(cam, IMU_STEREO, baseline=0.11, enable_loop_closing=
    True) around stress_world(default_rng(29), half=4.0) on
    inertial_loop_trajectory(n, imu_per_frame, true_bg=VI_LOOP_BG), both
    images degraded: the fisheye loop test's gates (> 80 % tracked, 1 map,
    the IMU initialised, VIBA1 and VIBA2 done, fix_scale, >= 1 loop closed,
    the newest chain keyframe's gyro bias within 8e-3, metric ATE below
    0.25 m over > 70 % of the frames, Horn scale within 0.06 of 1, a
    consistent map), exact launch counts; each correction's gate verdict,
    yaw-only branch and host clock by part (gate and set-up, graph, fuse,
    point stats, full inertial BA with its C, or the visual global BA
    before the IMU initialisation); the first correction on the
    inertial map, and the first one applied there, replayed on the CPU."""
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        loop_closing, system)
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        evaluate_ate, synth_render as sr)
    cam = cameras.pinhole(**cam_kw)
    walls = stress_world(np.random.default_rng(world_seed), half=4.0)
    traj = sr.inertial_loop_trajectory(n, imu_per_frame=imu_per_frame,
                                       true_bg=VI_LOOP_BG)
    t0 = time.perf_counter()
    pairs = []
    for i in range(n):
        R, t = traj["R_cw"][i], traj["t_cw"][i]
        pairs.append((degrade(render_host(cam, walls, R, t, dev), i, n),
                      degrade(render_host(cam, walls, R, sr.stereo_right_t(
                          R, t, BASELINE), dev), i, n)))
    log(f"  rendered and degraded {n} pairs in "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(device=dev)
    for key, val in (("map_cfg", map_cfg), ("tracking_cfg", track_cfg),
                     ("orb_cfg", orb_cfg)):
        if val is not None:
            kw[key] = val
    slam = system.System(cam, system.IMU_STEREO, baseline=BASELINE,
                         enable_loop_closing=True, **kw)
    sync = torch_sync(dev)
    frame, parts, corrections, snaps = [0], {}, [], {}

    graph = {}

    def timing_patches(lc, m):
        """The correction's parts timed, the poses after the graph kept:
        patched for one correction only; returns the undo."""
        undo = correction_parts(parts, lc, m, sync)
        apply_timed = loop_closing._apply_pose_graph

        def apply_kept(m_, *a, **k):
            apply_timed(m_, *a, **k)
            graph.update(_kf_state(m_))

        loop_closing._apply_pose_graph = apply_kept

        def restore():
            loop_closing._apply_pose_graph = apply_timed
            undo()
        return restore

    build = slam._build_recognition

    def build_hooked(*a, **k):
        build(*a, **k)
        lc = slam.loop_closer
        correct = lc._correct_loop

        def logged(k_, c, S):
            m = lc.map
            inertial_map = bool(m.imu_initialized)
            snap = None
            if inertial_map and ("first" not in snaps
                                 or "applied" not in snaps):
                snap = dict(map=map_arrays(m),
                            map_cfg=dataclasses.replace(m.cfg), cam=cam,
                            cfg=dataclasses.replace(lc.cfg),
                            calib=lc.imu_calib, k=int(k_), c=int(c),
                            S=loop_closing.sim3_np(S))
            parts.clear()
            graph.clear()
            gba0 = lc.n_gba_runs
            restore = timing_patches(lc, m)
            sync()
            t1 = time.perf_counter()
            try:
                out = correct(k_, c, S)
                sync()
            finally:
                restore()
            ms = (time.perf_counter() - t1) * 1e3
            rec = dict(k=int(k_), c=int(c), frame=frame[0],
                       match_frame=int(m.kf_frame_id[c]),
                       inertial=inertial_map,
                       yaw_only=inertial_map and bool(m.imu_ba2),
                       closed=bool(out), n_kf=int(m.n_kf), ms=ms,
                       parts_ms={key: round(v, 1) for key, v in parts.items()})
            rec["parts_ms"]["gate and set-up"] = round(
                ms - sum(parts.values()), 1)
            if lc.n_gba_runs > gba0:
                rec["gba"] = list(lc.last_correction.get("gba", []))
            corrections.append(rec)
            if snap is not None:
                snap.update(closed=bool(out), graph=dict(graph),
                            final=_kf_state(m, INERTIAL_STATE))
                snaps.setdefault("first", snap)
                if out:
                    snaps.setdefault("applied", snap)
            return out
        lc._correct_loop = logged

    slam._build_recognition = build_hooked
    ts = traj["ts"]

    def before(i):
        frame[0] = i

    poses, times, events, launches, expect = feed_system(
        slam, lambda i: slam.track_stereo(*pairs[i], float(ts[i]),
                                          imu=traj["windows"][i]),
        n, dev, extractions=2, sad=2, before=before)
    check_launches("11b stereo-inertial loop", launches, expect, dev)
    m, lc = slam.map, slam.loop_closer
    chain = m.temporal_chain()
    bg = m.kf_bg[chain[-1]]
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    rmse, npair, _ = evaluate_ate.ate_rmse(ts, traj["centers"], est_ts, est,
                                           with_scale=False)
    _, _, scale = evaluate_ate.ate_rmse(ts, traj["centers"], est_ts, est,
                                        with_scale=True)
    closing = {c["frame"] for c in corrections}
    steady = [times[i] for i in range(n)
              if poses[i] is not None and i not in events and i not in closing]
    rec = dict(tracked=sum(p is not None for p in poses), n_frames=n,
               imu_per_frame=imu_per_frame, maps=len(slam.atlas.maps),
               keyframes=slam.n_keyframes,
               imu_initialized=bool(m.imu_initialized),
               imu_ba1=bool(m.imu_ba1), imu_ba2=bool(m.imu_ba2),
               imu_events=slam.imu_events, fix_scale=bool(lc.cfg.fix_scale),
               loops_closed=lc.n_loops_closed,
               rejected_gravity=lc.n_loops_rejected_gravity,
               rejected_projgate=lc.n_loops_rejected_projgate,
               corrections=corrections, bg=bg.tolist(),
               bg_err=float(np.abs(bg - VI_LOOP_BG).max()), ate_m=rmse,
               ate_poses=npair, scale=scale,
               consistency=slam.check_map_consistency(), launches=launches,
               steady=_stats(steady), closing_frame_ms=[
                   times[c["frame"]] for c in corrections])
    log(f"11b stereo-inertial loop: {rec['tracked']}/{n} frames tracked, "
        f"{rec['maps']} map(s), {slam.n_keyframes} KF; IMU initialised "
        f"{rec['imu_initialized']}, VIBA1 {rec['imu_ba1']}, VIBA2 "
        f"{rec['imu_ba2']} (stages {slam.imu_events}); fix_scale "
        f"{rec['fix_scale']}; {lc.n_loops_closed} loops closed, "
        f"{lc.n_loops_rejected_gravity} refused by the gravity gate, "
        f"{lc.n_loops_rejected_projgate} at the projection gate; "
        f"corrections {corrections}; the frames that made them "
        f"{[round(x, 1) for x in rec['closing_frame_ms']]} ms; bg "
        f"{np.round(bg, 5).tolist()} (error {rec['bg_err']:.5f}); metric "
        f"ATE {rmse:.5f} m over {npair}, Horn scale {scale:.5f}; "
        f"consistency {rec['consistency']}; steady frames {rec['steady']}")
    fails = [name for name, bad in (
        ("frames tracked", rec["tracked"] <= gates["tracked"] * n),
        ("one map", rec["maps"] != 1),
        ("IMU initialised", not rec["imu_initialized"]),
        ("VIBA1 and VIBA2", not (rec["imu_ba1"] and rec["imu_ba2"])),
        ("fix_scale", not rec["fix_scale"]),
        ("loops closed", rec["loops_closed"] < 1),
        ("gyro bias", not rec["bg_err"] < gates["bg"]),
        ("ATE", not (npair > gates["ate_poses"] * n
                     and rmse < gates["ate_m"])),
        ("scale", not abs(scale - 1.0) < gates["scale"]),
        ("map consistency", rec["consistency"] != [])) if bad]
    if fails:
        raise AssertionError(f"11b missed the gates: {fails}: "
                             f"{ {k: v for k, v in rec.items() if k != 'launches'} }")
    # what the gates do not require: a correction after VIBA2 (the
    # yaw-only branch) and a loop across the revisit (its match keyframe
    # made in the first half of the sequence, its closing one in the last)
    rec["yaw_only_corrections"] = sum(c["yaw_only"] and c["closed"]
                                      for c in corrections)
    rec["revisit_loops"] = sum(c["closed"] and c["match_frame"] < n // 2
                               <= c["frame"] for c in corrections)
    log(f"11b: {rec['yaw_only_corrections']} corrections after VIBA2 (the "
        f"yaw-only branch), {rec['revisit_loops']} loops across the revisit; "
        f"frames of each loop (closing <- match): "
        f"{[(c['frame'], c['match_frame']) for c in corrections]}")
    FINAL_MAPS["11b"] = dict(map=map_arrays(m), map_cfg=dataclasses.replace(
        m.cfg), cam=cam)
    if "first" not in snaps:
        raise AssertionError("11b: no correction on the inertial map to "
                             "replay")
    rec["replay"] = []
    for key in ("first", "applied"):
        if key == "applied" and snaps.get("applied") is snaps["first"]:
            continue
        if key in snaps:
            r = vi_correction_replay(snaps[key], gates["replay_tol"])
            rec["replay"].append(r)
            log(f"11b replay of the {key} inertial correction on the CPU: "
                f"{r}")
            if not r["ok"]:
                raise AssertionError(f"11b: card and CPU part: {r}")
    if not any(r["cpu_closed"] for r in rec["replay"]):
        raise AssertionError("11b: no applied correction on the inertial map "
                             "to replay")
    return rec


# 11c: the COO tier's normal equations on the card within this of the
# CPU's (relative to each block's largest entry) at the same state; after
# the solve, the card's robust cost at most COO_GBA_COST x the CPU's and at
# most COO_GBA_INLIER_SHARE of the observations with another inlier
# verdict. The solved states themselves are logged beside the CPU's own
# spread under a 1e-7 m nudge of the points, not gated: on this map a
# nudge at float32's rounding moves the solve by centimetres (in the JAX
# package too), so no device can match another pointwise
COO_GBA_ASSEMBLY_TOL = 1e-4
COO_GBA_COST = 1.05
COO_GBA_INLIER_SHARE = 1e-3
COO_GBA_NUDGE = 1e-7


def coo_gba_path(dev, snap):
    """11c: one round of the visual global BA that LoopCloser._correct_loop
    runs on a visual map (local_mapping.build_ba_problem over every
    keyframe, anchored at the first, then ba.ba_solve at gba_iters) on
    copies of 11b's final map, on the card and on the CPU. Its keyframes
    (more than 48) put the solve in ba_solve's COO tier (48 < C <= 128),
    which no other phase reaches: 8a's, 10b's and 11b's global BAs stay at
    C <= 48 at their depths. Gates: the tier is "coo" and _ba_solve_coo ran
    once on each device; the tier's normal equations at the map's state
    (ba.coo_normal_equations) on the card within COO_GBA_ASSEMBLY_TOL of
    the CPU's; every state finite and the robust cost over all
    observations down on each device, the card's final cost at most
    COO_GBA_COST x the CPU's, at most COO_GBA_INLIER_SHARE of the
    observations with another inlier verdict. Logged: the states' largest
    differences, beside those between the CPU's solve and its solve of
    the points nudged by N(0, COO_GBA_NUDGE) m; each solve's host
    clock."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    from orb_slam3_detailed_comments_tpu_torch.optim import ba, reproj
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        local_mapping, loop_closing)
    cam = snap["cam"]
    iters = loop_closing.LoopClosingConfig().gba_iters
    coo, calls = ba._ba_solve_coo, []

    def counted(prob, *a, **k):
        calls.append(prob.points.device.type)
        return coo(prob, *a, **k)

    def cost(prob, R, t, X):
        return float(ba._coo_robust_cost(prob, cam, R, t, X, prob.obs_valid,
                                         reproj.CHI2_MONO))

    def solve(prob, meta, d):
        sync = torch_sync(d)
        sync()
        t0 = time.perf_counter()
        r = ba.ba_solve(prob, cam, iters=iters,
                        table_depth=meta["table_depth"])
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return r, ms, [x.cpu().numpy() for x in (r.kf_R, r.kf_t, r.points,
                                                 r.obs_inlier)]

    def diff(a, b):
        return dict(kf_R=float(np.abs(a[0] - b[0]).max()),
                    kf_t=float(np.abs(a[1] - b[1]).max()),
                    points=float(np.abs(a[2] - b[2]).max()),
                    inlier_share=float((a[3] != b[3])[valid].mean()))

    rec, res, eqs = {}, {}, {}
    ba._ba_solve_coo = counted
    try:
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            m = MapStore.from_numpy(snap["map"], snap["map_cfg"], device=d)
            window = [int(k) for k in m.kf_ids()]
            prob, meta = local_mapping.build_ba_problem(
                m, window, fixed=window[:1], max_points=m.cfg.max_pt // 2,
                max_obs=local_mapping.full_obs_cap(m))
            C = int(prob.kf_R.shape[0])
            eqs[where] = [x.cpu().double().numpy()
                          for x in ba.coo_normal_equations(
                              prob, cam, prob.kf_R, prob.kf_t, prob.points,
                              prob.obs_valid, reproj.CHI2_MONO)]
            before = cost(prob, prob.kf_R, prob.kf_t, prob.points)
            r, ms, res[where] = solve(prob, meta, d)
            rec[where] = dict(
                C=C, cameras=int(meta["n_real"]), tier=ba.tier_of(C),
                observations=int(prob.obs_valid.sum()), ms=ms,
                cost_before=before,
                cost_after=cost(prob, r.kf_R, r.kf_t, r.points),
                inliers=int(r.obs_inlier.sum()),
                finite=bool(all(np.isfinite(x).all()
                                for x in res[where][:3])))
        valid = prob.obs_valid.numpy()
        nudged = prob._replace(points=prob.points + torch.as_tensor(
            np.random.default_rng(0).normal(0, COO_GBA_NUDGE,
                                            prob.points.shape),
            dtype=torch.float32))
        res["nudged"] = solve(nudged, meta, prob.points.device)[2]
    finally:
        ba._ba_solve_coo = coo
    rec["coo_calls"] = calls
    rec["assembly_card_vs_cpu"] = {
        name: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        for name, a, b in zip(("U", "b_c", "V", "b_p", "W"), eqs["card"],
                              eqs["cpu"])}
    rec["card_vs_cpu"] = diff(res["card"], res["cpu"])
    rec["cpu_vs_nudged_cpu"] = diff(res["nudged"], res["cpu"])
    log(f"11c COO-tier global BA on 11b's final map: {rec}")
    fails = [f"{where}: {r}" for where, r in rec.items()
             if where in ("card", "cpu") and not (
                 r["tier"] == "coo" and r["finite"]
                 and r["cost_after"] < r["cost_before"])]
    if calls != [dev.type, "cpu", "cpu"]:
        fails.append(f"_ba_solve_coo ran on {calls}")
    if max(rec["assembly_card_vs_cpu"].values()) > COO_GBA_ASSEMBLY_TOL:
        fails.append(f"the normal equations part: "
                     f"{rec['assembly_card_vs_cpu']}")
    if not (rec["card"]["cost_after"]
            <= COO_GBA_COST * rec["cpu"]["cost_after"]
            and rec["card_vs_cpu"]["inlier_share"] <= COO_GBA_INLIER_SHARE):
        fails.append(f"the solves part: {rec['card_vs_cpu']}, cost "
                     f"{rec['card']['cost_after']} against "
                     f"{rec['cpu']['cost_after']}")
    if fails:
        raise AssertionError(f"11c missed its gates: {fails}")
    return rec


def metric_loop_phase(dev) -> dict:
    """Phase 11: 11a, 11b and 11c, each sub-phase's time logged."""
    log("phase 11 metric and inertial maps: 11a the RGB-D two-session "
        "merge at fixed scale, 11b the stereo-inertial loop through VIBA2, "
        "11c the COO-tier global BA on 11b's map")
    out, t = {"seconds": {}}, [time.perf_counter()]
    for name, key, run_sub in (
            ("11a", "rgbd_merge", lambda: rgbd_merge_path(dev)),
            ("11b", "vi_loop", lambda: vi_loop_path(dev)),
            ("11c", "coo_gba", lambda: coo_gba_path(dev, FINAL_MAPS["11b"]))):
        out[key] = run_sub()
        t.append(time.perf_counter())
        out["seconds"][name] = t[-1] - t[-2]
        log(f"{name} took {t[-1] - t[-2]:.1f} s")
    return out


# ---------------------------------------------------------------- phase 13
# the multi-device layer: 13a frame-batched extraction, 13b batch ingestion
# through System.track_monocular_batch, 13c the sharded solves in two
# processes on the one card over gloo (NCCL refuses two ranks on one
# device); the script's own process starts no process group
BATCH_FRAMES = 16
BATCH_BLOCKS = (2, 8)
BATCH_TURNS = 3
INGEST_FRAMES = 20
INGEST_POSE_TOL = 1e-5
SHARD_WORLD = 2
SHARD_TOL = dict(ba_step=2e-4, gba_pcg=2e-3, viba_p=2e-3, viba_v=2e-2)
EXTRACT_KERNELS = ("dense_frontend", "cell_topk", "gather_patches")


def batch_extract_path(dev, cam_kw=CAM_KW, n=BATCH_FRAMES, world_seed=7,
                       blocks=BATCH_BLOCKS, turns=BATCH_TURNS):
    """13a: phase 6's world at 752x480 with OrbConfig(), n frames ray-cast
    on dev, prepared in blocks of B (``kernels.prepare_frames``) for each
    B of blocks: every frame equal to its own ``prepare_frame`` call on
    the card in every field, each extraction kernel launched ceil(8B / 16)
    times a block (the counts set to 0 just before the batched runs and
    read just after); then host ms and device ms a frame and kernels a
    frame, per-frame against each block size, in turns."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops.extractor import OrbConfig
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    cam = cameras.pinhole(**cam_kw)
    orb = OrbConfig()
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(60)
    imgs = torch.stack([sr.render_image(cam, planes, R[i], t[i], dev)
                        for i in range(n)])
    ref = [kernels.prepare_frame(imgs[i], cam, orb) for i in range(n)]
    batched = lambda B: [p for s in range(0, n, B) for p in kernels.unbatch(
        kernels.prepare_frames(imgs[s:s + B], cam, orb))]
    reset_counts()                          # this path's run starts here
    got = {}
    for B in blocks:
        n0 = dict(native.launches)
        got[B] = batched(B)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        want = (n // B) * -(-orb.n_levels * B // 16)
        for name in EXTRACT_KERNELS:
            if dev.type == "cuda" and native.launches[name] - n0[name] != want:
                raise AssertionError(
                    f"13a blocks of {B}: {name} launched "
                    f"{native.launches[name] - n0[name]} times, expected "
                    f"{want} ({n // B} blocks of ceil(8B / 16))")
    launches = dict(native.launches)        # ... and ends here
    for B in blocks:
        for i, (p, r) in enumerate(zip(got[B], ref)):
            for name, x, y in zip(p.feat._fields + ("xy_ud", "xyn"),
                                  tuple(p.feat) + p[1:],
                                  tuple(r.feat) + r[1:]):
                if x.shape != y.shape or not torch.equal(x, y):
                    raise AssertionError(f"13a blocks of {B}: frame {i}'s "
                                         f"{name} differs from prepare_frame")
    rec = dict(frames=n, blocks=list(blocks), launches=launches,
               equal="every field of every frame, both block sizes")
    if dev.type != "cuda":
        return rec
    modes = {"per_frame": lambda: [kernels.prepare_frame(imgs[i], cam, orb)
                                   for i in range(n)]}
    modes.update({f"block_{B}": (lambda B=B: batched(B)) for B in blocks})
    host = {m: [] for m in modes}
    for _ in range(turns):                  # in turns: the host drifts
        for m, fn in modes.items():
            host[m].append(host_ms(fn, reps=1) / n)
    rec["host_ms_a_frame"] = {m: float(np.median(v)) for m, v in host.items()}
    rec["host_ms_turns"] = host
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    rec["device_ms_a_frame"], rec["kernels_a_frame"] = {}, {}
    for m, fn in modes.items():             # one profiled pass a mode
        avg = profiled(lambda _, fn=fn: (fn(), torch.cuda.synchronize()),
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        if avg is None:
            raise AssertionError(f"13a {m}: the profiler saw no kernel")
        cuda = [e for e in avg if e.device_type == DeviceType.CUDA]
        rec["device_ms_a_frame"][m] = sum(
            e.self_device_time_total for e in cuda) / 1e3 / n
        rec["kernels_a_frame"][m] = sum(e.count for e in cuda) / n
    log("13a batched extraction, " + "; ".join(
        f"{m}: host {rec['host_ms_a_frame'][m]:.3f} ms a frame (turns "
        f"{', '.join(f'{x:.3f}' for x in host[m])}), device "
        f"{rec['device_ms_a_frame'][m]:.4f} ms, "
        f"{rec['kernels_a_frame'][m]:.1f} kernels" for m in modes))
    return rec


def batch_ingest_path(dev, cam_kw=CAM_KW, n=INGEST_FRAMES, world_seed=7):
    """13b: test_batch_ingest_matches_online_tracking's gates on phase 6's
    first n frames: System.track_monocular_batch (blocks of
    batch_extract.INGEST_BLOCK_MULTIPLE frames, one batched extraction
    each) against track_monocular frame by frame, loop
    closing off as in the JAX test; the same frames tracked (None where
    online is None) and every pose within INGEST_POSE_TOL; the batch
    run's launches: one of each extraction kernel a block, the searches as
    its frames and keyframe events require."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.parallel import batch_extract
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system
    from orb_slam3_detailed_comments_tpu_torch.utils import (
        synth_render as sr, timing)
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(world_seed))
    R, t = sr.orbit_trajectory(60)
    frames = np.stack([render_host(cam, planes, R[i], t[i], dev)
                       for i in range(n)])
    ts = 0.05 * np.arange(n)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    a = system.System(cam, system.MONOCULAR, enable_loop_closing=False,
                      device=dev)
    t0 = time.perf_counter()
    online = [a.track_monocular(frames[i], float(ts[i])) for i in range(n)]
    sync()
    t_online = time.perf_counter() - t0
    b = system.System(cam, system.MONOCULAR, enable_loop_closing=False,
                      device=dev)
    lm, n_fuse = b.local_mapper, [0]
    process = lm.process_keyframe

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event["fuse_searches"]

    lm.process_keyframe = counted
    n_span = len(timing.samples("ORB extraction"))
    reset_counts()                          # this path's run starts here
    t0 = time.perf_counter()
    batch = b.track_monocular_batch(frames, ts)
    sync()
    t_batch = time.perf_counter() - t0
    launches = dict(native.launches)        # ... and ends here
    lm.process_keyframe = process
    tracked = [p is not None for p in online]
    diff = max((float(np.abs(x - y).max()) for x, y in zip(online, batch)
                if x is not None and y is not None), default=0.0)
    rec = dict(frames=n, tracked=sum(tracked), launches=launches,
               same_none=tracked == [p is not None for p in batch],
               max_pose_diff=diff, online_s=t_online, batch_s=t_batch,
               extraction_span_ms=[1e3 * x for x in
                                   timing.samples("ORB extraction")[n_span:]],
               keyframes=b.n_keyframes)
    want = expected_launches(b.tracker, n, n_fuse[0])
    blk = batch_extract.INGEST_BLOCK_MULTIPLE
    want.update({k: -(-n // blk) * -(-8 * blk // 16)
                 for k in EXTRACT_KERNELS})
    log(f"13b batch ingestion: {rec['tracked']}/{n} frames tracked online, "
        f"None pattern equal {rec['same_none']}, largest pose difference "
        f"{diff:.3e} (gate {INGEST_POSE_TOL}); host clock {t_online:.2f} s "
        f"online, {t_batch:.2f} s batched (extraction span "
        f"{sum(rec['extraction_span_ms']):.1f} ms); launches {launches} "
        f"(expected {want})")
    if not rec["same_none"] or diff > INGEST_POSE_TOL or not any(tracked):
        raise AssertionError(f"13b: {rec}")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"13b launches {launches}, expected {want}")
    return rec


def scene_map(rng, cam, device, n_points=120, n_cams=4):
    """tests/test_loop_closing.py::TestAsyncGlobalBA's scene map (points in
    a box, cameras on an arc looking in, tests/synthetic.make_scene), then
    its perturbation: keyframes 1-3 moved by N(0, 0.05) m, the points by
    N(0, 0.02) m. Returns (map, the true keyframe translations)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapConfig, MapStore)
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    pts = rng.uniform(-2.0, 2.0, size=(n_points, 3))
    pts[:, 2] *= 0.5
    Rs, ts = [], []
    for k in range(n_cams):
        ang = (k / max(n_cams - 1, 1) - 0.5) * 1.2
        eye = np.array([6.0 * np.sin(ang), 0.3 * np.sin(3 * ang),
                        -6.0 * np.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0.0, -1.0, 0.0], z)
        x /= np.linalg.norm(x)
        Rk = np.stack([x, np.cross(z, x), z])
        Rs.append(Rk)
        ts.append(-Rk @ eye)
    R = np.stack(Rs).astype(np.float32)
    t = np.stack(ts).astype(np.float32)
    pc = np.einsum("cij,pj->cpi", R, pts) + t[:, None, :]
    uv = cameras.project(cam, torch.from_numpy(pc.astype(np.float32)))
    vis = (pc[..., 2] > 0.3) & cameras.in_image(cam, uv).numpy()
    uv = uv.numpy()
    m = MapStore(MapConfig(max_kf=16, max_pt=512, n_feat=128), device=device)
    m.pt_xyz[:n_points] = pts
    m.pt_valid[:n_points] = True
    m.pt_ref_kf[:n_points] = 0
    for c in range(n_cams):
        v = np.where(vis[c])[0][:128]
        fp = np.full(128, -1, np.int32)
        fp[:len(v)] = v
        xy = np.zeros((128, 2), np.float32)
        xy[:len(v)] = uv[c][v]
        val = np.zeros(128, bool)
        val[:len(v)] = True
        m.add_keyframe(R[c], t[c], 0.1 * c, c, xy,
                       np.zeros((128, 2), np.float32),
                       np.zeros(128, np.int32), np.zeros(128, np.float32),
                       np.zeros((128, 8), np.int32), val, fp)
    m.kf_t[1:4] += rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    m.pt_xyz[:n_points] += rng.normal(0, 0.02, (n_points, 3)).astype(
        np.float32)
    return m, t


def ba_problem_arrays(rng, cam, C, Pn, O):
    """tests/test_parallel.py::_ba_problem's problem with the port's so3
    and projection: C cameras, Pn points, O noisy observations (0.3 px),
    the translations and points perturbed by N(0, 0.02), camera 0 fixed."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.lie import so3
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    kf_R = np.stack([so3.exp(torch.from_numpy(
        rng.normal(0, 0.05, 3).astype(np.float32))).numpy()
        for _ in range(C)])
    kf_t = np.stack([rng.normal(0, 0.2, 3) + [0.3 * c, 0, 0]
                     for c in range(C)]).astype(np.float32)
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn),
                    rng.uniform(3, 7, Pn)], 1).astype(np.float32)
    oc = rng.integers(0, C, O).astype(np.int32)
    op = rng.integers(0, Pn, O).astype(np.int32)
    pc = np.einsum("oij,oj->oi", kf_R[oc], pts[op]) + kf_t[oc]
    uv = cameras.project(cam, torch.from_numpy(pc.astype(np.float32)))
    uv = (uv.numpy() + rng.normal(0, 0.3, (O, 2))).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return dict(kf_R=kf_R, kf_t=(kf_t + rng.normal(0, 0.02, kf_t.shape)
                                 ).astype(np.float32),
                points=(pts + rng.normal(0, 0.02, pts.shape)
                        ).astype(np.float32),
                obs_cam=oc, obs_pt=op, obs_uv=uv, obs_w=np.ones(O, np.float32),
                obs_valid=np.ones(O, bool), fixed_cam=fixed,
                point_valid=np.ones(Pn, bool))


def synthetic_vi_chain(rng, n_kf=10, n_pts=300, world=SHARD_WORLD):
    """A visual-inertial chain for 13c when phase 9 does not run: n_kf
    keyframes of synth_render.inertial_trajectory (camera == body), one
    preintegrated edge between neighbours, n_pts points observed with
    0.4 px noise, the states but the first perturbed. Returns the
    VIBAProblem's fields as numpy (edge_pre a tuple) and the gravity."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.imu import preintegration
    from orb_slam3_detailed_comments_tpu_torch.lie import so3
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    cam = cameras.pinhole(**CAM_KW)
    traj = sr.inertial_trajectory(n_kf)
    R_wb = np.transpose(traj["R_cw"], (0, 2, 1)).astype(np.float32)
    p_w = traj["centers"].astype(np.float32)
    v_w = np.gradient(p_w, traj["ts"], axis=0).astype(np.float32)
    calib = preintegration.ImuCalib.default()
    pres = []
    for acc, gyro, tm in traj["windows"][1:]:
        dts = np.full(len(tm), tm[1] - tm[0], np.float32)
        pres.append(preintegration.integrate(
            *(torch.from_numpy(np.asarray(x, np.float32))
              for x in (acc, gyro, dts)), calib))
    pre = preintegration.stack(pres)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(4, 9, n_pts)], 1).astype(np.float32)
    oc, op, ouv = [], [], []
    for c in range(n_kf):
        xc = (pts - p_w[c]) @ R_wb[c]
        uv = cameras.project(cam, torch.from_numpy(xc)).numpy()
        vis = (xc[:, 2] > 0.5) & cameras.in_image(
            cam, torch.from_numpy(uv)).numpy()
        for i in np.where(vis)[0]:
            oc.append(c)
            op.append(i)
            ouv.append(uv[i] + rng.normal(0, 0.4, 2))
    O = len(oc) + (-len(oc) % world)        # a multiple of the world size
    valid = np.arange(O) < len(oc)
    padded = lambda a, dt_: np.concatenate(
        [np.asarray(a, dt_), np.zeros((O - len(a), *np.shape(a)[1:]), dt_)])
    Rn, pn, vn = R_wb.copy(), p_w.copy(), v_w.copy()
    for c in range(1, n_kf):
        Rn[c] = Rn[c] @ so3.exp(torch.from_numpy(
            rng.normal(0, 0.02, 3).astype(np.float32))).numpy()
        pn[c] += rng.normal(0, 0.02, 3).astype(np.float32)
        vn[c] += rng.normal(0, 0.1, 3).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    prob = dict(R_wb=Rn, p_w=pn, v_w=vn, bg=np.zeros((n_kf, 3), np.float32),
                ba=np.zeros((n_kf, 3), np.float32),
                points=(pts + rng.normal(0, 0.03, pts.shape)).astype(
                    np.float32), point_valid=np.ones(n_pts, bool),
                obs_cam=padded(oc, np.int32), obs_pt=padded(op, np.int32),
                obs_uv=padded(ouv, np.float32),
                obs_w=np.ones(O, np.float32), obs_valid=valid,
                edge_i=np.arange(n_kf - 1, dtype=np.int32),
                edge_j=np.arange(1, n_kf, dtype=np.int32),
                edge_pre=tuple(x.numpy() for x in pre),
                edge_valid=np.ones(n_kf - 1, bool), fixed_cam=fixed)
    return prob, np.asarray(traj["gravity"], np.float32)


def vi_problem_of_map(snap, world=SHARD_WORLD):
    """The racing inertial global BA's problem on a final map
    (``inertial.build_full_viba_problem`` over its temporal chain, as 10c
    builds it), its observations padded to a multiple of the world size;
    numpy fields, the extrinsic and the gravity."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.imu.preintegration import (
        ImuCalib)
    from orb_slam3_detailed_comments_tpu_torch.mapping.mapstore import (
        MapStore)
    from orb_slam3_detailed_comments_tpu_torch.pipeline import inertial
    from orb_slam3_detailed_comments_tpu_torch.pipeline.local_mapping import (
        full_obs_cap)
    m = MapStore.from_numpy(snap["map"], snap["cfg"], device="cpu")
    calib = ImuCalib.default()
    chain = [int(k) for k in m.temporal_chain()]
    prob, meta = inertial.build_full_viba_problem(
        m, chain, calib, max_points=m.cfg.max_pt // 2,
        max_obs=full_obs_cap(m))
    d = {k: (tuple(x.numpy() for x in v) if k == "edge_pre" else v.numpy())
         for k, v in prob._asdict().items()}
    O = d["obs_cam"].shape[0]
    pad = -O % world
    for k in ("obs_cam", "obs_pt", "obs_uv", "obs_w", "obs_valid"):
        d[k] = np.concatenate([d[k], np.zeros((pad, *d[k].shape[1:]),
                                              d[k].dtype)])
    g = inertial.gravity_vec(torch.device("cpu")).numpy()
    return (d, np.ascontiguousarray(meta["R_bc"].T).astype(np.float32),
            np.asarray(meta["t_cb"], np.float32), g)


def sharded_child(rank, world, init, in_path, out_dir, device,
                  backend="gloo"):
    """One process of 13c on device (under gloo every rank on cuda:0 on
    the card, under NCCL rank r on cuda:r): the sharded step, PCG and
    inertial BA at the world size beside rank 0's world-1 solves, timed;
    then rank 0's racing global BA with dist_gba, the other ranks
    serving."""
    import pickle
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from orb_slam3_detailed_comments_tpu_torch import device as device_mod
    from orb_slam3_detailed_comments_tpu_torch.imu import preintegration
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.optim import (ba, schur_pcg,
                                                             vi_ba)
    from orb_slam3_detailed_comments_tpu_torch.parallel import dist_ba
    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    dev = device_mod.resolve(f"cuda:{rank}" if backend == "nccl" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group(backend, init_method=f"file://{init}",
                            rank=rank, world_size=world)
    group = dist.group.WORLD
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    cam = cameras.pinhole(**CAM_KW)
    out = {}

    def clock(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out.setdefault("ms", {})[name] = (time.perf_counter() - t0) * 1e3
        return res

    def np_tree(x):
        return ({k: np_tree(v) for k, v in x._asdict().items()}
                if hasattr(x, "_fields") else
                [np_tree(v) for v in x] if isinstance(x, (tuple, list))
                else x.cpu().numpy())

    try:
        step_prob = ba.problem_from_numpy(inp["step"], dev)
        pcg_prob = ba.problem_from_numpy(inp["pcg"], dev)
        vp = vi_ba.VIBAProblem(**{
            k: (preintegration.Preintegrated(*[torch.from_numpy(x).to(dev)
                                               for x in v])
                if k == "edge_pre" else torch.from_numpy(v).to(dev))
            for k, v in inp["viba"].items()})
        R_cb, t_cb, g = (torch.from_numpy(x).to(dev)
                         for x in (inp["R_cb"], inp["t_cb"], inp["g"]))
        step = dist_ba.make_dist_ba_step(cam, group)
        pcg = dist_ba.make_dist_gba_pcg(cam, group, iters=3, cg_iters=20)
        viba = dist_ba.make_dist_viba_solve(cam, group, iters=5)
        for turn in range(2):               # the first builds, the second
            tag = "" if turn else "_first"  # is timed
            out["step2"] = np_tree(clock("step2" + tag,
                                         lambda: step(*step_prob)))
            out["pcg2"] = np_tree(clock("pcg2" + tag, lambda: pcg(pcg_prob)))
            out["viba2"] = np_tree(clock("viba2" + tag, lambda: viba(
                vp, R_cb, t_cb, g)))
            if rank == 0:
                one_step = dist_ba.make_dist_ba_step(cam, None)
                out["step1"] = np_tree(clock("step1" + tag,
                                             lambda: one_step(*step_prob)))
                out["pcg1"] = np_tree(clock("pcg1" + tag, lambda: (
                    schur_pcg.ba_solve_pcg(pcg_prob, cam, iters=3,
                                           cg_iters=20))))
                out["viba1"] = np_tree(clock("viba1" + tag, lambda: (
                    vi_ba.vi_ba_solve(vp, cam, R_cb, t_cb, g, iters=5))))
            dist.barrier(group)
        if rank == 0:
            import threading
            m, t_true = scene_map(np.random.default_rng(7), cam, dev)
            err0 = float(np.abs(m.kf_t[1:4] - t_true[1:4]).max())
            lc = loop_closing.LoopCloser(
                m, cam, None, loop_closing.LoopClosingConfig(
                    async_gba=True, gba_iters=6, gba_chunk=3), group=group)
            lc.map_lock = threading.RLock()
            out["gba_sharded"] = lc.gba_group(1024) is not None
            clock("racing_gba", lambda: (lc._launch_global_ba(
                [0, 1, 2, 3], anchor=[0]), lc.wait_gba()))
            err1 = float(np.abs(m.kf_t[1:4] - t_true[1:4]).max())
            snap_t, v0 = m.kf_t.copy(), m.version
            lc.cfg.gba_iters, lc.cfg.gba_chunk = 400, 1
            lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
            lc.abort_gba()
            out["gba"] = dict(err0=err0, err1=err1, runs=lc.n_gba_runs,
                              aborted=lc.n_gba_aborted,
                              kept=bool(np.array_equal(m.kf_t, snap_t))
                              and m.version == v0,
                              log=lc.gba_log)
            dist_ba.shutdown(group)
        else:
            out["served"] = dist_ba.serve(cam, group, device=dev)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def sharded_path(dev, world=SHARD_WORLD, timeout=300.0,
                 backend="gloo"):
    """13c: the sharded solves at world 2 on the one card (two child
    processes on cuda:0 over gloo, spawned; this process starts no
    group; with backend "nccl", world processes on as many cards, as
    scripts/sharded_nccl.py runs them): make_dist_ba_step
    (tests/test_parallel.py's problem, C = 6),
    make_dist_gba_pcg at the deployment shape (C = 192, 16,384 points,
    65,536 observations, 3 iterations of 20 CG steps) and
    make_dist_viba_solve (on 9a's final map, or the synthetic chain when
    phase 9 did not run), each held to rank 0's world-1 solve on the card
    at the JAX tests' tolerances (SHARD_TOL), both ranks' results equal;
    the clocks of world 2 and world 1; then the visual racing global BA
    with dist_gba and rank 1 serving: one run applied that halves the
    keyframes' error, the aborted one leaving the map equal to the bit."""
    import pickle
    import shutil
    import torch
    import torch.multiprocessing as mp
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    cam = cameras.pinhole(**CAM_KW)
    rng = np.random.default_rng(42)
    inp = dict(step=ba_problem_arrays(rng, cam, 6, 128, 1024),
               pcg=ba_problem_arrays(rng, cam, 192, 16384, 65536))
    if "9a" in FINAL_MAPS:
        inp["viba"], inp["R_cb"], inp["t_cb"], inp["g"] = vi_problem_of_map(
            FINAL_MAPS["9a"], world)
        viba_src = "9a's final map"
    else:
        inp["viba"], inp["g"] = synthetic_vi_chain(rng, world=world)
        inp["R_cb"], inp["t_cb"] = np.eye(3, dtype=np.float32), np.zeros(
            3, np.float32)
        viba_src = "the synthetic chain"
    work = REPO / "build" / "phase13"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        sharded_child, args=(world, str(work / "rendezvous"),
                             str(work / "inputs.pkl"), str(work),
                             "cuda:0" if dev.type == "cuda" else "cpu",
                             backend),
        nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"13c: the processes did not end within "
                                     f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(world):
        with open(work / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    shutil.rmtree(work, ignore_errors=True)
    o = outs[0]
    err = dict(
        ba_step=max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(o["step2"][1:], o["step1"][1:])),
        gba_pcg=max(float(np.abs(o["pcg2"][k] - o["pcg1"][k]).max())
                    for k in ("kf_t", "points")),
        viba_p=float(np.abs(o["viba2"]["p_w"] - o["viba1"]["p_w"]).max()),
        viba_v=float(np.abs(o["viba2"]["v_w"] - o["viba1"]["v_w"]).max()))
    p = inp["pcg"]
    pc = (np.einsum("oij,oj->oi", o["pcg2"]["kf_R"][p["obs_cam"]],
                    o["pcg2"]["points"][p["obs_pt"]])
          + o["pcg2"]["kf_t"][p["obs_cam"]])
    pred = cameras.project(cam, torch.from_numpy(pc)).numpy()
    rms = float(np.sqrt(np.mean(np.sum((pred - p["obs_uv"]) ** 2, -1))))
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for key in ("step2", "pcg2", "viba2") for x in outs[1:]
               for a, b in zip(_leaves(o[key]), _leaves(x[key])))
    gba = o["gba"]
    rec = dict(world=world, backend=backend, max_err=err, tol=SHARD_TOL,
               pcg_rms_px=rms,
               ranks_equal=same, viba_on=viba_src,
               viba_shape=dict(C=int(inp["viba"]["R_wb"].shape[0]),
                               O=int(inp["viba"]["obs_cam"].shape[0])),
               ms=o["ms"], ms_rank1=outs[1]["ms"], served=outs[1]["served"],
               racing_gba={k: v for k, v in gba.items() if k != "log"},
               racing_gba_log=gba["log"], sharded=o["gba_sharded"],
               seconds=time.perf_counter() - t0)
    log(f"13c sharded solves at world {world} over {backend} against world "
        f"1: largest differences {err} (tolerances {SHARD_TOL}); PCG at "
        f"C = 192 rms {rms:.4f} px; every rank equal {same}; inertial BA on "
        f"{viba_src} {rec['viba_shape']}; clocks (ms) {o['ms']}; racing "
        f"global BA sharded {o['gba_sharded']}: error {gba['err0']:.4f} -> "
        f"{gba['err1']:.4f} m, runs {gba['runs']}, aborted {gba['aborted']}, "
        f"map kept on abort {gba['kept']}; rank 1 served {rec['served']} "
        f"jobs; {rec['seconds']:.1f} s")
    bad = [k for k, v in err.items() if not v <= SHARD_TOL[k]]
    if (bad or not rms < 1.0 or not same or not o["gba_sharded"]
            or gba["runs"] != 1 or gba["aborted"] < 1 or not gba["kept"]
            or not gba["err1"] < 0.5 * gba["err0"] or rec["served"] < 5):
        raise AssertionError(f"13c missed its gates ({bad}): {rec}")
    return rec


def _leaves(tree):
    """The leaves of a nested dict / list of arrays, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def multi_device_phase(dev) -> dict:
    """Phase 13: 13a, 13b and 13c, each sub-phase's time logged."""
    log("phase 13 the multi-device layer: 13a batched extraction, 13b "
        "System.track_monocular_batch, 13c the sharded solves in two "
        "processes on the card")
    out, t = {"seconds": {}}, [time.perf_counter()]
    for name, key, run_sub in (
            ("13a", "extract", lambda: batch_extract_path(dev)),
            ("13b", "ingest", lambda: batch_ingest_path(dev)),
            ("13c", "sharded", lambda: sharded_path(dev))):
        out[key] = run_sub()
        t.append(time.perf_counter())
        out["seconds"][name] = t[-1] - t[-2]
        log(f"{name} took {t[-1] - t[-2]:.1f} s")
    return out


# phase 14: the repo's tools on the port (torch:tools/)
# tests/test_placerec.py::test_vocab_domain_shift_gate's case and gates
VOCAB_CASE = dict(n_worlds=10, frames_per_world=8, seed0=50_000)
VOCAB_GATES = dict(top1=0.88, margin=3.0, angle=1e-4)
VOCAB_CPU_FRAMES = 2
# 14b: train_vocab at L = 3 on 12 worlds x 10 frames; its blob-domain
# retrieval on 6 held-out worlds x 8 frames (no gate: no JAX test has
# this size)
TRAIN_CASE = dict(levels=3, n_worlds=12)
TRAIN_EVAL = dict(n_worlds=6, frames_per_world=8)
PROFILE_FRAMES = 16


def block_launches(n_frames, n_levels=8):
    """Each extraction kernel's launches over n_frames frames extracted in
    blocks of INGEST_BLOCK_MULTIPLE (the last may be smaller): ceil(8B /
    16) a block of B; the searches none."""
    from orb_slam3_detailed_comments_tpu_torch.parallel import batch_extract
    B = batch_extract.INGEST_BLOCK_MULTIPLE
    n = sum(-(-n_levels * min(B, n_frames - s) // 16)
            for s in range(0, n_frames, B))
    return dict({k: n for k in EXTRACT_KERNELS}, hamming_best2=0,
                hamming_best2_windowed=0)


def features_card_vs_cpu(dev, voc, voc_cpu, imgs, feat, cfg):
    """The card's features (``feat``, the first frames of a block) and
    word ids against the CPU's extraction of the same images: every field
    equal but the angle (the devices' atan2 part by ulps), held within
    VOCAB_GATES["angle"] rad; where they part, ``frontend_diff``'s
    account."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor
    from orb_slam3_detailed_comments_tpu_torch.placerec import vocab
    cpu = torch.device("cpu")
    fc = extractor.extract_batch(imgs.to(cpu), cfg)
    rec = dict(frames=len(imgs), differing=[], max_angle_diff=0.0,
               words_differing=0)
    for b in range(len(imgs)):
        fg = extractor.FrameFeatures(*(x[b].to(cpu) for x in feat))
        fb = extractor.FrameFeatures(*(x[b] for x in fc))
        for name in fg._fields:
            if name != "angle" and not torch.equal(getattr(fg, name),
                                                   getattr(fb, name)):
                rec["differing"].append(f"frame {b} {name}")
        d = fg.angle - fb.angle
        rec["max_angle_diff"] = max(rec["max_angle_diff"], float(
            torch.atan2(torch.sin(d), torch.cos(d)).abs().max()))
        wg = vocab.transform(voc, feat.desc[b], feat.valid[b]).cpu()
        wc = vocab.transform(voc_cpu, fb.desc, fb.valid)
        rec["words_differing"] += int((wg != wc).sum())
        if rec["differing"]:
            rec.setdefault("diff", []).append(frontend_diff(fg, fb))
    return rec


def vocab_eval_path(dev, case=VOCAB_CASE, gates=VOCAB_GATES,
                    n_cpu=VOCAB_CPU_FRAMES):
    """14a: test_vocab_domain_shift_gate's case in full on dev through
    ``tools.eval_vocab``: for each shifted texture domain, n_worlds x
    frames_per_world frames from seed0, ray-cast on dev and extracted in
    blocks of 8 (``frame_blocks``, the path of ``render_eval_set``), the
    bundled vocabulary's retrieval (``retrieval_metrics``) gated at top1
    >= 0.88 and margin >= 3.0; each extraction kernel launched ceil(8B /
    16) times a block (the counts set to 0 just before each domain's run
    and read just after); the first n_cpu frames' features and word ids
    against the CPU's. Logs each domain's host seconds: textures (on the
    thread), the wait for them, render, extraction, BoW and retrieval."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor
    from orb_slam3_detailed_comments_tpu_torch.placerec import vocab
    from orb_slam3_detailed_comments_tpu_torch.tools import eval_vocab as ev
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    cam = cameras.pinhole(**ev.CAM_KW)
    cfg = extractor.OrbConfig(n_features=ev.N_FEATURES)
    voc = vocab.load(device=dev)
    voc_cpu = vocab.load(device="cpu")
    nw, fpw, seed0 = case["n_worlds"], case["frames_per_world"], case["seed0"]
    want = block_launches(nw * fpw, cfg.n_levels)
    world_of = np.repeat(np.arange(nw), fpw)
    idx = np.tile(np.arange(fpw), nw)
    out = dict(domains={}, launches={k: 0 for k in want}, case=dict(case))
    for name, fn in sr.TEXTURE_DOMAINS.items():
        if name == "blob":
            continue
        stats, descs, valids, first = {}, [], [], None
        t0 = time.perf_counter()
        reset_counts()                      # this domain's run starts here
        for imgs, f in ev.frame_blocks(
                cam, cfg, lambda s, fn=fn: ev.eval_world(s, fn, fpw),
                range(seed0, seed0 + nw), dev, stats):
            first = first or (imgs[:n_cpu], f)
            descs += list(f.desc)
            valids += list(f.valid)
        t1 = time.perf_counter()
        top1, margin = ev.retrieval_metrics(voc, descs, valids, world_of,
                                            idx)
        stats["bow_and_retrieval"] = time.perf_counter() - t1
        launches = dict(native.launches)    # ... and ends here
        stats["wall"] = time.perf_counter() - t0
        cmp = features_card_vs_cpu(dev, voc, voc_cpu, first[0], first[1],
                                   cfg)
        r = out["domains"][name] = dict(top1=top1, margin=margin,
                                        seconds=stats, launches=launches,
                                        card_vs_cpu=cmp)
        for k in want:
            out["launches"][k] += launches[k]
        log(f"14a {name}: top1 {top1:.4f} (gate {gates['top1']}), margin "
            f"{margin:.4f} (gate {gates['margin']}) over {nw * fpw} frames; "
            f"host seconds " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in stats.items())
            + f"; launches {launches} (expected {want}); card against CPU "
            f"on {cmp['frames']} frames: fields differing {cmp['differing']}"
            f", largest angle difference {cmp['max_angle_diff']:.3e} rad, "
            f"{cmp['words_differing']} word ids differing"
            + (f" ({cmp['diff']})" if "diff" in cmp else ""))
        if top1 < gates["top1"] or margin < gates["margin"]:
            raise AssertionError(f"14a {name}: top1 {top1:.4f}, margin "
                                 f"{margin:.4f} below the gates {gates}")
        if (cmp["differing"] or cmp["words_differing"]
                or cmp["max_angle_diff"] > gates["angle"]):
            raise AssertionError(f"14a {name}: card and CPU part: {cmp}")
        if dev.type == "cuda" and launches != want:
            raise AssertionError(f"14a {name}: launches {launches}, "
                                 f"expected {want}")
    return out


def _sha256(path) -> str:
    import hashlib
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def vocab_train_path(dev, case=TRAIN_CASE, eval_case=TRAIN_EVAL):
    """14b: ``tools.train_vocab`` end to end (VOCAB_PHASE all) at L =
    levels on n_worlds x 10 frames on dev, saved under build/phase14/
    (removed after). Gates: the saved file loads back equal to the trained
    vocabulary; the bundled default_vocab.npz hashes the same before and
    after; the extraction kernels launched as blocks of 8 require. Reports
    its blob-domain top1 and margin on eval_case's held-out worlds (no
    gate)."""
    import contextlib
    import io
    import shutil
    import torch
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor
    from orb_slam3_detailed_comments_tpu_torch.placerec import vocab
    from orb_slam3_detailed_comments_tpu_torch.tools import eval_vocab as ev
    from orb_slam3_detailed_comments_tpu_torch.tools import train_vocab
    work = REPO / "build" / "phase14"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out_path = work / f"vocab_L{case['levels']}.npz"
    bundled = _sha256(vocab.DEFAULT_PATH)
    stats, text = {}, io.StringIO()
    try:
        t0 = time.perf_counter()
        reset_counts()                      # this path's run starts here
        with contextlib.redirect_stdout(text):
            voc = train_vocab.run(case["levels"], case["n_worlds"],
                                  str(out_path), "all",
                                  str(work / "desc.npy"), dev, stats)
        launches = dict(native.launches)    # ... and ends here
        stats["wall"] = time.perf_counter() - t0
        back = vocab.load(out_path, dev)
        equal = ((back.k, back.levels) == (voc.k, voc.levels)
                 and np.array_equal(back.idf, voc.idf)
                 and all(torch.equal(a, b) for a, b in zip(back.centroids,
                                                           voc.centroids)))
        t1 = time.perf_counter()
        data = ev.render_eval_set(
            cameras.pinhole(**ev.CAM_KW),
            extractor.OrbConfig(n_features=ev.N_FEATURES),
            eval_case["n_worlds"], eval_case["frames_per_world"], ev.SEED0,
            None, dev)
        top1, margin = ev.retrieval_metrics(back, *data)
        stats["blob_eval"] = time.perf_counter() - t1
        size = out_path.stat().st_size
    finally:
        shutil.rmtree(work, ignore_errors=True)
    after = _sha256(vocab.DEFAULT_PATH)
    want = block_launches(
        case["n_worlds"] * train_vocab.FRAMES_PER_WORLD)
    rec = dict(case=dict(case), n_words=voc.n_words, file_bytes=size,
               round_trip_equal=equal, bundled_unchanged=bundled == after,
               blob_top1=top1, blob_margin=margin,
               blob_eval=dict(eval_case), seconds=stats, launches=launches,
               tool_output=text.getvalue().splitlines())
    log(f"14b train_vocab L={case['levels']} on {case['n_worlds']} worlds: "
        f"{voc.n_words} words, {size} bytes, loads back equal {equal}, "
        f"bundled vocabulary unchanged {bundled == after}; blob-domain "
        f"top1 {top1:.4f}, margin {margin:.4f} on {eval_case} (no gate); "
        f"host seconds " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     stats.items())
        + f"; launches {launches} (expected {want}); the tool said: "
        + " | ".join(rec["tool_output"]))
    if not equal or bundled != after:
        raise AssertionError(f"14b: {rec}")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"14b launches {launches}, expected {want}")
    return rec


def profile_stages_path(dev, n=PROFILE_FRAMES):
    """14c: ``tools.profile_stages`` through its main on n frames of dev:
    it returns 0 and prints the fps line and the stage table (both
    logged); each extraction kernel launched at least once a profiled
    frame (the warmup's frames come on top)."""
    import contextlib
    import io
    import re
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.tools import profile_stages
    text = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()                          # this path's run starts here
    with contextlib.redirect_stdout(text):
        rc = profile_stages.main([str(n), "--device", dev.type])
    launches = dict(native.launches)        # ... and ends here
    lines = text.getvalue().splitlines()
    fps = [ln for ln in lines
           if re.fullmatch(r"total [\d.]+s, [\d.]+ fps, kf=\d+ pts=\d+", ln)]
    head = [i for i, ln in enumerate(lines) if ln.split()[:2] == ["stage",
                                                                  "mean"]]
    rows = lines[head[0] + 1:] if head else []
    rec = dict(frames=n, rc=rc, fps_line=fps, table=rows, launches=launches,
               seconds=time.perf_counter() - t0)
    log(f"14c profile_stages {n}: rc {rc}, {fps}, {len(rows)} stage rows, "
        f"launches {launches}; the tool printed:")
    for ln in lines:
        log("  " + ln)
    if rc != 0 or len(fps) != 1 or not rows:
        raise AssertionError(f"14c: {rec}")
    if dev.type == "cuda" and any(launches[k] < n for k in EXTRACT_KERNELS):
        raise AssertionError(f"14c launches {launches}: fewer than {n}")
    return rec


def tools_phase(dev) -> dict:
    """Phase 14: 14a, 14b and 14c, each sub-phase's time logged."""
    log("phase 14 the repo's tools: 14a the vocabulary's domain-shift gate, "
        "14b train_vocab end to end, 14c profile_stages")
    out, t = {"seconds": {}}, [time.perf_counter()]
    for name, key, run_sub in (
            ("14a", "eval", lambda: vocab_eval_path(dev)),
            ("14b", "train", lambda: vocab_train_path(dev)),
            ("14c", "stages", lambda: profile_stages_path(dev))):
        out[key] = run_sub()
        t.append(time.perf_counter())
        out["seconds"][name] = t[-1] - t[-2]
        log(f"{name} took {t[-1] - t[-2]:.1f} s")
    return out


# ---------------------------------------------------------------- phase 15
# 15a's card-against-CPU frame: the first track_step_inertial_lf from this
# frame on, with its frame's prepare_frame_stereo_fisheye
FLAGSHIP_REPLAY_FROM = 30
FLAGSHIP_REPLAY = dict(match=0.99, tol=1e-3)


def metric_ate(slam, case):
    """tests/test_pipeline_metric_loops.py's _metric_ate: (rigid ATE, its
    pairs, the Horn scale)."""
    from orb_slam3_detailed_comments_tpu_torch.utils import evaluate_ate
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    rmse, npair, _ = evaluate_ate.ate_rmse(case["ts"], case["centers"],
                                           est_ts, est, with_scale=False)
    _, _, scale = evaluate_ate.ate_rmse(case["ts"], case["centers"], est_ts,
                                        est, with_scale=True)
    return rmse, npair, scale


def correction_parts(parts, lc, m, sync=lambda: None):
    """Time a loop correction's parts into parts (host ms by part): the
    essential graph, the full inertial BA, the visual global BA, the loop
    fuse, the point stats. Returns the undo."""
    from orb_slam3_detailed_comments_tpu_torch.pipeline import (
        inertial, loop_closing)
    undo = [time_part(parts, obj, name, label, sync)
            for obj, name, label in (
                (loop_closing, "_chain_covis_edges", "graph"),
                (loop_closing, "_solve_essential_graph", "graph"),
                (loop_closing, "_apply_pose_graph", "graph"),
                (inertial, "run_full_inertial_ba", "full inertial BA"),
                (loop_closing, "run_local_ba", "global BA"),
                (lc, "_fuse_loop_points", "fuse"),
                (m, "update_point_stats", "point stats"))]

    def restore():
        for u in reversed(undo):
            u()
    return restore


def watch_corrections(slam, frame, corrections, sync):
    """Log each loop correction of slam's loop closer (once it is built):
    the frame tracked when it ran, its keyframes' frames, its branch (Sim3
    or SE3 on a visual map, 4DoF on an inertial one, yaw-only after VIBA2,
    refused by the gravity gate), its global BAs' tiers and C, its host
    clock by part (in the async mode the worker's, unsynchronised)."""
    build = slam._build_recognition

    def build_hooked(*a, **k):
        build(*a, **k)
        lc = slam.loop_closer
        correct = lc._correct_loop

        def logged(k_, c, S):
            m = lc.map
            inertial_map = bool(m.imu_initialized)
            rejected0, gba0 = lc.n_loops_rejected_gravity, lc.n_gba_runs
            parts = {}
            restore = correction_parts(parts, lc, m, sync)
            sync()
            t0 = time.perf_counter()
            try:
                out = correct(k_, c, S)
                sync()
            finally:
                restore()
            ms = (time.perf_counter() - t0) * 1e3
            branch = ("refused by the gravity gate"
                      if lc.n_loops_rejected_gravity > rejected0
                      else "yaw-only (after VIBA2)"
                      if inertial_map and m.imu_ba2 else "4DoF"
                      if inertial_map else "SE3" if lc.cfg.fix_scale
                      else "Sim3")
            rec = dict(k=int(k_), c=int(c), at_frame=frame[0],
                       frame=int(m.kf_frame_id[k_]),
                       match_frame=int(m.kf_frame_id[c]), branch=branch,
                       closed=bool(out), n_kf=int(m.n_kf), ms=ms,
                       parts_ms={key: round(v, 1)
                                 for key, v in parts.items()})
            rec["parts_ms"]["gate and set-up"] = round(
                ms - sum(parts.values()), 1)
            if out and lc.n_gba_runs > gba0:
                rec["gba"] = list(lc.last_correction.get("gba", []))
            elif out and lc.cfg.async_gba:
                rec["gba"] = "launched on its thread"
            corrections.append(rec)
            return out
        lc._correct_loop = logged

    slam._build_recognition = build_hooked
    return lambda: slam.__dict__.pop("_build_recognition", None)


def long_path(dev, name, progress=40):
    """Drive the port's System over the long case long_case(name) on dev,
    every frame rendered on dev outside the frame's clock. Returns (slam,
    record): frames tracked, the keyframe count ahead of each frame, the
    maps, loops closed, each correction (watch_corrections), the racing
    global BA's runs, aborts and log, the IMU stages with their frames and
    host clocks, the stereo gauntlet's loops and metric ATE after frame
    0.8 n, each frame's host clock and the steady frames' median and p90
    (tracked by the fused step, no reference-keyframe search, no keyframe
    made, no correction or IMU stage), the kernels' launches against what
    the frames and searches require, the seconds; 15a also the first
    track_step_inertial_lf from FLAGSHIP_REPLAY_FROM on and its frame's
    prepare_frame_stereo_fisheye inputs."""
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.optim import ba
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels, system
    t_start = time.perf_counter()
    case = long_case(name)
    n, ts, win = case["n"], case["ts"], case["windows"]
    slam = system.System(case["cam"], case["sensor"], device=dev,
                         **case["system_kw"])
    tk, lm = slam.tracker, slam.local_mapper
    sync = torch_sync(dev)
    frame, corrections, n_fuse, made_kf, calls = [0], [], [0], [], {}
    process, post = lm.process_keyframe, slam._post_track
    real_stage = slam._imu_stage

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event.get("fuse_searches", 0)

    def post_track(pose, t_=0.0):
        made_kf.append(bool(tk.new_keyframes))
        return post(pose, t_)

    def timed_stage(*a, **kw):
        n0 = len(slam.imu_events)
        sync()
        t1 = time.perf_counter()
        took = real_stage(*a, **kw)
        sync()
        if len(slam.imu_events) > n0:
            slam.imu_events[-1].update(
                host_ms=(time.perf_counter() - t1) * 1e3, frame=frame[0])
        return took

    def keep(key):
        def kept(a, kw, out):
            if (name == "flagship" and frame[0] >= FLAGSHIP_REPLAY_FROM
                    and not any(len(c) == 2 for c in calls.values())):
                calls.setdefault(frame[0], {}).setdefault(key, (a, kw))
        return kept

    lm.process_keyframe, slam._post_track = counted, post_track
    slam._imu_stage = timed_stage
    undo = [watch_corrections(slam, frame, corrections,
                              (lambda: None) if slam._async else sync),
            _capture(kernels, "prepare_frame_stereo_fisheye",
                     keep("prepare")),
            _capture(kernels, "track_step_inertial_lf", keep("lf"))]
    stereo = case["extractions"] == 2
    poses, times, kf_before, steady, probe = [], [], [], [], {}
    imgs = None
    reset_counts()                          # this path's run starts here
    try:
        for i in range(n):
            frame[0] = i
            imgs = case["frame"](i, dev)
            kf_before.append(slam.n_keyframes)
            steps0, ref0 = tk.n_steps, tk.n_ref_kf_searches
            ev0, corr0 = len(slam.imu_events), len(corrections)
            sync()
            t0 = time.perf_counter()
            if stereo:
                pose = slam.track_stereo(*imgs, float(ts[i]),
                                         imu=None if win is None else win[i])
            elif win is not None:
                pose = slam.track_monocular(imgs, float(ts[i]), imu=win[i])
            else:
                pose = slam.track_monocular(imgs, float(ts[i]))
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            poses.append(pose)
            if (pose is not None and tk.n_steps > steps0
                    and tk.n_ref_kf_searches == ref0 and not made_kf[-1]
                    and len(slam.imu_events) == ev0
                    and len(corrections) == corr0):
                steady.append(i)
            if name == "stereo_gauntlet" and i == int(0.80 * n):
                probe = dict(n_before=slam.loop_closer.n_loops_closed,
                             ate_before=metric_ate(slam, case))
            if progress and (i % progress == 0 or i == n - 1):
                lc = slam.loop_closer
                log(f"  {name} frame {i}: {sum(p is not None for p in poses)}"
                    f" tracked, {slam.n_keyframes} KF, "
                    f"{len(slam.atlas.maps)} map(s), loops "
                    f"{lc.n_loops_closed if lc is not None else 0}, "
                    f"{times[-1]:.1f} ms, {time.perf_counter() - t_start:.1f}"
                    f" s")
        if slam._async:
            slam.shutdown()                 # drains the worker queue
        launches = dict(native.launches)    # ... and ends here
    finally:
        for u in undo:
            u()
        lm.process_keyframe = process
        slam.__dict__.pop("_post_track", None)
        slam.__dict__.pop("_imu_stage", None)
    expect = expected_launches(tk, n, n_fuse[0], case["extractions"])
    expect["gather_patches"] += case["sad"] * n
    lc = slam.loop_closer
    rec = dict(case=name, test=case["test"], n_frames=n,
               tracked=sum(p is not None for p in poses),
               keyframes=slam.n_keyframes, maps=len(slam.atlas.maps),
               loops_closed=lc.n_loops_closed if lc is not None else 0,
               rejected_gravity=(lc.n_loops_rejected_gravity
                                 if lc is not None else 0),
               corrections=corrections,
               gba_runs=lc.n_gba_runs if lc is not None else 0,
               gba_aborted=lc.n_gba_aborted if lc is not None else 0,
               gba_log=[dict(g, tier="inertial" if g["kind"] == "inertial"
                             else ba.tier_of(g["C"]))
                        for g in (lc.gba_log if lc is not None else [])],
               imu_events=list(slam.imu_events), kf_before=kf_before,
               backpressure_waits=slam.n_backpressure_waits,
               launches=launches, expected=expect, **probe,
               frame_ms=_stats(times),
               steady=_stats([times[i] for i in steady]),
               seconds=time.perf_counter() - t_start)
    rec["revisit_loops"] = sum(c["closed"] and c["match_frame"] < n // 2
                               <= c["frame"] for c in corrections)
    rec["branches"] = {}
    for c in corrections:
        rec["branches"][c["branch"]] = rec["branches"].get(c["branch"], 0) + 1
    rec["replay_calls"] = calls
    return slam, rec


def long_gates(name, slam, rec):
    """The JAX test's gates (LONG_TESTS[name]) on a long_path run: the
    names of those missed, with their values."""
    from orb_slam3_detailed_comments_tpu_torch.imu import factors
    from orb_slam3_detailed_comments_tpu_torch.pipeline.inertial import (
        GRAVITY_MAG)
    from orb_slam3_detailed_comments_tpu_torch.utils import evaluate_ate
    case = long_case(name)
    ts, centers = case["ts"], case["centers"]
    n, m, lc = rec["n_frames"], slam.map, slam.loop_closer
    fails = []

    def gate(what, ok, value=None):
        if not ok:
            fails.append(f"{what}: {value}")

    gate("frames tracked", rec["tracked"] > 0.8 * n, rec["tracked"])
    rows = slam.trajectory_tum()
    est_ts = np.array([r[0] for r in rows])
    est = np.array([r[1:4] for r in rows])
    kids = m.kf_ids()
    fid = m.kf_frame_id[kids]
    kids, fid = kids[fid >= 0], fid[fid >= 0]
    kf_c = np.einsum("nij,nj->ni", np.transpose(m.kf_R[kids], (0, 2, 1)),
                     -m.kf_t[kids])
    if name != "flagship":
        gate("one map", rec["maps"] == 1, rec["maps"])
        gate("loops closed", lc is not None and lc.n_loops_closed >= 1,
             rec["loops_closed"])
    if name in ("flagship", "kb8_loop"):
        gate("IMU initialised", m.imu_initialized)
        chain = m.temporal_chain()
        bg_err = float(np.abs(m.kf_bg[chain[-1]] - LONG_BG).max())
        rec["bg_err"] = bg_err
        gate("gyro bias", bg_err < 8e-3, bg_err)
        rmse, npair, _ = evaluate_ate.ate_rmse(ts, centers, est_ts, est,
                                               with_scale=False)
        _, _, scale = evaluate_ate.ate_rmse(ts, centers, est_ts, est,
                                            with_scale=True)
        rec.update(ate_m=rmse, ate_poses=npair, scale=scale)
        gate("ATE poses", npair > 0.7 * n, npair)
        gate("metric ATE", rmse < (0.05 if name == "flagship" else 0.25),
             rmse)
        gate("scale", abs(scale - 1.0) < (0.04 if name == "flagship"
                                          else 0.06), scale)
        if name == "kb8_loop":
            gate("VIBA1 and VIBA2", m.imu_ba1 and m.imu_ba2)
            gate("fix_scale", lc.cfg.fix_scale is True)
            gate("map consistency", slam.check_map_consistency() == [])
        return fails
    if name == "stereo_gauntlet":
        gate("fix_scale", lc.cfg.fix_scale is True)
        gate("closed in the revisit", lc.n_loops_closed > rec["n_before"]
             or rec["n_before"] >= 1, rec["n_before"])
        gate("pre-loop metric ATE", rec["ate_before"][0] < 0.15,
             rec["ate_before"])
        rmse, npair, scale = metric_ate(slam, case)
        rec.update(ate_m=rmse, ate_poses=npair, scale=scale)
        gate("ATE poses", npair > 0.8 * n, npair)
        gate("post-loop metric ATE", rmse < 0.06, rmse)
        gate("scale", abs(scale - 1.0) < 0.01, scale)
        gate("keyframes", len(kids) >= 40, len(kids))
        C = centers[fid]
        mu_e, mu_g = kf_c.mean(0), C.mean(0)
        U, _, Vt = np.linalg.svd((kf_c - mu_e).T @ (C - mu_g))
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        aligned = (kf_c - mu_e) @ (Vt.T @ D @ U.T).T + mu_g
        rmse_kf = float(np.sqrt(((aligned - C) ** 2).sum(1).mean()))
        rec["kf_ate_m"] = rmse_kf
        gate("KF-only metric ATE", rmse_kf < 0.04, rmse_kf)
        gate("map consistency", slam.check_map_consistency() == [])
        return fails
    # the three 520-frame gauntlets
    rmse, npair, scale = evaluate_ate.ate_rmse(ts, centers, est_ts, est)
    rec.update(ate_m=rmse, ate_poses=npair, scale=scale)
    gate("ATE poses", npair > 0.8 * n, npair)
    gate("keyframes", len(kids) >= 60, len(kids))
    _, _, _, aligned = evaluate_ate.align_horn(kf_c, centers[fid])
    rmse_kf = float(np.sqrt(((aligned - centers[fid]) ** 2).sum(1).mean()))
    rec["kf_ate_m"] = rmse_kf
    if name == "stress":
        gate("ATE", rmse < 0.08, rmse)
        gate("KF-only ATE", rmse_kf < 0.02, rmse_kf)
        gate("map consistency", slam.check_map_consistency() == [])
    elif name == "stress_async":
        gate("racing global BA", lc.n_gba_runs + lc.n_gba_aborted >= 1)
        gate("KF-only ATE", rmse_kf < 0.04, rmse_kf)
        gate("map consistency", slam.check_map_consistency() == [])
        gate("ATE", rmse < 0.15, rmse)
    else:
        gate("IMU initialised", m.imu_initialized)
        kb = rec["kf_before"]
        first = lambda u: next(i for i in range(n) if i / n > u)
        blackout = (kb[first(0.30)], kb[first(0.36)])
        rec["kf_blackout"] = blackout
        gate("keyframes through the blackout", blackout[1] > blackout[0],
             blackout)
        gate("scale", abs(scale - 1.0) < 0.02, scale)
        gate("ATE", rmse < 0.10, rmse)
        gate("KF-only ATE", rmse_kf < 0.03, rmse_kf)
        res = chain_preintegration_residuals(m, factors, GRAVITY_MAG)
        rec["chain_residuals"] = res
        gate("chain edges", res["edges"] > 0.8 * (res["chain"] - 1), res)
        gate("median rot residual", res["er"] < 0.005, res["er"])
        gate("median vel residual", res["ev"] < 0.02, res["ev"])
        gate("median pos residual", res["ep"] < 0.01, res["ep"])
    return fails


def chain_preintegration_residuals(m, factors, gravity_mag):
    """test_long_adversarial_inertial_loop's post-GBA check: every
    preintegration edge of the temporal chain re-evaluated at the optimised
    states (camera == body); the edge count and the median rotation,
    velocity and position residual norms."""
    import torch
    chain = m.temporal_chain()
    g = torch.tensor([0.0, 0.0, -gravity_mag], dtype=torch.float32)
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    ers, evs, eps = [], [], []
    for a, b in zip(chain[:-1], chain[1:]):
        if m.kf_prev[b] != a or m.kf_pre_dT[b] <= 0:
            continue
        pre = m.get_kf_preintegration(np.asarray([b]))
        pre1 = type(pre)(*[x[0].cpu() for x in pre])
        r = factors.inertial_residual(
            T(m.kf_R[a].T), T(-m.kf_R[a].T @ m.kf_t[a]), T(m.kf_vel[a]),
            T(m.kf_R[b].T), T(-m.kf_R[b].T @ m.kf_t[b]), T(m.kf_vel[b]),
            T(m.kf_bg[a]), T(m.kf_ba[a]), pre1, g).numpy()
        ers.append(np.linalg.norm(r[0:3]))
        evs.append(np.linalg.norm(r[3:6]))
        eps.append(np.linalg.norm(r[6:9]))
    return dict(chain=len(chain), edges=len(ers),
                er=float(np.median(ers)) if ers else None,
                ev=float(np.median(evs)) if evs else None,
                ep=float(np.median(eps)) if eps else None)


def flagship_replay(calls, dev):
    """15a's card against CPU: the first frame from FLAGSHIP_REPLAY_FROM on
    whose prepare_frame_stereo_fisheye and track_step_inertial_lf calls
    were kept, each run again on the card and on the CPU from the same
    inputs: where the left and right features part (frontend_diff), the
    depth-valid sets' agreement, and phase 9's step check (match_pt
    agreement, pose and velocity differences)."""
    import torch
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor
    from orb_slam3_detailed_comments_tpu_torch.pipeline import kernels
    both = [f for f in sorted(calls) if len(calls[f]) == 2]
    if not both:
        raise AssertionError(f"15a: no prepare_frame_stereo_fisheye + "
                             f"track_step_inertial_lf frame from "
                             f"{FLAGSHIP_REPLAY_FROM} on")
    f = both[0]
    a, kw = calls[f]["prepare"]
    cpu = torch.device("cpu")
    card = kernels.prepare_frame_stereo_fisheye(*a, **kw)
    host = kernels.prepare_frame_stereo_fisheye(*_tensors_to(a, cpu),
                                                **_tensors_to(kw, cpu))
    orb_cfg = a[6]
    right = [extractor.extract(img, orb_cfg) for img in (a[1], a[1].cpu())]
    zg, zc = card[1].cpu().numpy() > 0, host[1].numpy() > 0
    out = dict(frame=f, left=frontend_diff(card[0].feat, host[0].feat),
               right=frontend_diff(*right),
               depth_valid_agree=float((zg == zc).mean()),
               step=inertial_step_replay(calls[f]["lf"], dev))
    st = out["step"]
    out["ok"] = (out["left"]["keypoints"] == 0
                 and out["right"]["keypoints"] == 0
                 and st["match_equal"] >= FLAGSHIP_REPLAY["match"]
                 and max(st["R"], st["t"], st["v"]) < FLAGSHIP_REPLAY["tol"])
    return out


def long_summary(rec):
    """A long case's record for the log and the JSON line: the per-frame
    lists and launch counts apart."""
    return {k: v for k, v in rec.items()
            if k not in ("kf_before", "replay_calls", "launches")}


def long_phase(dev, keys) -> dict:
    """Phase 15: each long case named in keys (15a-15f) through long_path,
    held to its JAX test's gates with exact launch counts; 15a also card
    against CPU on one frame (flagship_replay). Each case's summary is
    logged before a missed gate raises."""
    out = {}
    for key in keys:
        name = LONG_PHASES[key]
        log(f"phase {key} {name}: {LONG_TESTS[name]}, at its full depth")
        slam, rec = long_path(dev, name)
        fails = long_gates(name, slam, rec)
        if dev.type == "cuda":
            fails += [f"{k}: {rec['launches'][k]} launches, expected {want}"
                      for k, want in rec["expected"].items()
                      if rec["launches"][k] != want
                      or (want == 0 and k != "hamming_best2")]
        if name == "flagship":
            rec["replay"] = flagship_replay(rec["replay_calls"], dev)
            if not rec["replay"]["ok"]:
                fails.append(f"card against CPU: {rec['replay']}")
        log(f"{key} {name}: {rec['tracked']}/{rec['n_frames']} frames "
            f"tracked, {rec['keyframes']} KF, {rec['maps']} map(s); "
            f"{rec['loops_closed']} loops closed, {rec['rejected_gravity']} "
            f"refused by the gravity gate, branches {rec['branches']}, "
            f"{rec['revisit_loops']} across the revisit; global BA "
            f"{rec['gba_runs']} run / {rec['gba_aborted']} aborted; ATE "
            f"{rec.get('ate_m')} m over {rec.get('ate_poses')} (scale "
            f"{rec.get('scale')}), KF-only {rec.get('kf_ate_m')}, bg error "
            f"{rec.get('bg_err')}; steady frames {rec['steady']}, all "
            f"{rec['frame_ms']}; {rec['seconds']:.1f} s")
        for c in rec["corrections"]:
            log(f"  {key} correction KF {c['k']} (frame {c['frame']}) <- "
                f"{c['c']} (frame {c['match_frame']}) at frame "
                f"{c['at_frame']}, {c['n_kf']} KF: {c['branch']}, closed "
                f"{c['closed']}, global BA {c.get('gba')}, {c['ms']:.1f} ms "
                f"by part {c['parts_ms']}")
        log(f"  {key} racing global BAs {rec['gba_log']}; IMU stages "
            f"{rec['imu_events']}; backpressure waits "
            f"{rec['backpressure_waits']}; launches {rec['launches']} "
            f"(expected {rec['expected']})")
        if "replay" in rec:
            log(f"  {key} card against CPU on frame {rec['replay']['frame']}"
                f": {rec['replay']}")
        out[key] = long_summary(rec)
        out[key]["launches"] = rec["launches"]
        if fails:
            raise AssertionError(f"{key} {name} missed its gates: {fails}")
    return out


PHASE_NAMES = ("3", "9", "10", "11", "12", "13", "14") + tuple(LONG_PHASES)
USAGE = ("usage: chip_smoke.py [--phases 3,9,10,11,12,13,14,15a,15b,15c,15d,"
         "15e,15f]")


def main(argv=None) -> int:
    """argv: optionally ``--phases 3,9,10,11,12,13,14,15a,...`` to run only
    those of phases 3, 9-14 and 15a-15f (phases 1 and 2 always run; the
    last lines then carry what ran). 15b-15f, the long opt-in cases, run
    only so, each alone in a call of its own."""
    import torch
    argv = sys.argv[1:] if argv is None else argv
    phases = None
    if argv[:1] == ["--phases"] and len(argv) == 2:
        phases = {p.strip() for p in argv[1].split(",")}
    if argv and (phases is None or not phases <= set(PHASE_NAMES)):
        print(USAGE, file=sys.stderr)
        return 2
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
            return run(torch.device("cuda"), phases)
        finally:
            LOG_COPY.remove(copy)


def run(dev, phases=None) -> int:
    """Phases 1-14 and 15a on the card dev (or 1, 2 and those named in
    phases); raises on the first failure."""
    import torch
    t_start = time.perf_counter()
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

    rates = int_rates()
    if phases is not None:
        return run_some(dev, phases, rates, card, t_start)
    log("phase 3 kernels against their plain versions")
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
    log("phase 6 System: monocular at its defaults (loop closing on), its "
        "own map")
    sys_rec = system_path(dev)
    phase_done("phase 6")
    log("phase 7 System: stereo, RGB-D and fisheye stereo, loop closing off")
    st = stereo_path(dev)
    phase_done("phase 7")
    log(f"phase 8a loop: the first {LOOP_FEED} of 140 frames around the box "
        f"world, loop closing and global BA")
    loop = loop_path(dev, n_feed=LOOP_FEED)
    phase_done("phase 8a")
    log("phase 8b relocalisation after a blackout")
    reloc = reloc_path(dev)
    phase_done("phase 8b")
    log("phase 8c two sequences, two maps, one merge")
    merge = merge_path(dev)
    phase_done("phase 8c")
    imu = inertial_phase(dev)
    phase_done("phase 9")
    ph10 = async_phase(dev, sys_rec)
    phase_done("phase 10")
    ph11 = metric_loop_phase(dev)
    phase_done("phase 11")
    ph12 = host_phase(dev)
    phase_done("phase 12")
    ph13 = multi_device_phase(dev)
    phase_done("phase 13")
    ph14 = tools_phase(dev)
    phase_done("phase 14")
    ph15 = long_phase(dev, ["15a"])
    phase_done("phase 15a")
    paths = (("steady", res), ("bootstrap", boot), ("system", sys_rec),
             ("stereo", st["stereo"]), ("rgbd", st["rgbd"]),
             ("fisheye", st["fisheye"]), ("loop", loop),
             ("relocalisation", reloc), ("merge", merge),
             ("imu_mono", imu["mono"]), ("imu_stereo", imu["stereo"]),
             ("imu_rgbd", imu["rgbd"]), ("async_mono", ph10["mono"]),
             ("async_loop", ph10["loop"]),
             ("rgbd_merge", ph11["rgbd_merge"]), ("vi_loop", ph11["vi_loop"]),
             ("host_surfaces", ph12["surfaces"]),
             ("batch_extract", ph13["extract"]),
             ("batch_ingest", ph13["ingest"]), ("vocab_eval", ph14["eval"]),
             ("vocab_train", ph14["train"]),
             ("profile_stages", ph14["stages"]), ("flagship", ph15["15a"]))
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
            "event_ms", "plain_event_ms", "atlas", "stereo", "callers",
            "batched", "unit", "launches_by_path", "real_frame_ms")
    summary = dict(frame_ms_median=res["frame_ms_median"],
                   frame_ms_p90=res["frame_ms_p90"],
                   host_syncs_per_frame=res["syncs"], **res["profile"])
    boot_summary = {k: v for k, v in boot.items() if k != "launches"}
    sys_summary = {k: v for k, v in sys_rec.items() if k != "launches"}
    st_summary = {name: {k: v for k, v in run.items()
                         if k not in ("launches", "how")}
                  for name, run in st.items()}
    phase8 = {name: {k: v for k, v in run.items() if k != "launches"}
              for name, run in (("loop", loop), ("relocalisation", reloc),
                                ("merge", merge))}
    phase9 = {name: {k: v for k, v in run.items()
                     if k not in ("launches", "how")}
              for name, run in imu.items()
              if name in ("mono", "stereo", "rgbd")}
    phase9["jacobian_routes"] = imu["jacobian_routes"]
    log(f"the whole script took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                for r in rec],
                    "frame": summary, "bootstrap": boot_summary,
                    "system": sys_summary, "stereo": st_summary,
                    "phase8": phase8, "phase9": phase9,
                    "phase10": phase_summary(ph10),
                    "phase11": phase_summary(ph11),
                    "phase12": phase_summary(ph12),
                    "phase13": phase_summary(ph13),
                    "phase14": phase_summary(ph14),
                    "phase15": phase_summary(ph15),
                    "launches_by_path": {path: run["launches"]
                                         for path, run in paths},
                    "bound_rates": rates,
                    "event_time_in_place_of_device_time": EVENT_FALLBACKS}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def inertial_phase(dev) -> dict:
    """Phase 9: the Jacobian routes, then 9a, 9b and 9c."""
    log("phase 9 visual-inertial: the Jacobian routes, then 9a "
        "IMU_MONOCULAR at its defaults, 9b IMU_STEREO and 9c IMU_RGBD")
    out = dict(jacobian_routes=jacobian_routes(dev))
    out["mono"] = inertial_path(dev, "mono", profile_from=-1)
    out["stereo"] = inertial_path(dev, "stereo")
    out["rgbd"] = inertial_rgbd(dev)
    return out


def inertial_rgbd(dev, cam_kw=IMU_CAM_KW, n=12):
    """9c: System(cam, IMU_RGBD, baseline=0.11) on the card takes IMU
    windows: the first n frames of 9b's sequence with their exact depth
    maps (ray-cast on dev); every frame tracked from the depth map's
    initialisation on frame 0, each window preintegrated on the card, the
    launches those of n RGB-D frames. No JAX test has this case: no
    accuracy gate beyond the poses."""
    from orb_slam3_detailed_comments_tpu_torch import native
    from orb_slam3_detailed_comments_tpu_torch.models import cameras
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system
    from orb_slam3_detailed_comments_tpu_torch.utils import synth_render as sr
    cam = cameras.pinhole(**cam_kw)
    planes = sr.default_world(np.random.default_rng(13))
    traj = sr.inertial_trajectory(n, true_bg=IMU_STEREO_BG)
    frames = [render_host_depth(cam, planes, traj["R_cw"][i],
                                traj["t_cw"][i], dev) for i in range(n)]
    slam = system.System(cam, system.IMU_RGBD, baseline=BASELINE,
                         enable_loop_closing=False, device=dev)
    lm, n_fuse = slam.local_mapper, [0]
    process = lm.process_keyframe

    def counted(k):
        process(k)
        n_fuse[0] += lm.last_event["fuse_searches"]

    lm.process_keyframe = counted
    reset_counts()                          # this path's run starts here
    poses = [slam.track_rgbd(img, depth, float(traj["ts"][i]),
                             imu=traj["windows"][i])
             for i, (img, depth) in enumerate(frames)]
    launches = dict(native.launches)        # ... and ends here
    lm.process_keyframe = process
    tk = slam.tracker
    pre = tk.imu.pre_last_frame
    rec = dict(tracked=sum(p is not None for p in poses), n_frames=n,
               keyframes=slam.n_keyframes, launches=launches,
               window_dT=float(pre.dT) if pre is not None else None,
               window_device=str(pre.dT.device) if pre is not None else None)
    log(f"9c IMU_RGBD: {rec['tracked']}/{n} frames tracked, "
        f"{slam.n_keyframes} keyframes, the last window {rec['window_dT']} s "
        f"on {rec['window_device']}; launches {launches}")
    want = dict(dense_frontend=n, cell_topk=n, gather_patches=n,
                hamming_best2=2 * tk.n_ref_kf_searches,
                hamming_best2_windowed=2 * tk.n_steps
                + tk.n_local_map_searches + n_fuse[0])
    if rec["tracked"] != n or pre is None or pre.dT.device.type != dev.type:
        raise AssertionError(f"9c IMU_RGBD: {rec}")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"9c IMU_RGBD: launches {launches}, expected "
                             f"{want}")
    return rec


def run_some(dev, phases, rates, card, t_start) -> int:
    """Only the phases named (3, 9-14, 15a-15f; 10 runs 9a first for its
    map and a synchronous run of its own in place of phase 6's): the
    records of the paths that ran, and the last lines as in a whole
    run."""
    import torch
    out = {}
    if "3" in phases:
        log("phase 3 kernels against their plain versions")
        out["kernels"] = kernel_phase(dev, rates)
    if "9" in phases:
        out["phase9"] = inertial_phase(dev)
    elif "10" in phases:
        log("phase 9a (the map that 10c starts from)")
        inertial_path(dev, "mono")
    if "10" in phases:
        out["phase10"] = phase_summary(async_phase(dev))
    if "11" in phases:
        out["phase11"] = phase_summary(metric_loop_phase(dev))
    if "12" in phases:
        out["phase12"] = phase_summary(host_phase(dev))
    if "13" in phases:
        out["phase13"] = phase_summary(multi_device_phase(dev))
    if "14" in phases:
        out["phase14"] = phase_summary(tools_phase(dev))
    longs = [k for k in LONG_PHASES if k in phases]
    if longs:
        out["phase15"] = phase_summary(long_phase(dev, longs))
    log(f"the script took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({k: (v if k != "phase9" else {
        n: {kk: vv for kk, vv in r.items() if kk != "how"}
        for n, r in v.items()}) for k, v in out.items()}, default=str))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
