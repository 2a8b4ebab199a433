"""What the dataset entry points share: argument parsing, the device
choice, and one loop per dataset layout (EuRoC / TUM-VI, TUM RGB-D,
KITTI). Each entry point module names its sensor, its default output file
and its options, and calls one of these with its argv; the loops make the
same System calls as the JAX package's scripts, in the same order, and
write the same files.
"""
from __future__ import annotations

import time

import numpy as np

from ..pipeline import system as S
from ..utils import clahe, config, datasets


def split_device(argv) -> tuple:
    """(argv without ``--device X`` / ``--device=X``, X or None)."""
    rest, device, i = [], None, 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value (cpu or cuda)")
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def seqs_and_out(args, default_out: str) -> tuple:
    """The multi-sequence scripts' rule: arguments ending in .txt are the
    output, the others sequence directories."""
    seqs = [a for a in args if not a.endswith(".txt")]
    outs = [a for a in args if a.endswith(".txt")]
    return seqs, (outs[0] if outs else default_out)


def equalizer(on: bool):
    """CLAHE(3.0, 8x8) on uint8, as the TUM-VI mains equalise frames
    (mono_tum_vi.cc), or the identity."""
    if not on:
        return lambda im: im
    return lambda im: clahe.clahe(np.asarray(im).astype(np.uint8))


def _fps(t_track) -> float:
    return 1.0 / max(float(np.mean(t_track[-50:])), 1e-9)


def run_euroc(argv, doc: str, *, sensor: int, default_out: str,
              stereo: bool = False, inertial: bool = False,
              equalize: bool = False, pipelined: bool = False,
              rectify: bool = False, kf_trajectory: bool = True,
              save_atlas: bool = False) -> int:
    """EuRoC / TUM-VI layout (mav0/cam{0,1}/data + data.csv, imu0):
    settings, one or more sequences (``change_dataset`` between them) and
    an optional .txt output."""
    args, device = split_device(argv)
    if len(args) < 2:
        print(doc)
        return 1
    seqs, out = seqs_and_out(args[1:], default_out)
    s = config.load_settings(args[0])
    kw = dict(device=device)
    maps_l = maps_r = None
    if rectify:
        # legacy EuRoC yaml: raw cameras + rectification blocks -> rectify
        # here (reference: System::TrackStereo pre-rectification,
        # System.cc:285-292); the rectified pair is a plain pinhole rig
        rect = config.stereo_rectify_maps(s)
        if rect is not None:
            maps_l, maps_r, cam, baseline = rect
            print("using precomputed stereo rectification")
        else:
            cam, baseline = s.camera, s.baseline
        kw.update(camera=cam, baseline=baseline, camera2=None, T_c1c2=None)
    slam = S.System.from_settings(s, sensor, **kw)
    eq = equalizer(equalize)

    def pair(l, r):
        if maps_l is not None:
            l, r = config.rectify(l, maps_l), config.rectify(r, maps_r)
        return eq(l), eq(r)

    t_track = []
    for si, seq in enumerate(seqs):
        if si > 0:
            # multi-sequence: fresh map, welded back by place recognition
            # (reference: System::ChangeDataset, mono_euroc.cc:173-183)
            slam.change_dataset()
        paths, ts = datasets.load_euroc_images(seq, cam="cam0")
        paths_r = (datasets.load_euroc_images(seq, cam="cam1")[0]
                   if stereo else None)
        if inertial:
            imu_ts, gyro, acc = datasets.load_euroc_imu(seq)
            # drop frames before the first IMU sample, as the reference
            first = int(np.searchsorted(ts, imu_ts[0]))
            paths, ts = paths[first:], ts[first:]
            if stereo:
                paths_r = paths_r[first:]
            print(f"[seq {si}] {len(paths)} frames, {len(imu_ts)} IMU "
                  f"samples in {seq}")
        else:
            n = min(len(paths), len(paths_r)) if stereo else len(paths)
            paths, ts = paths[:n], ts[:n]
            if stereo:
                paths_r = paths_r[:n]
            print(f"[seq {si}] {n} {'stereo pairs' if stereo else 'frames'}"
                  f" in {seq}")
        frames = datasets.prefetch_gray(paths, resize_to=s.resize_to)
        frames_r = (datasets.prefetch_gray(paths_r, resize_to=s.resize_to)
                    if stereo else None)
        if pipelined:
            # frame i+1's extraction runs on the card while the host walks
            # frame i's state machine (the same poses as track_*)
            def feed():
                if not stereo:
                    for img, t in zip(frames, ts):
                        yield eq(img), float(t)
                    return
                for i, (l, r) in enumerate(zip(frames, frames_r)):
                    yield *pair(l, r), float(ts[i])

            it = (slam.track_stereo_iter(feed()) if stereo
                  else slam.track_monocular_iter(feed()))
            t0 = time.perf_counter()
            for i, _ in enumerate(it):
                t1 = time.perf_counter()
                t_track.append(t1 - t0)
                t0 = t1
                if i % 50 == 0:
                    print(f"frame {i}/{len(paths)} "
                          f"state={slam.tracker.state} "
                          f"kf={slam.n_keyframes} pts={slam.n_map_points} "
                          f"maps={len(slam.atlas.maps)} "
                          f"{_fps(t_track):.1f} fps")
            continue
        t_prev = ts[0] if len(ts) else 0.0
        pairs = zip(frames, frames_r) if stereo else ((f, None)
                                                      for f in frames)
        for i, ((img, img_r), t) in enumerate(zip(pairs, ts)):
            window = None
            if inertial:
                lo, hi = datasets.imu_between(imu_ts, t_prev, t)
                window = ((acc[lo:hi], gyro[lo:hi], imu_ts[lo:hi])
                          if hi > lo else None)
                t_prev = t
            t0 = time.perf_counter()
            if stereo:
                slam.track_stereo(*pair(img, img_r), float(t), imu=window)
            else:
                slam.track_monocular(eq(img), float(t), imu=window)
            t_track.append(time.perf_counter() - t0)
            if i % 50 == 0:
                print(f"frame {i}/{len(paths)} state={slam.tracker.state} "
                      f"kf={slam.n_keyframes} pts={slam.n_map_points}"
                      + (f" imu_init={slam.map.imu_initialized}"
                         if inertial else "")
                      + f" {_fps(t_track):.1f} fps")
    slam.save_trajectory_tum(out)
    if kf_trajectory:
        slam.save_keyframe_trajectory_tum(out.replace(".txt", "_kf.txt"))
    print(f"median track time {np.median(t_track) * 1e3:.1f} ms; "
          f"saved {out}")
    if save_atlas and s.save_atlas:
        slam.save_atlas(s.save_atlas)
    slam.shutdown()
    return 0


def run_tum(argv, doc: str, *, rgbd: bool, default_out: str) -> int:
    """TUM RGB-D layout (rgb.txt, depth.txt): settings, sequence, optional
    output. Monocular tracks the RGB stream alone; RGB-D associates the
    two streams within 20 ms."""
    args, device = split_device(argv)
    if len(args) < 2:
        print(doc)
        return 1
    seq = args[1]
    out = args[2] if len(args) > 2 else default_out
    s = config.load_settings(args[0])
    rgb_p, rgb_t, d_p, d_t = datasets.load_tum_rgbd(seq)
    if not rgbd:
        slam = S.System.from_settings(s, S.MONOCULAR, device=device)
        n = len(rgb_p)
        print(f"{n} frames in {seq}")
        for i, img in enumerate(datasets.prefetch_gray(
                rgb_p[:n], resize_to=s.resize_to)):
            slam.track_monocular(img, float(rgb_t[i]))
            if i % 50 == 0:
                print(f"frame {i}/{n} state={slam.tracker.state} "
                      f"kf={slam.n_keyframes} pts={slam.n_map_points}")
        slam.save_trajectory_tum(out)
        print(f"saved {out}")
        return 0
    slam = S.System.from_settings(s, S.RGBD, baseline=s.baseline or 0.08,
                                  device=device)
    pairs = datasets.associate_rgbd(rgb_t, d_t)
    print(f"{len(pairs)} associated rgb-depth pairs in {seq}")
    factor = (1.0 / s.depth_map_factor if s.depth_map_factor < 1
              else 5000.0)
    for i, (ri, di) in enumerate(pairs):
        img = config.resize_image(datasets.read_gray(rgb_p[ri]), s.resize_to)
        depth = config.resize_image(datasets.read_depth(d_p[di], factor),
                                    s.resize_to)
        slam.track_rgbd(img, depth, float(rgb_t[ri]))
        if i % 50 == 0:
            print(f"frame {i}/{len(pairs)} state={slam.tracker.state} "
                  f"kf={slam.n_keyframes} pts={slam.n_map_points}")
    slam.save_trajectory_tum(out)
    print(f"saved {out}")
    return 0


def run_kitti(argv, doc: str, *, stereo: bool, default_out: str) -> int:
    """KITTI odometry layout (image_0/, image_1/, times.txt): settings,
    sequence, optional output. Stereo writes the KITTI 3x4 format,
    monocular the TUM format (KITTI's needs metric scale)."""
    args, device = split_device(argv)
    if len(args) < 2:
        print(doc)
        return 1
    seq = args[1]
    out = args[2] if len(args) > 2 else default_out
    s = config.load_settings(args[0])
    slam = S.System.from_settings(s, S.STEREO if stereo else S.MONOCULAR,
                                  device=device)
    lp, rp, ts = datasets.load_kitti_stereo(seq)
    n = min(len(lp), len(rp), len(ts)) if stereo else min(len(lp), len(ts))
    print(f"{n} {'stereo pairs' if stereo else 'frames'} in {seq}")
    t_track = []
    lf = datasets.prefetch_gray(lp[:n], resize_to=s.resize_to)
    rf = (datasets.prefetch_gray(rp[:n], resize_to=s.resize_to) if stereo
          else (None for _ in range(n)))
    for i, (l, r) in enumerate(zip(lf, rf)):
        t0 = time.perf_counter()
        if stereo:
            slam.track_stereo(l, r, float(ts[i]))
        else:
            slam.track_monocular(l, float(ts[i]))
        t_track.append(time.perf_counter() - t0)
        if i % 100 == 0:
            print(f"frame {i}/{n} state={slam.tracker.state} "
                  f"kf={slam.n_keyframes} pts={slam.n_map_points}")
    if stereo:
        slam.save_trajectory_kitti(out)
    else:
        slam.save_trajectory_tum(out)
    print(f"median track {np.median(t_track) * 1e3:.1f} ms; saved {out}")
    return 0
