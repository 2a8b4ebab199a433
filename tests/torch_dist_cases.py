"""The port's multi-process cases, run in ``gloo`` processes on the CPU.

``run_cases(world, cases, inputs, tmp)`` starts ``world`` processes once
(``torch.multiprocessing``, spawn, a ``file://`` rendezvous under tmp),
each with one thread, hands every process the same inputs (numpy arrays,
built by the calling test from seeded generators, with the JAX package
where it needs it) and runs ``cases(rank, group, inputs)`` in each. It
returns every rank's dict of numpy results. This module imports no JAX:
the processes load the port only.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from orb_slam3_detailed_comments_tpu_torch.imu import preintegration as tpre
from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.optim import ba, schur_pcg, vi_ba
from orb_slam3_detailed_comments_tpu_torch.parallel import (batch_extract,
                                                           dist_ba)


def _child(rank, world, init, cases, in_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        out = globals()[cases](rank, dist.group.WORLD, inputs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_cases(world: int, cases: str, inputs: dict, tmp,
              timeout: float = 240.0) -> list:
    """[rank 0's results, rank 1's, ...] of cases (a function of this
    module, by name) over a gloo group of world processes."""
    tmp = str(tmp)
    in_path = os.path.join(tmp, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.start_processes(
        _child, args=(world, os.path.join(tmp, "rendezvous"), cases,
                      in_path, tmp),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{cases}: the processes did not end within "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    return tree


def camera(c) -> cameras.CameraParams:
    """The port's camera from the JAX camera's fields (a tuple)."""
    return cameras.CameraParams(*c)


def ba_problem(arrays) -> ba.BAProblem:
    return ba.problem_from_numpy(dict(zip(ba.BAProblem._fields, arrays)))


def viba_problem(d) -> vi_ba.VIBAProblem:
    return vi_ba.VIBAProblem(**{
        k: (tpre.Preintegrated(*[torch.from_numpy(np.array(x)) for x in v])
            if k == "edge_pre" else torch.from_numpy(np.array(v)))
        for k, v in d.items()})


# ---------------------------------------------------------------- cases
def parallel_cases(rank, group, inp):
    """tests/test_torch_parallel.py: the sharded Schur step, the
    frame-parallel pose optimisation, and the one-process paths."""
    cam = camera(inp["cam"])
    out = {}
    args = list(ba_problem(inp["ba"]))
    step = dist_ba.make_dist_ba_step(cam, group)
    R, t, p = step(*args)
    out["step1"] = _np((R, t, p))
    for _ in range(4):
        R, t, p = step(R, t, p, *args[3:])
    out["step5"] = _np((R, t, p))
    out["step1_one"] = _np(dist_ba.make_dist_ba_step(cam, None)(*args))
    popt = dist_ba.make_frame_parallel_pose_opt(cam, group)
    out["pose"] = _np(popt(*[torch.from_numpy(a) for a in inp["pose"]]))
    # a group of one process is no group: every path the one-process
    # solve, bit for bit
    one = dist.new_group([0])
    if rank == 0:
        prob = ba_problem(inp["pcg"])
        ref = schur_pcg.ba_solve_pcg(prob, cam, iters=4)
        for name, res in (
                ("pcg_group1", schur_pcg.ba_solve_pcg(prob, cam, iters=4,
                                                      group=one)),
                ("pcg_dist1", dist_ba.make_dist_gba_pcg(cam, one,
                                                        iters=4)(prob))):
            out[name] = all(torch.equal(a, b) for a, b in zip(res, ref))
        vp, g = viba_problem(inp["viba"]), torch.from_numpy(inp["g"])
        kw = dict(prior_gyro=1.0, prior_acc=1e4, iters=3)
        ref = vi_ba.vi_ba_solve(vp, cam, torch.eye(3), torch.zeros(3), g,
                                **kw)
        res = vi_ba.vi_ba_solve(vp, cam, torch.eye(3), torch.zeros(3), g,
                                group=one, **kw)
        out["viba_group1"] = all(torch.equal(a, b) for a, b in zip(res, ref))
        out["step_group1"] = all(
            torch.equal(a, b) for a, b in zip(
                dist_ba.make_dist_ba_step(cam, one)(*args),
                dist_ba.make_dist_ba_step(cam, None)(*args)))
    return out


def dist_gba_cases(rank, group, inp):
    """tests/test_torch_dist_gba.py: the sharded PCG and inertial global
    BAs, and the loop closer's racing global BA with rank 0 leading and
    rank 1 serving over a group of two."""
    cam = camera(inp["cam"])
    out = {}
    prob = ba_problem(inp["pcg"])
    out["pcg8"] = _np(dist_ba.make_dist_gba_pcg(cam, group, iters=8)(prob))
    out["pcg10"] = _np(dist_ba.make_dist_gba_pcg(cam, group, iters=10)(prob))
    out["pcg8_one"] = _np(schur_pcg.ba_solve_pcg(prob, cam, iters=8))
    vp, g = viba_problem(inp["viba"]), torch.from_numpy(inp["g"])
    solve = dist_ba.make_dist_viba_solve(cam, group, iters=6,
                                         prior_gyro=1.0, prior_acc=1e4)
    out["viba"] = _np(solve(vp, torch.eye(3), torch.zeros(3), g))
    out["viba_one"] = _np(vi_ba.vi_ba_solve(
        vp, cam, torch.eye(3), torch.zeros(3), g, prior_gyro=1.0,
        prior_acc=1e4, iters=6))
    two = dist.new_group([0, 1])
    one = dist.new_group([0])
    if rank == 0:
        out["closer"] = _racing_gba(inp, cam, two)
        dist_ba.shutdown(two)
        out["closer_one"] = _racing_gba(inp, cam, one, abort=False)
    elif rank == 1:
        out["served"] = dist_ba.serve(cam, two, device="cpu")
    return out


def _racing_gba(inp, cam, group, abort=True):
    """TestAsyncGlobalBA.test_async_solve_applies_and_abort_discards with
    dist=True: a launched global BA improves the perturbed map and applies
    once; an aborted one leaves it untouched."""
    import threading

    from orb_slam3_detailed_comments_tpu_torch.pipeline import loop_closing
    m = mapstore.MapStore.from_numpy(inp["map"], mapstore.MapConfig(
        max_kf=16, max_pt=512, n_feat=128), device="cpu")
    lc = loop_closing.LoopCloser(m, cam, kfdb=None,
                                 cfg=loop_closing.LoopClosingConfig(
                                     async_gba=True, gba_iters=6,
                                     gba_chunk=3, dist_gba=True),
                                 group=group)
    lc.map_lock = threading.RLock()
    lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
    lc.wait_gba()
    res = dict(runs=lc.n_gba_runs, aborted=lc.n_gba_aborted,
               kf_t=m.kf_t.copy(), pt_xyz=m.pt_xyz.copy(),
               sharded=lc.gba_group(1024) is not None)
    if not abort:
        return res
    snap_t, v0 = m.kf_t.copy(), m.version
    lc.cfg.gba_iters = 400
    lc.cfg.gba_chunk = 1
    lc._launch_global_ba([0, 1, 2, 3], anchor=[0])
    lc.abort_gba()
    res.update(aborted_after=lc.n_gba_aborted, version_kept=m.version == v0,
               kf_t_kept=bool(np.array_equal(m.kf_t, snap_t)))
    return res


def batch_extract_cases(rank, group, inp):
    """tests/test_torch_batch_extract.py: the sharded batch extractor, and
    track_monocular_batch led by rank 0 (the others serve) against
    frame-by-frame tracking."""
    from orb_slam3_detailed_comments_tpu_torch.ops import extractor
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system
    from orb_slam3_detailed_comments_tpu_torch.pipeline.tracking import (
        TrackingConfig)
    out = {}
    cfg = extractor.OrbConfig(**inp["cfg"])
    imgs = torch.from_numpy(inp["imgs"])
    feat = batch_extract.make_batch_extractor(cfg, group)(imgs)
    out["sharded"] = _np(feat)
    out["single"] = [_np(extractor.extract(imgs[i], cfg))
                     for i in range(imgs.shape[0])]
    cam = camera(inp["sys_cam"])
    frames, ts = inp["frames"], inp["ts"]
    if rank == 0:
        kw = dict(tracking_cfg=TrackingConfig(**inp["track_cfg"]),
                  enable_loop_closing=False, device="cpu")
        if "map_cfg" in inp:
            kw["map_cfg"] = mapstore.MapConfig(**inp["map_cfg"])
        a = system.System(cam, system.MONOCULAR, **kw)
        out["online"] = [a.track_monocular(f, float(s))
                         for f, s in zip(frames, ts)]
        b = system.System(cam, system.MONOCULAR, group=group, **kw)
        out["batch"] = b.track_monocular_batch(frames, ts)
        dist_ba.shutdown(group)
    else:
        out["served"] = dist_ba.serve(cam, group, device="cpu")
    return out


def pcg_scale_cases(rank, group, inp):
    """The sharded PCG at the deployment shape (C = 192), against the
    one-process solve."""
    cam = camera(inp["cam"])
    prob = ba_problem(inp["pcg"])
    out = dict(pcg=_np(dist_ba.make_dist_gba_pcg(cam, group, iters=3,
                                                 cg_iters=20)(prob)))
    if rank == 0:
        out["pcg_one"] = _np(schur_pcg.ba_solve_pcg(prob, cam, iters=3,
                                                    cg_iters=20))
    return out


def viba_chain_cases(rank, group, inp):
    """The sharded inertial global BA on a full chain, against the
    one-process solve."""
    cam = camera(inp["cam"])
    vp, g = viba_problem(inp["viba"]), torch.from_numpy(inp["g"])
    kw = dict(prior_gyro=1.0, prior_acc=1e4)
    out = dict(viba=_np(dist_ba.make_dist_viba_solve(cam, group, iters=5,
                                                     **kw)(
        vp, torch.eye(3), torch.zeros(3), g)))
    if rank == 0:
        out["viba_one"] = _np(vi_ba.vi_ba_solve(
            vp, cam, torch.eye(3), torch.zeros(3), g, iters=5, **kw))
    return out
