"""Distributed bundle adjustment over a process group.

Counterpart of ``parallel/dist_ba.py`` of the JAX package. The reference
has no distributed compute; this is the scaling path it lacks:
observations are sharded over the processes of a ``torch.distributed``
group (the JAX code's mesh axis ``OBS_AXIS``), each process assembles the
partial normal equations of its block, and the sums are reduced with
``all_reduce``; poses, points and the dense camera solve are whole on
every process.

Every function returned here is SPMD: each process of the group calls it
with the whole, replicated problem and takes its own contiguous block of
the observations (or frames), as ``shard_map``'s ``P(axis)`` splits them;
the observation count must be a multiple of the world size (pad with
``obs_valid=False``). Results are equal on every process; an output the
JAX code shards ``P(axis)`` (``obs_inlier``) comes back whole. With no
group, or a group of one process, each is the one-process solve.

Where the JAX program has one controller, here process 0 leads: a
function made with ``lead=True`` first broadcasts its job (a small header,
then the problem's tensors in one buffer) to the other processes, which
wait in ``serve`` and join the same solve; ``shutdown`` ends ``serve``.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from .. import comm, device as device_mod
from ..lie import SE3, se3
from ..models import cameras
from ..optim import ba as ba_mod
from ..optim import pose_opt, reproj, schur_pcg, vi_ba

OBS_AXIS = "obs"

_STOP = "stop"

# rank 0 may lead from two threads (batched extraction on the tracking
# thread, the racing global BA on its own): a job's announcement and all
# its collectives run under this lock, so that the other ranks, which
# serve one job at a time, see every job's collectives in one order
LEAD_LOCK = threading.RLock()


def _partial_normal_eqs(kf_R, kf_t, points, obs_cam, obs_pt, obs_uv, obs_w,
                        obs_valid, point_valid, cam, delta2, group=None):
    """U, b_c, V, b_p, Wd [P, C, 6, 3] of an observation block, each summed
    over the group (float64 partials, rounded once:
    ``ba.coo_normal_equations``)."""
    C = kf_R.shape[0]
    prob = ba_mod.BAProblem(
        kf_R, kf_t, points, obs_cam, obs_pt, obs_uv, obs_w, obs_valid,
        torch.zeros(C, dtype=torch.bool, device=kf_R.device), point_valid)
    return ba_mod.coo_normal_equations(prob, cam, kf_R, kf_t, points,
                                       obs_valid, delta2, group)


def _obs_block(prob, group):
    """The problem with its obs_* fields cut to this rank's block."""
    sl = comm.block(int(prob.obs_cam.shape[0]), group)
    return prob._replace(**{f: getattr(prob, f)[sl] for f in prob._fields
                            if f.startswith("obs_")})


def announce(group, name: str, params: dict, args) -> None:
    """Rank 0: hand a job to ``serve`` on the other ranks: a header (the
    job's name, its parameters and the spec of its tensors), then the
    tensors in one buffer."""
    spec, data = comm.pack(args, comm.wire(group))
    dist.broadcast_object_list([(name, params, spec, data.numel())],
                               src=comm.root(group), group=group)
    dist.broadcast(data, src=comm.root(group), group=group)


def _job(name: str, params: dict, fn, group, lead: bool):
    """fn, which on the leading process first announces the job."""
    if not lead or comm.active(group) is None:
        return fn

    def leading(*args):
        with LEAD_LOCK:
            announce(group, name, params, args)
            return fn(*args)

    return leading


def make_dist_ba_step(cam: cameras.CameraParams, group,
                      delta2: float = reproj.CHI2_MONO,
                      lm_lambda: float = 1e-4, lead: bool = False):
    """One Gauss-Newton / LM step with the observations sharded over the
    group: fn(kf_R, kf_t, points, obs_cam, obs_pt, obs_uv, obs_w,
    obs_valid, fixed_cam, point_valid) -> (kf_R, kf_t, points). The
    reduced U, b_c, V, b_p and the dense coupling Wd [P, C, 6, 3] go
    through ``ba._schur_lm_solve`` (the JAX step's Schur reduction and
    jittered Cholesky); the step is taken, as in the JAX code. Call it
    repeatedly from the host's LM loop."""
    group = comm.active(group)

    def step(kf_R, kf_t, points, obs_cam, obs_pt, obs_uv, obs_w, obs_valid,
             fixed_cam, point_valid):
        sl = comm.block(int(obs_cam.shape[0]), group)
        U, b_c, V, b_p, Wd = _partial_normal_eqs(
            kf_R, kf_t, points, obs_cam[sl], obs_pt[sl], obs_uv[sl],
            obs_w[sl], obs_valid[sl], point_valid, cam, delta2, group)
        lam = torch.full((), lm_lambda, dtype=torch.float32,
                         device=points.device)
        dc, dp = ba_mod._schur_lm_solve(U, b_c, V, b_p, Wd, lam, fixed_cam,
                                        point_valid)
        T_new = se3.exp(dc).compose(SE3(kf_R, kf_t))
        return T_new.R, T_new.t, points + dp

    return _job("ba_step", dict(delta2=delta2, lm_lambda=lm_lambda), step,
                group, lead)


def make_frame_parallel_pose_opt(cam: cameras.CameraParams, group,
                                 lead: bool = False):
    """Motion-only optimisation of a batch of frames sharded over the
    group: fn(R0 [F, 3, 3], t0 [F, 3], X [F, M, 3], uv [F, M, 2], w [F, M],
    valid [F, M]) -> (R [F, 3, 3], t [F, 3], n_inliers [F]), each frame
    ``pose_opt.pose_optimization``'s solve (batched on each process)."""
    group = comm.active(group)

    def solve(R0, t0, X, uv, w, valid):
        sl = comm.block(int(R0.shape[0]), group)
        res = pose_opt.pose_optimization_batch(
            SE3(R0[sl], t0[sl]), X[sl], uv[sl], w[sl], valid[sl], cam)
        out = (res.T_cw.R, res.T_cw.t, res.n_inliers)
        if group is None:
            return out
        return comm.all_gather_tree(out, group, R0.device)

    return _job("pose_opt", {}, solve, group, lead)


def make_dist_viba_solve(cam: cameras.CameraParams, group, iters: int = 5,
                         prior_gyro: float = 0.0, prior_acc: float = 0.0,
                         fix_points: bool = False, lead: bool = False):
    """The full-map visual-inertial BA (the sharded FullInertialBA,
    reference Optimizer.cc:3237, run as the post-loop global BA on
    inertial maps) with the visual observations sharded over the group
    (``vi_ba.vi_ba_solve``'s ``group``): fn(prob: VIBAProblem, R_cb, t_cb,
    gravity) -> VIBAResult, obs_inlier whole."""
    group = comm.active(group)

    def solve(prob, R_cb, t_cb, gravity):
        res = vi_ba.vi_ba_solve(
            _obs_block(prob, group), cam, R_cb, t_cb, gravity, prior_gyro,
            prior_acc, iters, reproj.CHI2_MONO, 1e9, fix_points, group)
        if group is None:
            return res
        return res._replace(obs_inlier=comm.all_gather(res.obs_inlier,
                                                       group))

    return _job("viba", dict(iters=iters, prior_gyro=prior_gyro,
                             prior_acc=prior_acc, fix_points=fix_points),
                solve, group, lead)


def make_dist_gba_pcg(cam: cameras.CameraParams, group, iters: int = 10,
                      cg_iters: int = 100, delta2: float = reproj.CHI2_MONO,
                      lm_lambda0: float = 1e-4, lead: bool = False):
    """The Atlas-scale global BA: ``schur_pcg.ba_solve_pcg`` with the
    observations sharded over the group. It never forms the [P, C, 6, 3]
    coupling; each CG matvec reduces one [P, 3] and one [C, 6] sum.
    fn(prob: BAProblem) -> BAResult, obs_inlier whole."""
    group = comm.active(group)

    def solve(prob):
        res = schur_pcg.ba_solve_pcg(_obs_block(prob, group), cam, iters,
                                     delta2, lm_lambda0, cg_iters, group)
        if group is None:
            return res
        return res._replace(obs_inlier=comm.all_gather(res.obs_inlier,
                                                       group))

    return _job("gba_pcg", dict(iters=iters, cg_iters=cg_iters,
                                delta2=delta2, lm_lambda0=lm_lambda0),
                solve, group, lead)


def _maker(name: str):
    if name == "prepare_frames":
        from .batch_extract import _prepare_job
        return _prepare_job
    return dict(ba_step=make_dist_ba_step, pose_opt=make_frame_parallel_pose_opt,
                viba=make_dist_viba_solve, gba_pcg=make_dist_gba_pcg)[name]


def serve(cam: cameras.CameraParams, group, device=None) -> int:
    """The loop of every process but the group's rank 0: take each job
    that rank 0 broadcasts (a header, then its tensors in one buffer),
    join the same SPMD call on this process's device (the card unless
    ``device`` says otherwise), and return, with the number of jobs
    served, when rank 0's ``shutdown`` broadcasts a stop."""
    dev = device_mod.resolve(device)
    src = comm.root(group)
    served = 0
    while True:
        head = [None]
        dist.broadcast_object_list(head, src=src, group=group)
        name, params, spec, n = head[0]
        if name == _STOP:
            return served
        data = torch.empty(n, dtype=torch.uint8, device=comm.wire(group))
        dist.broadcast(data, src=src, group=group)
        args = comm.unpack(spec, data, dev)
        _maker(name)(cam, group, **params)(*args)
        served += 1


def shutdown(group) -> None:
    """Rank 0: end ``serve`` on the other processes of the group."""
    if comm.active(group) is not None:
        dist.broadcast_object_list([(_STOP, None, None, 0)],
                                   src=comm.root(group), group=group)
