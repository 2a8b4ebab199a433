"""The long sequences of ``chip_smoke.py`` phase 15 on the CPU, the JAX
package beside the port: what each package's run of a case reads, and
where the two part. Each case is ``chip_smoke.long_case``'s.

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/run_long_sequences.py jax <case> [--port-resize]
    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/run_long_sequences.py port <case> [--jax-resize]
    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/run_long_sequences.py local-ba <case> <from> <to>

- ``jax``: the JAX package's System over the case (its test's own frames
  for the pinhole cases, OpenCV's warp), then its gates' values: the ATE
  and Horn scale (metric for the metric sensors), the keyframe-only ATE,
  loops, keyframes, and the metric ATE and scale over the first 30, 60, 90
  frames. With ``--port-resize`` its pyramid resizes by the port's
  rounding (``torch:ops/pyramid.resize_bilinear``, through a host
  callback): another draw of the JAX package, parted from its own at
  frame 0's knife-edge keypoints as the port's is.
- ``port``: the same through the port's System on the CPU; with
  ``--jax-resize`` the port's pyramid resizes by the JAX package's
  ``resize_bilinear_mm`` (XLA-CPU's rounding), so that both extract the
  same keypoints from the same image.
- ``local-ba``: the JAX System over the frames before <to>; at each of
  its keyframe events from frame <from> on, the local BA's map is kept
  before and after; the port's ``run_local_ba`` then solves the same
  window from the same map. Printed: the robust cost at the start, after
  the port's solve and at JAX's result (the port's cost function, every
  observation), the largest keyframe translation between the two results,
  and how far a N(0, 1e-7) m nudge of the points moves the port's solve.

Case names: ``chip_smoke.LONG_TESTS``.
"""
import copy
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import torch
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

import chip_smoke
import test_pipeline_fisheye as jfish
import test_pipeline_stress as jstress
from orb_slam3_detailed_comments_tpu.utils import synth_render as jsr
from test_pipeline_metric_loops import _metric_align

CPU = torch.device("cpu")
METRIC = ("stereo_gauntlet", "kb8_loop", "flagship")


def jax_system(case):
    from orb_slam3_detailed_comments_tpu.pipeline import system as jsys
    kw = dict(case["system_kw"])
    if kw.pop("async_mapping", False):
        kw["async_mapping"] = True
    if "camera2" in kw:
        kw["camera2"] = jfish.CAM
    cam = jfish.CAM if "camera2" in kw else jstress.CAM
    return jsys.System(cam, case["sensor"], **kw)


def jax_frames(case):
    """frame(i) of the JAX test: the pinhole frames through the JAX
    package's renderer (OpenCV's warp), the KB8 ones as the port's (equal
    within a few hundredths of a grey level, tests/test_torch_long_sequences.py)."""
    if case["name"] != "stereo_gauntlet":
        return lambda i: case["frame"](i, CPU)
    walls = jstress.stress_world(np.random.default_rng(21))
    n = case["n"]

    def frame(i):
        left, right = jsr.render_stereo_pair(jstress.CAM, walls, case["R"][i],
                                             case["t"][i], chip_smoke.BASELINE)
        return jstress.degrade(left, i, n), jstress.degrade(right, i, n)
    return frame


def feed(slam, case, frame, n, before=None):
    w = case["windows"]
    for i in range(n):
        if before is not None:
            before(i)
        imgs = frame(i)
        kw = {} if w is None else dict(imu=w[i])
        if isinstance(imgs, tuple):
            slam.track_stereo(*imgs, float(case["ts"][i]), **kw)
        else:
            slam.track_monocular(imgs, float(case["ts"][i]), **kw)
        if i % 50 == 0:
            print(f"  frame {i}: {slam.n_keyframes} KF", flush=True)
    if case["system_kw"].get("async_mapping"):
        slam.shutdown()


def report(slam, case, n, seconds):
    from orb_slam3_detailed_comments_tpu_torch.utils import evaluate_ate
    metric = case["name"] in METRIC
    ts, C = case["ts"][:n], case["centers"][:n]
    rows = np.array(slam.trajectory_tum())
    out = []
    for k in (30, 60, 90, n):
        sel = rows[:, 0] <= ts[k - 1] + 1e-9
        rm, npair, _ = evaluate_ate.ate_rmse(ts[:k], C[:k], rows[sel, 0],
                                             rows[sel, 1:4],
                                             with_scale=not metric)
        _, _, s = evaluate_ate.ate_rmse(ts[:k], C[:k], rows[sel, 0],
                                        rows[sel, 1:4], with_scale=True)
        out.append((k, round(float(rm), 5), npair, round(float(s), 5)))
    m = slam.map
    kids = m.kf_ids()
    fid = m.kf_frame_id[kids]
    kids, fid = kids[fid >= 0], fid[fid >= 0]
    kf_c = np.einsum("nij,nj->ni", np.transpose(m.kf_R[kids], (0, 2, 1)),
                     -m.kf_t[kids])
    aligned = (_metric_align(kf_c, C[fid]) if metric
               else evaluate_ate.align_horn(kf_c, C[fid])[3])
    kf_ate = float(np.sqrt(((aligned - C[fid]) ** 2).sum(1).mean()))
    lc = slam.loop_closer
    print(f"{case['name']}: {n} frames, {len(kids)} keyframes, "
          f"{lc.n_loops_closed if lc is not None else 0} loops; "
          f"(frames, {'metric ' if metric else ''}ATE, pairs, Horn scale) "
          f"{out}; KF-only ATE {kf_ate:.5f}; {seconds:.0f} s", flush=True)


def with_jax_resize():
    """The port's pyramid resizing by the JAX package's matrix form."""
    from orb_slam3_detailed_comments_tpu.ops import pyramid as jpyr
    from orb_slam3_detailed_comments_tpu_torch.ops import pyramid
    jitted = {}

    def resize(x, nh, nw):
        if x.dim() == 3:
            return torch.stack([resize(a, nh, nw) for a in x])
        key = (tuple(x.shape), nh, nw)
        if key not in jitted:
            jitted[key] = jax.jit(
                lambda a: jpyr.resize_bilinear_mm(a, nh, nw))
        return torch.from_numpy(np.array(jitted[key](jnp.asarray(
            x.numpy()))))
    pyramid.resize_bilinear = resize


def with_port_resize():
    """The JAX package's pyramid resizing by the port's rounding."""
    from orb_slam3_detailed_comments_tpu.ops import pyramid as jpyr
    from orb_slam3_detailed_comments_tpu_torch.ops import pyramid

    def resize(img, nh, nw):
        host = lambda a: pyramid.resize_bilinear(
            torch.from_numpy(np.array(a)), nh, nw).numpy()
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct((nh, nw), jnp.float32), img)
    jpyr.resize_bilinear_mm = resize


def run_jax(name, port_resize=False):
    if port_resize:
        with_port_resize()
    case = chip_smoke.long_case(name)
    t0 = time.perf_counter()
    slam = jax_system(case)
    feed(slam, case, jax_frames(case), case["n"])
    report(slam, case, case["n"], time.perf_counter() - t0)


def run_port(name, jax_resize=False):
    from orb_slam3_detailed_comments_tpu_torch.pipeline import system
    if jax_resize:
        with_jax_resize()
    case = chip_smoke.long_case(name)
    t0 = time.perf_counter()
    slam = system.System(case["cam"], case["sensor"], device="cpu",
                         **case["system_kw"])
    feed(slam, case, lambda i: case["frame"](i, CPU), case["n"])
    report(slam, case, case["n"], time.perf_counter() - t0)


def _arrays(m):
    a = {k: v.copy() for k, v in vars(m).items() if isinstance(v, np.ndarray)}
    a["tombstones"] = copy.deepcopy(m.tombstones)
    return a


def local_ba(name, first, last):
    from orb_slam3_detailed_comments_tpu.pipeline import local_mapping as jlm
    from orb_slam3_detailed_comments_tpu_torch.mapping import mapstore
    from orb_slam3_detailed_comments_tpu_torch.optim import ba, reproj
    from orb_slam3_detailed_comments_tpu_torch.pipeline import local_mapping
    case = chip_smoke.long_case(name)
    slam = jax_system(case)
    frame, events = [0], []
    real = jlm.run_local_ba

    def kept(m, window, fixed=None, **kw):
        if frame[0] < first:
            return real(m, window, fixed=fixed, **kw)
        ev = dict(frame=frame[0], window=list(window), fixed=fixed, kw=kw,
                  before=_arrays(m))
        out = real(m, window, fixed=fixed, **kw)
        ev["after"] = _arrays(m)
        events.append(ev)
        return out
    jlm.run_local_ba = kept
    feed(slam, case, jax_frames(case), last,
         before=lambda i: frame.__setitem__(0, i))
    jlm.run_local_ba = real
    cfg = mapstore.MapConfig(**{f: getattr(slam.map.cfg, f)
                                for f in ("max_kf", "max_pt", "n_feat")})
    cam, g = case["cam"], reproj.CHI2_MONO
    for ev in events:
        m = mapstore.MapStore.from_numpy(ev["before"], cfg, "cpu")
        kw = ev["kw"]
        prob, meta = local_mapping.build_ba_problem(
            m, ev["window"], ev["fixed"], max_points=kw["max_points"],
            max_obs=kw["max_obs"])
        TL = ba.prepare_table(prob, meta["table_depth"])
        cams, n_real = meta["cams"], meta["n_real"]
        pts = np.asarray(meta["pt_ids"])

        def state(a):
            R, t, X = prob.kf_R.clone(), prob.kf_t.clone(), prob.points.clone()
            R[:n_real] = torch.from_numpy(a["kf_R"][cams][:n_real])
            t[:n_real] = torch.from_numpy(a["kf_t"][cams][:n_real])
            X[:len(pts)] = torch.from_numpy(a["pt_xyz"][pts])
            return R, t, X

        def cost(R, t, X):
            return float(ba._robust_cost(TL, R, t, X, TL.w_t, cam, g))
        solve = lambda p: ba.ba_solve(p, cam, iters=kw["iters"],
                                      table_depth=meta["table_depth"])
        mine = solve(prob)
        nudged = solve(prob._replace(points=prob.points + torch.from_numpy(
            np.random.default_rng(0).normal(0, 1e-7, prob.points.shape))
            .float()))
        jR, jt, jX = state(ev["after"])
        print(f"frame {ev['frame']}: C = {int(prob.kf_R.shape[0])} "
              f"({n_real} keyframes), {len(pts)} points, "
              f"{int(prob.obs_valid.sum())} observations; robust cost start "
              f"{cost(prob.kf_R, prob.kf_t, prob.points):.1f}, port "
              f"{cost(mine.kf_R, mine.kf_t, mine.points):.1f}, JAX "
              f"{cost(jR, jt, jX):.1f}; keyframe translation port vs JAX "
              f"{float((jt - mine.kf_t)[:n_real].abs().max()):.2e} m, the "
              f"port's under a 1e-7 m nudge "
              f"{float((nudged.kf_t - mine.kf_t)[:n_real].abs().max()):.2e}"
              f" m", flush=True)


if __name__ == "__main__":
    what, name = sys.argv[1], sys.argv[2]
    if what == "jax":
        run_jax(name, port_resize="--port-resize" in sys.argv[3:])
    elif what == "port":
        run_port(name, jax_resize="--jax-resize" in sys.argv[3:])
    else:
        local_ba(name, int(sys.argv[3]), int(sys.argv[4]))
