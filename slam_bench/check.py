"""The correctness check of a run: what the window's timed path produced,
held against the plain reference in ``reference/`` after the window has
closed.

A sample drawn from the seed, of the window's frames and of its bundle
adjustments, is judged on the numbers below; each has a limit
(``LIMITS``, set from sound runs and the control as PERF.md records):

* ``kp_apart``: the share of the frame's keypoints (level, position) that
  the reference's extraction of the same image does not give, or gives
  and the port does not;
* ``desc_bits``: the share of descriptor bits that differ between the two
  over the keypoints both give;
* ``depth_apart`` (stereo): the share of the keypoints both give whose
  stereo depth is valid on one side only or differs by more than 1e-4 of
  itself;
* ``pose_apart``: for each place in a frame where the port solves a pose
  (its first solve, the motion model's; its later ones, the local map's),
  the share of the sampled frames whose solve there lies more than
  ``POSE_TOL_PX`` from the reference's pose solve from the same inputs
  (the solve's start, its matched points and keypoints), the largest of
  the two shares: the root-mean-square distance, over the observations
  that either side keeps as inliers, between their projections under the
  two poses. A share, and not the largest distance: where an
  observation's chi2 lies on the gate, float32 and float64 classify it
  apart now and then, and that one solve then ends ~0.006 px away (one
  sound run in a dozen); a share for each place, so that one place
  broken on every frame reads 1;
* ``ba_gap_px``: the same distance for a bundle adjustment's observations,
  under the port's solved cameras and points and the reference's, from
  the same problem, the largest over the sampled ones;
* ``inlier_apart``: the share of the valid observations, over the sampled
  pose solves and bundle adjustments, that the port and the reference
  classify apart at the chi2 gate;
* ``sample_short``: what the sample lacks of what the traffic's ``check``
  asks for: frames with no extraction captured, frames with fewer than
  two pose solves, bundle adjustments short of the number asked. A
  renamed or fused stage, or a window too short to hold the asked
  events, reads above 0 and the run is not correct.

A run is correct only where every number its sensor gives (``judged``)
is there and within its limit.

The pose and the bundle adjustment are followed from the port's own
state: the reference solves from the matches and the map that the port
holds at that step. The matching and the map bookkeeping that build those
inputs are not re-derived; the front end that starts them is (the first
numbers).

``control``: the same reference, in the next precision below the
configuration's (bfloat16 maps in the front end, TF32 matrix products in
the solves), put in the port's place; it has to fail.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import geometry, orb, stereo

# limits of the compared numbers (PERF.md, section 2, gives the readings
# each was set from)
LIMITS = dict(kp_apart=0.0, desc_bits=4e-4, depth_apart=5e-3,
              pose_apart=0.4, ba_gap_px=2e-2, inlier_apart=3e-4,
              sample_short=0)
# a pose solve further than this from the reference's counts as apart
POSE_TOL_PX = 2e-3


def judged(got: dict, cfg: dict) -> dict:
    """{number: (value, limit)} of every number the configuration's runs
    give (depth only for a stereo rig); a number the sample could not give
    has the value None."""
    names = set(LIMITS) | set(got)
    if cfg["sensor"] != "STEREO":
        names.discard("depth_apart")
    return {k: (got.get(k), LIMITS[k]) for k in sorted(names)}


def correct(checks: dict) -> bool:
    """Every number there and within its limit."""
    return all(v is not None and v <= lim for v, lim in checks.values())


@contextlib.contextmanager
def tf32(on: bool):
    """Matrix products in TF32 on the card while on."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def ref_camera(cfg: dict) -> dict:
    """Camera 1's intrinsics and distortion from the settings, under the
    v1.0 keys ('Camera1.fx') or the legacy ones ('Camera.fx'), and the
    stereo baseline in metres ('Stereo.b', or 'Camera.bf' over fx)."""
    s = cfg["settings"]

    def g(k):
        return float(s.get(f"Camera1.{k}", s.get(f"Camera.{k}", 0.0)))
    cam = {k: g(k) for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")}
    if "Stereo.b" in s:
        cam["baseline_m"] = float(s["Stereo.b"])
    elif "Camera.bf" in s:
        cam["baseline_m"] = float(s["Camera.bf"]) / cam["fx"]
    else:
        cam["baseline_m"] = 0.0
    return cam


def orb_args(cfg: dict) -> dict:
    s = cfg["settings"]
    return dict(n_features=int(np.ceil(int(s["ORBextractor.nFeatures"]) / 128.0)) * 128,
                n_levels=int(s["ORBextractor.nLevels"]),
                scale=float(s["ORBextractor.scaleFactor"]),
                min_th=float(s["ORBextractor.minThFAST"]))


def _keys(xy, level, valid) -> dict:
    """{(level, x * 64, y * 64): row} of the valid keypoints."""
    xy = np.round(xy.double().cpu().numpy() * 64).astype(np.int64)
    lv, ok = level.cpu().numpy(), valid.cpu().numpy()
    return {(int(lv[i]), int(xy[i, 0]), int(xy[i, 1])): i
            for i in np.nonzero(ok)[0]}


def compare_features(a: dict, b: dict, depth_a=None, depth_b=None) -> dict:
    """kp_apart, desc_bits (and depth_apart) of feature sets a and b
    (dicts of xy, level, desc, valid; depths [N] with 0 for none)."""
    ka, kb = _keys(a["xy"], a["level"], a["valid"]), _keys(b["xy"], b["level"], b["valid"])
    both = sorted(set(ka) & set(kb))
    union = len(set(ka) | set(kb))
    out = dict(kp_apart=(union - len(both)) / max(union, 1))
    if both:
        ia = torch.tensor([ka[k] for k in both], device=a["desc"].device)
        ib = torch.tensor([kb[k] for k in both], device=b["desc"].device)
        zero = torch.zeros_like(a["desc"][:1])
        bits = int(stereo.hamming_matrix(zero, a["desc"][ia] ^ b["desc"][ib]).sum())
        out["desc_bits"] = bits / (256.0 * len(both))
        if depth_a is not None:
            da, db = depth_a[ia].double(), depth_b[ib].double()
            va, vb = da > 0, db > 0
            off = (va != vb) | (va & vb & (torch.abs(da - db) > 1e-4 * db))
            out["depth_apart"] = float(off.double().mean())
    else:
        out["desc_bits"] = 1.0
        if depth_a is not None:
            out["depth_apart"] = 1.0
    return out


def _rms_gap(cam, Ra, ta, Rb, tb, X_a, X_b, mask) -> float:
    """Root-mean-square pixel distance over mask between the projections
    of X_a under (Ra, ta) and of X_b under (Rb, tb) (float64)."""
    if not bool(mask.any()):
        return 0.0
    f = lambda v: v.double()
    pa = geometry.project(cam, geometry.transform(f(Ra), f(ta), f(X_a)))
    pb = geometry.project(cam, geometry.transform(f(Rb), f(tb), f(X_b)))
    d2 = torch.sum((pa - pb) ** 2, -1)[mask]
    return float(torch.sqrt(d2.mean()))


def sample(rng, items: list, k: int) -> list:
    if len(items) <= k:
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), k, replace=False))]


def run_checks(cap, tr, res: dict, cfg: dict, traffic: dict, seed: int,
               control: bool = False, diag: dict = None) -> dict:
    """{number: value} of the run's sample (``control``: of the reference
    in the lower precision put in the port's place); ``diag`` takes the
    largest pose gap in px."""
    diag = {} if diag is None else diag
    rng = np.random.default_rng([int(seed), 0x5EED])
    cam = ref_camera(cfg)
    oa = orb_args(cfg)
    stereo_cfg = cfg["sensor"] == "STEREO"
    n0, n = res["n_setup"], res["n_frames"]
    ask = traffic["check"]
    frames = sample(rng, list(range(n0, n0 + n)), int(ask["frames"]))
    short = int(ask["frames"]) - len(frames)
    lower = torch.bfloat16 if control else None
    out = {}

    def worst(name, v):
        out[name] = max(out.get(name, 0.0), v)

    dev = tr.device
    if stereo_cfg:
        bf = cam["baseline_m"] * cam["fx"]
        min_z = max(cam["baseline_m"] * 2.0, 0.3)
        ideal = lambda f: dict(f, xy=stereo.ideal_pixels(cam, f["xy"]))
    for i in frames:
        if not control and i not in cap.preps:
            short += 1
            continue
        j = tr.fed[i]
        img = torch.from_numpy(tr.frames[j].astype(np.float32)).to(dev)
        ref = orb.extract(img, **oa)
        if stereo_cfg:
            img_r = torch.from_numpy(tr.frames_r[j].astype(np.float32)).to(dev)
            ref_r = orb.extract(img_r, **oa)
            d_ref, _ = stereo.stereo_match(ideal(ref), ref_r, img, img_r, bf,
                                           min_z, oa["n_levels"], oa["scale"])
            if control:
                got = orb.extract(img, **oa, lower=lower)
                got_r = orb.extract(img_r, **oa, lower=lower)
                d_got, _ = stereo.stereo_match(ideal(got), got_r, img, img_r,
                                               bf, min_z, oa["n_levels"],
                                               oa["scale"])
            else:
                prep, d_got, _ = cap.preps[i]
                got = prep.feat._asdict()
            cmp = compare_features(got, ref, d_got, d_ref)
        else:
            if control:
                got = orb.extract(img, **oa, lower=lower)
            else:
                got = cap.preps[i].feat._asdict()
            cmp = compare_features(got, ref)
        for k, v in cmp.items():
            worst(k, v)

    # each sampled frame's pose solves, in the order the port made them:
    # the first at place 0 (the motion model's), the later ones at place 1
    solves = {i: [] for i in frames}
    for c in cap.pose_calls:
        if c[0] in solves:
            solves[c[0]].append(c)
    short += sum(len(v) < 2 for v in solves.values())
    apart = {0: [], 1: []}
    flips = [0, 0]                 # observations classified apart, valid ones
    gaps = []
    for i in frames:
        for k, (_, a, kw, result) in enumerate(solves[i]):
            T0, X, uv, w, valid = a[:5]
            R_ref, t_ref, inl_ref = geometry.pose_gn(T0.R, T0.t, X, uv, w,
                                                     valid, cam)
            if control:
                with tf32(True):
                    R_got, t_got, inl = geometry.pose_gn(
                        T0.R, T0.t, X, uv, w, valid, cam, dtype=torch.float32)
            else:
                R_got, t_got, inl = result.T_cw.R, result.T_cw.t, result.inlier
            g = _rms_gap(cam, R_got, t_got, R_ref, t_ref, X, X,
                         (inl | inl_ref) & valid)
            gaps.append(g)
            apart[min(k, 1)].append(g > POSE_TOL_PX)
            flips[0] += int(((inl != inl_ref) & valid).sum())
            flips[1] += int(valid.sum())
    shares = [sum(v) / len(v) for v in apart.values() if v]
    if shares:
        out["pose_apart"] = max(shares)
        diag["pose_gap_px"] = max(gaps)

    window_bas = cap.ba_calls[res["ba_first"]:]
    bas = sample(rng, window_bas, int(ask["ba_events"]))
    short += int(ask["ba_events"]) - len(bas)
    for _, a, kw, result in bas:
        prob = a[0]._asdict()
        iters = int(kw.get("iters", a[2] if len(a) > 2 else 10))
        R_ref, t_ref, X_ref, inl_ref = geometry.local_ba(prob, cam, iters=iters)
        if control:
            with tf32(True):
                R_got, t_got, X_got, inl = geometry.local_ba(
                    prob, cam, dtype=torch.float32, iters=iters)
        else:
            R_got, t_got, X_got, inl = (result.kf_R, result.kf_t,
                                        result.points, result.obs_inlier)
        oc, op = prob["obs_cam"].long(), prob["obs_pt"].long()
        ok = prob["obs_valid"]
        worst("ba_gap_px", _rms_gap(cam, R_got[oc], t_got[oc], R_ref[oc],
                                    t_ref[oc], X_got[op], X_ref[op],
                                    (inl | inl_ref) & ok))
        flips[0] += int(((inl != inl_ref) & ok).sum())
        flips[1] += int(ok.sum())
    if flips[1]:
        out["inlier_apart"] = flips[0] / flips[1]
        diag["inliers_apart"] = flips[0]
    out["sample_short"] = short
    return out


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    """(s, R, t) minimising |dst - (s R src + t)|^2 over the rows."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def trajectory_error(res: dict, tr, with_scale: bool):
    """(root-mean-square camera-centre error in metres, scale) of the
    window's poses against the rendered path, after the best similarity
    (monocular) or rigid (stereo) alignment; a diagnostic, not compared."""
    est, gt = [], []
    for i, pose in enumerate(res["poses"]):
        if pose is None:
            continue
        j = tr.fed[res["n_setup"] + i]
        T = np.asarray(pose, np.float64)
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-tr.R_cw[j].T @ tr.t_cw[j])
    if len(est) < 3:
        return None, None
    est, gt = np.asarray(est), np.asarray(gt)
    s, R, t = umeyama(est, gt, with_scale)
    err = gt - (s * est @ R.T + t)
    return float(np.sqrt((err ** 2).sum(1).mean())), s
