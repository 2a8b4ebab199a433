"""The benchmark's traffic: a textured hall, a camera path through it and
the frames a camera on that path records, made from a traffic file and a
seed.

The world, the ray caster and the blob textures are a frozen copy of the
port's ``utils/synth_render.py`` at commit d23e9c2 (``_texture``,
``Plane``, ``render_image``'s ray-plane intersection and bilinear texture
read, ``orbit_trajectory``'s rotation convention), cut loose from the
port's modules so that a change to the program cannot move the traffic,
for an ideal pinhole (or a rectified pair of them), with a batch of
frames rendered at once.

A traffic file fixes the world's layout, the path and the frame rate; the
path is fed once, from its first frame on (set-up takes the first
``setup.frames``, the window goes on from there). The seed sets the
textures and nothing else, so every seed gives the same sizes, path and
arrivals.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Plane:
    origin: np.ndarray      # [3] world point of texture pixel (0, 0)
    e1: np.ndarray          # [3] world step of one texture column
    e2: np.ndarray          # [3] world step of one texture row
    texture: np.ndarray     # [h, w] float32 intensities
    x_range: tuple          # the plane's world x extent, for culling


def blob_texture(rng, h: int, w: int, n_blobs: int) -> np.ndarray:
    """Axis-aligned blobs of 4-21 pixels at random intensities on grey 120
    (synth_render._texture on an h x w canvas)."""
    img = np.full((h, w), 120.0, np.float32)
    ys = rng.integers(0, h - 24, n_blobs)
    xs = rng.integers(0, w - 24, n_blobs)
    for y, x in zip(ys, xs):
        bh, bw = rng.integers(4, 22), rng.integers(4, 22)
        img[y:y + bh, x:x + bw] = rng.uniform(10, 245)
    return np.clip(img, 0, 255)


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _golden(i: int) -> float:
    """A fixed, evenly spread fraction for the i-th panel (no seed)."""
    return (i * 0.6180339887498949) % 1.0


def hall_world(rng, p: dict) -> list:
    """A back wall at depth ``wall_depth_m`` split into segments, and
    upright panels in front of it every ``panel_every_m`` metres at depths
    and widths spread over the given ranges. Only the textures come from
    rng; the layout comes from p alone."""
    ppm = float(p["ppm"])
    dens = float(p["blobs_per_mpx"]) / 1e6
    x0, x1 = float(p["x_from_m"]), float(p["x_to_m"])
    hh = float(p["height_m"]) / 2
    seg = float(p["segment_m"])
    zw = float(p["wall_depth_m"])
    planes = []
    x = x0
    while x < x1:
        w_m = min(seg, x1 - x) + 0.05          # segments overlap by 5 cm
        tw, th = int(w_m * ppm) + 2, int(2 * hh * ppm) + 2
        planes.append(Plane(np.array([x, -hh, zw]),
                            np.array([1 / ppm, 0.0, 0.0]),
                            np.array([0.0, 1 / ppm, 0.0]),
                            blob_texture(rng, th, tw, int(dens * tw * th)),
                            (x, x + w_m)))
        x += seg
    d0, d1 = p["panel_depth_m"]
    w0, w1 = p["panel_width_m"]
    ph = float(p["panel_height_m"])
    tilt = math.radians(float(p["panel_tilt_deg"]))
    i = 0
    x = x0 + float(p["panel_every_m"]) / 2
    while x < x1:
        z = d0 + (d1 - d0) * _golden(i)
        w_m = w0 + (w1 - w0) * _golden(i + 7)
        a = tilt * ((i % 3) - 1)
        e1 = np.array([math.cos(a), 0.0, math.sin(a)]) / ppm
        tw, th = int(w_m * ppm) + 2, int(ph * ppm) + 2
        y_top = -ph / 2 + 0.4 * (_golden(i + 3) - 0.5)
        planes.append(Plane(np.array([x - w_m / 2, y_top, z]), e1,
                            np.array([0.0, 1 / ppm, 0.0]),
                            blob_texture(rng, th, tw, int(dens * tw * th)),
                            (x - w_m / 2, x + w_m / 2)))
        x += float(p["panel_every_m"])
        i += 1
    return planes


def sweep_path(n: int, p: dict):
    """World -> camera poses (R_cw [n, 3, 3], t_cw [n, 3], float64) of a
    camera facing +z that advances along +x at ``speed_m_per_frame`` with a
    gentle yaw, pitch, height and depth sway (orbit_trajectory's
    convention: R_cw = Rodrigues(pitch, yaw, 0)^T)."""
    i = np.arange(n, dtype=np.float64)
    tau = 2 * np.pi
    yaw = np.radians(p["yaw_amp_deg"]) * np.sin(tau * i / p["yaw_period_frames"])
    pitch = np.radians(p["pitch_amp_deg"]) * np.sin(
        tau * i / p["pitch_period_frames"])
    C = np.stack([p["x_start_m"] + p["speed_m_per_frame"] * i,
                  p["bob_m"] * np.sin(tau * i / p["bob_period_frames"]),
                  p["depth_sway_m"] * np.sin(
                      tau * i / p["depth_sway_period_frames"])], axis=1)
    R = np.stack([_rodrigues(np.array([pt, yw, 0.0])).T
                  for pt, yw in zip(pitch, yaw)])
    t = -np.einsum("nij,nj->ni", R, C)
    return R, t


def camera_rays(cam: dict, device) -> torch.Tensor:
    """[H*W, 3] float64 camera-frame rays (z = 1) of every pixel (c, r) of
    an ideal pinhole, the ray through u = c, v = r."""
    H, W = int(cam["height"]), int(cam["width"])
    f64 = torch.float64
    vv, uu = torch.meshgrid(torch.arange(H, dtype=f64, device=device),
                            torch.arange(W, dtype=f64, device=device),
                            indexing="ij")
    x = (uu.reshape(-1) - cam["cx"]) / cam["fx"]
    y = (vv.reshape(-1) - cam["cy"]) / cam["fy"]
    return torch.stack([x, y, torch.ones_like(x)], dim=1)


def may_show(pl: Plane, R_cw, t_cw, cam: dict, margin_px: float = 2.0) -> bool:
    """Whether a camera of the batch (R_cw [B, 3, 3], t_cw [B, 3]) may see
    the plane's textured quad. False only where, for every camera, the
    quad's four corners lie in front of it and past one edge of the image
    by ``margin_px``: a convex quad in front of a camera projects into
    the hull of its corners, so no pixel's ray then meets it, and leaving
    the plane out changes no pixel."""
    th, tw = pl.texture.shape
    Q = np.array([pl.origin + a * pl.e1 + b * pl.e2
                  for a in (0, tw - 1) for b in (0, th - 1)])
    X = np.einsum("nij,kj->nki", R_cw, Q) + t_cw[:, None, :]
    z = X[..., 2]
    if (z <= 0.05).any():
        return True
    u = X[..., 0] / z * cam["fx"] + cam["cx"]
    v = X[..., 1] / z * cam["fy"] + cam["cy"]
    m = margin_px
    off = ((u < -m).all(1) | (u > cam["width"] - 1 + m).all(1)
           | (v < -m).all(1) | (v > cam["height"] - 1 + m).all(1))
    return not off.all()


def render(planes: list, tex_dev: list, rays: torch.Tensor, R_cw, t_cw,
           cam: dict, cull_m: float) -> np.ndarray:
    """uint8 frames [B, H, W] (host) of the poses R_cw [B, 3, 3], t_cw
    [B, 3]: each ray's nearest plane hit, the texture read bilinearly,
    90 where a ray hits nothing, rounded to 8 bits as a camera records.
    Planes farther along x than ``cull_m`` from every camera, or that no
    camera can see (``may_show``), are not cast against."""
    dev = rays.device
    f64 = torch.float64
    H, W = int(cam["height"]), int(cam["width"])
    B = R_cw.shape[0]
    R = torch.from_numpy(np.ascontiguousarray(R_cw, np.float64)).to(dev)
    C_np = -np.einsum("nji,nj->ni", R_cw, t_cw)          # -R^T t
    Cw = torch.from_numpy(np.ascontiguousarray(C_np)).to(dev)
    rays_w = rays[None] @ R                              # r_w = R_cw^T r
    out = torch.full((B, H * W), 90.0, dtype=torch.float32, device=dev)
    depth = torch.full((B, H * W), float("inf"), dtype=f64, device=dev)
    xlo, xhi = float(C_np[:, 0].min()) - cull_m, float(C_np[:, 0].max()) + cull_m
    for pl, tx in zip(planes, tex_dev):
        if (pl.x_range[1] < xlo or pl.x_range[0] > xhi
                or not may_show(pl, R_cw, t_cw, cam)):
            continue
        n = np.cross(pl.e1, pl.e2)
        nn = torch.from_numpy(n / np.linalg.norm(n)).to(dev)
        o = torch.from_numpy(np.asarray(pl.origin, np.float64)).to(dev)
        denom = rays_w @ nn                               # [B, HW]
        num = (o[None] - Cw) @ nn                         # [B]
        ok = torch.abs(denom) > 1e-9
        d = torch.where(ok, num[:, None] / torch.where(
            ok, denom, torch.ones_like(denom)),
            torch.full_like(denom, float("inf")))
        hit = (d > 0.05) & torch.isfinite(d)
        Xw = Cw[:, None, :] + rays_w * torch.where(
            hit, d, torch.zeros_like(d))[..., None]
        G = np.array([[pl.e1 @ pl.e1, pl.e1 @ pl.e2],
                      [pl.e2 @ pl.e1, pl.e2 @ pl.e2]])
        P = torch.from_numpy(np.stack([pl.e1, pl.e2], 1).astype(np.float64)
                             @ np.linalg.inv(G).T).to(dev)
        ab = (Xw - o) @ P                                 # [B, HW, 2]
        th, tw = pl.texture.shape
        inside = ((ab[..., 0] >= 0) & (ab[..., 0] < tw - 1) & (ab[..., 1] >= 0)
                  & (ab[..., 1] < th - 1) & hit & (d < depth))
        a0 = torch.where(inside, ab[..., 0], torch.zeros_like(ab[..., 0]))
        a1 = torch.where(inside, ab[..., 1], torch.zeros_like(ab[..., 1]))
        x0, y0 = a0.long(), a1.long()
        fx = (a0 - x0).to(torch.float32)
        fy = (a1 - y0).to(torch.float32)
        i00 = y0 * tw + x0
        val = (tx[i00] * (1 - fx) * (1 - fy) + tx[i00 + 1] * fx * (1 - fy)
               + tx[i00 + tw] * (1 - fx) * fy + tx[i00 + tw + 1] * fx * fy)
        out = torch.where(inside, val, out)
        depth = torch.where(inside, d, depth)
    img = torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)
    return img.reshape(B, H, W).cpu().numpy()


class Traffic:
    """The frames of one run (``frames``, and ``frames_r`` of a stereo
    rig), fed in path order at ``rate_hz``; ``fed`` records the frame
    index of every item fed. ``texture_s`` and ``render_s``: the host
    clock of the world's textures (drawn and uploaded) and of the
    frames' rendering."""

    def __init__(self, spec: dict, cfg: dict, seed: int, device,
                 batch: int = 16):
        self.spec = spec
        self.device = torch.device(device)
        t0 = time.perf_counter()
        rng = np.random.default_rng(int(seed))
        self.planes = hall_world(rng, spec["world"])
        tex = [torch.from_numpy(np.ascontiguousarray(p.texture)).to(
            device).reshape(-1) for p in self.planes]
        t1 = time.perf_counter()
        n = int(spec["frames"])
        self.R_cw, self.t_cw = sweep_path(n, spec["path"])
        cam = cfg["camera"]
        rays = camera_rays(cam, device)
        stereo = cfg["sensor"] == "STEREO"
        cull = float(spec["world"]["cull_m"])
        left, right = [], []
        for b0 in range(0, n, batch):
            R, t = self.R_cw[b0:b0 + batch], self.t_cw[b0:b0 + batch]
            left.append(render(self.planes, tex, rays, R, t, cam, cull))
            if stereo:
                # the right camera of a rectified pair: the left one moved
                # by the baseline along its own +x
                t_r = t - np.array([cfg["baseline_m"], 0.0, 0.0])
                right.append(render(self.planes, tex, rays, R, t_r, cam, cull))
        self.frames = np.concatenate(left)
        self.frames_r = np.concatenate(right) if stereo else None
        self.texture_s = t1 - t0
        self.render_s = time.perf_counter() - t1
        self.rate_hz = float(spec["rate_hz"])
        self.fed: list = []     # frame index of every item fed, in order

    def items(self, stereo: bool):
        """(img, ts) or (left, right, ts) in path order, the sensor clock
        at ``rate_hz``; the feed ends with the path."""
        def gen():
            for j in range(len(self.frames)):
                self.fed.append(j)
                ts = j / self.rate_hz
                yield ((self.frames[j], self.frames_r[j], ts) if stereo
                       else (self.frames[j], ts))
        return gen()
