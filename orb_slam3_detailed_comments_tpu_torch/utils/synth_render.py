"""Synthetic textured-plane world, ray-cast renderer and map-seeding fixture.

Counterpart of a cv2-free subset of ``utils/synth_render.py`` of the JAX
package: the same blob textures, worlds (``default_world``, the loop
world ``box_world``) and trajectories (``orbit_trajectory``,
``loop_trajectory``), so a seed gives the same world in both packages, and a ray-cast renderer for any camera
model, modelled on its ``render_frame_raycast``, that also returns the
exact 3D hit of every ray. ``render_stereo_pair`` and ``render_depth``
(rectified stereo pairs, depth maps) are built on it: the JAX versions
warp with ``cv2``. ``seed_map`` builds the map that tracking runs against from ground
truth; it is a test and smoke fixture, not a SLAM feature.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..lie import SE3
from ..mapping.mapstore import MapConfig, MapStore
from ..models import cameras
from ..ops import extractor, matching
from ..pipeline import kernels


def _texture(rng, size=1200, n_blobs=4000):
    img = np.full((size, size), 120.0, np.float32)
    ys = rng.integers(0, size - 24, n_blobs)
    xs = rng.integers(0, size - 24, n_blobs)
    for y, x in zip(ys, xs):
        h, w = rng.integers(4, 22), rng.integers(4, 22)
        img[y:y + h, x:x + w] = rng.uniform(10, 245)
    return np.clip(img, 0, 255)


@dataclass
class Plane:
    origin: np.ndarray      # [3] world point of texture (0,0)
    e1: np.ndarray          # [3] world direction of texture u axis (per px)
    e2: np.ndarray          # [3] world direction of texture v axis (per px)
    texture: np.ndarray


def default_world(rng, extent=14.0, tex_size=1200):
    """A back wall plus two offset foreground panels."""
    ppm = tex_size / extent  # pixels per meter
    return [
        Plane(np.array([-extent / 2, -extent / 2, 8.0]),
              np.array([1 / ppm, 0, 0.0]), np.array([0, 1 / ppm, 0.0]),
              _texture(rng, tex_size)),
        Plane(np.array([-5.0, -3.0, 5.5]),
              np.array([1 / ppm, 0, 0.02 / ppm]), np.array([0, 1 / ppm, 0.0]),
              _texture(rng, int(tex_size * 0.5), n_blobs=1200)),
        Plane(np.array([0.5, -2.0, 4.0]),
              np.array([1 / ppm, 0, -0.03 / ppm]),
              np.array([0, 1 / ppm, 0.01 / ppm]),
              _texture(rng, int(tex_size * 0.4), n_blobs=900)),
    ]


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def box_world(rng, half=8.0, tex_size=1400):
    """Four textured walls of a box in x-z (y vertical): a camera circling
    inside and facing outward revisits the first wall after 360 degrees."""
    ppm = tex_size / (2 * half)
    e_y = np.array([0, 1 / ppm, 0.0])
    return [
        Plane(np.array([-half, -half, half]), np.array([1 / ppm, 0, 0]), e_y,
              _texture(rng, tex_size)),
        Plane(np.array([half, -half, half]), np.array([0, 0, -1 / ppm]), e_y,
              _texture(rng, tex_size)),
        Plane(np.array([half, -half, -half]), np.array([-1 / ppm, 0, 0]), e_y,
              _texture(rng, tex_size)),
        Plane(np.array([-half, -half, -half]), np.array([0, 0, 1 / ppm]), e_y,
              _texture(rng, tex_size)),
    ]


def loop_trajectory(n_frames, radius=3.0, closes: float = 1.0):
    """A circle of ``closes`` revolutions in the x-z plane, the camera
    facing radially outward. Returns world -> camera (R_cw [T, 3, 3],
    t_cw [T, 3])."""
    Rs, ts = [], []
    for i in range(n_frames):
        a = 2 * np.pi * closes * i / n_frames
        cw = np.array([radius * np.sin(a), 0.0, radius * np.cos(a)])
        z = np.array([np.sin(a), 0.0, np.cos(a)])
        x = np.array([np.cos(a), 0.0, -np.sin(a)])
        R_cw = np.stack([x, np.cross(z, x), z], axis=1).T
        Rs.append(R_cw.astype(np.float32))
        ts.append((-R_cw @ cw).astype(np.float32))
    return np.stack(Rs), np.stack(ts)


def orbit_trajectory(n_frames, radius=0.0, advance=2.5, sway=0.35,
                     yaw_amp=0.08):
    """Forward translation with lateral sway + gentle yaw, always facing the
    planes. Returns (R_cw [T,3,3], t_cw [T,3]) world->cam."""
    Rs, ts = [], []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        cw = np.array([sway * np.sin(2 * np.pi * a * 1.5),
                       0.15 * np.sin(2 * np.pi * a * 0.8),
                       advance * a])
        yaw = yaw_amp * np.sin(2 * np.pi * a)
        pitch = 0.03 * np.sin(2 * np.pi * a * 1.3)
        R_cw = _rodrigues(np.array([pitch, yaw, 0.0])).T
        Rs.append(R_cw.astype(np.float32))
        ts.append((-R_cw @ cw).astype(np.float32))
    return np.stack(Rs), np.stack(ts)


def camera_centers(R_cw, t_cw):
    return -np.einsum("tij,ti->tj", R_cw, t_cw)


def raycast(cam: cameras.CameraParams, planes, R_cw, t_cw, uv: np.ndarray):
    """Cast the camera's rays through pixel coordinates uv [M, 2] (the
    convention of ``cameras.project``: pixel (c, r) is the ray through
    u = c, v = r). Returns (intensity [M] float32, X_w [M, 3] float64,
    hit [M] bool); the nearest plane wins, a miss reads 90. An undistorted
    pinhole's rays are computed in float64, any other model's from
    ``cameras.unproject_bearing`` in float32, as the JAX renderer does."""
    if cam.kind == cameras.PINHOLE and not any(cam.dist):
        rays = np.stack([(uv[:, 0] - cam.cx) / cam.fx,
                         (uv[:, 1] - cam.cy) / cam.fy, np.ones(len(uv))],
                        axis=1)
    else:
        rays = cameras.unproject_bearing(cam, torch.from_numpy(
            np.asarray(uv, np.float32))).numpy().astype(np.float64)
    R_wc = R_cw.T.astype(np.float64)
    C_w = -R_wc @ t_cw.astype(np.float64)
    rays_w = rays @ R_wc.T
    M = len(uv)
    out = np.full(M, 90.0, np.float32)
    depth = np.full(M, np.inf)
    X = np.zeros((M, 3))
    for pl in planes:
        n = np.cross(pl.e1, pl.e2)
        nn = n / np.linalg.norm(n)
        denom = rays_w @ nn
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(np.abs(denom) > 1e-9, ((pl.origin - C_w) @ nn) / denom,
                         np.inf)
        hit = (d > 0.05) & np.isfinite(d)
        Xw = C_w + rays_w * np.where(hit, d, 0.0)[:, None]
        G = np.array([[pl.e1 @ pl.e1, pl.e1 @ pl.e2],
                      [pl.e2 @ pl.e1, pl.e2 @ pl.e2]])
        ab = ((Xw - pl.origin) @ np.stack([pl.e1, pl.e2], 1)) @ np.linalg.inv(G).T
        h, w = pl.texture.shape
        inside = ((ab[:, 0] >= 0) & (ab[:, 0] < w - 1) & (ab[:, 1] >= 0)
                  & (ab[:, 1] < h - 1) & hit & (d < depth))
        ai = ab[inside]
        x0 = ai[:, 0].astype(int)
        y0 = ai[:, 1].astype(int)
        fx = (ai[:, 0] - x0).astype(np.float32)
        fy = (ai[:, 1] - y0).astype(np.float32)
        tx = pl.texture
        out[inside] = (tx[y0, x0] * (1 - fx) * (1 - fy)
                       + tx[y0, x0 + 1] * fx * (1 - fy)
                       + tx[y0 + 1, x0] * (1 - fx) * fy
                       + tx[y0 + 1, x0 + 1] * fx * fy)
        depth[inside] = d[inside]
        X[inside] = Xw[inside]
    return out, X, np.isfinite(depth)


def render_frame_raycast(cam: cameras.CameraParams, planes, R_cw, t_cw):
    """Render a frame [H, W] float32 plus the exact world point hit by each
    pixel's ray [H, W, 3] (float64) and its hit mask [H, W]."""
    H, W = cam.height, cam.width
    vv, uu = np.mgrid[0:H, 0:W]
    uv = np.stack([uu.reshape(-1), vv.reshape(-1)], 1).astype(np.float64)
    img, X, hit = raycast(cam, planes, R_cw, t_cw, uv)
    return img.reshape(H, W), X.reshape(H, W, 3), hit.reshape(H, W)


_TEXTURES: dict = {}    # (id, device) -> (texture, its device copy)


def _texture_on(tex: np.ndarray, device: torch.device) -> torch.Tensor:
    """A texture's device copy, uploaded once per texture and device."""
    key = (id(tex), device)
    if key not in _TEXTURES or _TEXTURES[key][0] is not tex:
        if len(_TEXTURES) > 32:
            _TEXTURES.clear()
        _TEXTURES[key] = (tex, torch.from_numpy(
            np.ascontiguousarray(tex, np.float32)).to(device))
    return _TEXTURES[key][1]


def render_image(cam: cameras.CameraParams, planes, R_cw, t_cw,
                 device) -> torch.Tensor:
    """``render_frame_raycast``'s image as a float32 tensor [H, W] on
    ``device``: the same rays and bilinear texture reads as ``raycast``,
    in torch (float64 rays, float32 texture weights), so that long
    sequences render on the card. Undistorted pinhole cameras only."""
    if cam.kind != cameras.PINHOLE or any(cam.dist):
        raise ValueError("render_image takes an undistorted pinhole camera")
    dev = torch.device(device)
    f64 = torch.float64
    H, W = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    rays = torch.stack([(uu.reshape(-1) - cam.cx) / cam.fx,
                        (vv.reshape(-1) - cam.cy) / cam.fy,
                        torch.ones(H * W, dtype=f64, device=dev)], dim=1)
    R_wc = np.asarray(R_cw, np.float64).T
    C_w = -R_wc @ np.asarray(t_cw, np.float64)
    rays_w = rays @ torch.from_numpy(R_wc.T.copy()).to(dev)
    Cw = torch.from_numpy(C_w).to(dev)
    out = torch.full((H * W,), 90.0, dtype=torch.float32, device=dev)
    depth = torch.full((H * W,), float("inf"), dtype=f64, device=dev)
    for pl in planes:
        n = np.cross(pl.e1, pl.e2)
        nn = torch.from_numpy(n / np.linalg.norm(n)).to(dev)
        denom = rays_w @ nn
        num = (torch.from_numpy(np.asarray(pl.origin, np.float64)).to(dev)
               - Cw) @ nn
        ok = torch.abs(denom) > 1e-9
        d = torch.where(ok, num / torch.where(ok, denom,
                                              torch.ones_like(denom)),
                        torch.full_like(denom, float("inf")))
        hit = (d > 0.05) & torch.isfinite(d)
        Xw = Cw + rays_w * torch.where(hit, d, torch.zeros_like(d))[:, None]
        G = np.array([[pl.e1 @ pl.e1, pl.e1 @ pl.e2],
                      [pl.e2 @ pl.e1, pl.e2 @ pl.e2]])
        P = torch.from_numpy(np.stack([pl.e1, pl.e2], 1).astype(np.float64)
                             @ np.linalg.inv(G).T).to(dev)
        ab = (Xw - torch.from_numpy(np.asarray(pl.origin, np.float64)).to(
            dev)) @ P
        h, w = pl.texture.shape
        inside = ((ab[:, 0] >= 0) & (ab[:, 0] < w - 1) & (ab[:, 1] >= 0)
                  & (ab[:, 1] < h - 1) & hit & (d < depth))
        a0 = torch.where(inside, ab[:, 0], torch.zeros_like(ab[:, 0]))
        a1 = torch.where(inside, ab[:, 1], torch.zeros_like(ab[:, 1]))
        x0, y0 = a0.long(), a1.long()
        fx = (a0 - x0).to(torch.float32)
        fy = (a1 - y0).to(torch.float32)
        tx = _texture_on(pl.texture, dev).reshape(-1)
        i00 = y0 * w + x0
        val = (tx[i00] * (1 - fx) * (1 - fy) + tx[i00 + 1] * fx * (1 - fy)
               + tx[i00 + w] * (1 - fx) * fy + tx[i00 + w + 1] * fx * fy)
        out = torch.where(inside, val, out)
        depth = torch.where(inside, d, depth)
    return out.reshape(H, W)


def stereo_right_t(R_cw, t_cw, baseline: float) -> np.ndarray:
    """t_cw of a rectified pair's right camera: the left one displaced by
    baseline along its +x (the same R_cw)."""
    c_r = -R_cw.T @ t_cw + R_cw.T @ np.array([baseline, 0.0, 0.0])
    return (-R_cw @ c_r).astype(np.float32)


def render_stereo_pair(cam: cameras.CameraParams, planes, R_cw, t_cw,
                       baseline: float):
    """A rectified left/right pair [H, W] float32 (``stereo_right_t``)."""
    left = render_frame_raycast(cam, planes, R_cw, t_cw)[0]
    return left, render_frame_raycast(
        cam, planes, R_cw, stereo_right_t(R_cw, t_cw, baseline))[0]


def camera_depth(R_cw, t_cw, X_w: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """Depth map [H, W] float32 from a ray cast's hits: the camera-frame z
    of each pixel's hit, 0 where the ray hits nothing."""
    z = X_w @ R_cw[2].astype(np.float64) + float(t_cw[2])
    return np.where(hit, z, 0.0).astype(np.float32)


def render_depth(cam: cameras.CameraParams, planes, R_cw, t_cw) -> np.ndarray:
    """Exact per-pixel depth [H, W] float32 of the world seen from T_cw."""
    _, X, hit = render_frame_raycast(cam, planes, R_cw, t_cw)
    return camera_depth(R_cw, t_cw, X, hit)


def seed_map(cam: cameras.CameraParams, planes, R_cw, t_cw, kf_every: int,
             cfg: MapConfig, device=None,
             orb_cfg: extractor.OrbConfig | None = None,
             radius: float = 4.0) -> MapStore:
    """Build a map from ground truth along a trajectory: every
    ``kf_every``-th frame is rendered at its true pose, extracted with the
    port's ``prepare_frame``, associated to the existing map at the true
    pose (``gather_and_project`` + ``search_by_projection``, `radius` px at
    level 0), and inserted as a keyframe. Matched features observe the
    existing points; unmatched features whose ray hits a plane create
    points at the exact hit, up to the point capacity. Keyframes are linked
    through ``kf_prev``; point statistics are refreshed per keyframe."""
    store = MapStore(cfg, device)
    dev = store.device
    orb_cfg = orb_cfg or extractor.OrbConfig(n_features=cfg.n_feat)
    radius_scale, _ = kernels.level_weights(orb_cfg.n_levels, orb_cfg.scale)
    radius_scale = torch.from_numpy(radius_scale).to(dev)
    prev = -1
    for i in range(0, len(R_cw), kf_every):
        img, _, _ = render_frame_raycast(cam, planes, R_cw[i], t_cw[i])
        prep = kernels.prepare_frame(torch.from_numpy(img).to(dev), cam,
                                     orb_cfg)
        feat = prep.feat
        N = feat.xy.shape[0]
        feat_point = torch.full((N,), -1, dtype=torch.int32, device=dev)
        live = np.where(store.pt_valid)[0]
        if len(live):
            T = SE3(torch.from_numpy(R_cw[i]).to(dev),
                    torch.from_numpy(t_cw[i]).to(dev))
            ids = torch.from_numpy(live.astype(np.int32)).to(dev)
            dp = store.device_points()
            proj = kernels.gather_and_project(
                T, ids, dp["xyz"], dp["normal"], dp["min_dist"],
                dp["max_dist"], dp["valid"], cam, orb_cfg.scale,
                orb_cfg.n_levels, pt_proj8=dp["proj8"])
            res = matching.search_by_projection(
                proj.uv, proj.visible, dp["desc"][ids.long()],
                proj.level, feat._replace(xy=prep.xy_ud),
                radius * radius_scale[proj.level.long()],
                max_dist=matching.TH_HIGH, ratio=0.8)
            feat_point = kernels.invert_matches(res, ids, N)
        fp = feat_point.cpu().numpy()
        xy = prep.xy_ud.cpu().numpy()
        valid = feat.valid.cpu().numpy()
        _, X, hit = raycast(cam, planes, R_cw[i], t_cw[i],
                            feat.xy.cpu().numpy().astype(np.float64))
        new = np.where(valid & hit & (fp < 0))[0]
        new = new[:len(np.where(~store.pt_valid)[0])]
        k = store.alloc_kf()
        desc = feat.desc.cpu().numpy()
        touched = fp[fp >= 0]
        if len(new):
            C = -R_cw[i].T.astype(np.float64) @ t_cw[i]
            v = X[new] - C
            normals = v / np.linalg.norm(v, axis=1, keepdims=True)
            pids = store.add_points(X[new].astype(np.float32), desc[new], k,
                                    normals=normals.astype(np.float32))
            fp[new] = pids
            touched = np.concatenate([touched, pids])
        if store.add_keyframe(
                R_cw[i], t_cw[i], float(i), i, xy, prep.xyn.cpu().numpy(),
                feat.level.cpu().numpy(), feat.angle.cpu().numpy(), desc,
                valid, fp) != k:
            raise RuntimeError("keyframe slot changed during insertion")
        store.kf_prev[k] = prev
        prev = k
        store.update_point_stats(np.unique(touched))
    return store
