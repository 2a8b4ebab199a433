"""Synthetic textured-plane world, ray-cast renderer and map-seeding fixture.

Counterpart of a cv2-free subset of ``utils/synth_render.py`` of the JAX
package: the same blob textures and texture domains (``TEXTURE_DOMAINS``:
the vocabulary's domain-shift probes, the same draws bit for bit), worlds (``default_world``, the loop
world ``box_world``) and trajectories (``orbit_trajectory``,
``loop_trajectory``, ``inertial_trajectory``,
``inertial_loop_trajectory``), so a seed gives the same world in both
packages, and a ray-cast renderer for any camera model, modelled on its ``render_frame_raycast``, that also returns the
exact 3D hit of every ray. ``render_stereo_pair`` and ``render_depth``
(rectified stereo pairs, depth maps) are built on it: the JAX versions
warp with ``cv2``. ``render_frame`` is the JAX package's homography
renderer itself, ``cv2.warpPerspective``'s arithmetic (OpenCV 5) written
out in torch, for the cases that must be the JAX tests' own frames.
``seed_map`` builds the map that tracking runs against from ground
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


def texture_natural(rng, size=1200, alpha=1.2, contrast=55.0):
    """1/f^alpha-spectrum texture: the power-law amplitude statistics of
    natural imagery (vs _texture's piecewise-constant blobs). Corner
    detectors fire on a much broader, denser response distribution here —
    the domain-shift probe for the vocabulary (the bundled vocabulary is
    trained on blob statistics only)."""
    f = np.fft.fftfreq(size)
    fr = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    fr[0, 0] = fr[0, 1]
    amp = 1.0 / fr ** alpha
    phase = rng.uniform(0, 2 * np.pi, (size, size))
    spec = amp * np.exp(1j * phase)
    img = np.real(np.fft.ifft2(spec))
    img = (img - img.mean()) / (img.std() + 1e-9)
    return np.clip(120.0 + contrast * img, 0, 255).astype(np.float32)


def texture_lit(rng, size=1200, n_blobs=2000):
    """Blob texture under strong low-frequency lighting: a smooth
    illumination field (gradient + a few gaussian 'lamps', x0.4-1.6) over
    the base — breaks any brightness-constancy assumption in descriptors."""
    base = _texture(rng, size, n_blobs)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    gdir = rng.uniform(0, 2 * np.pi)
    field = 0.35 * (np.cos(gdir) * xx + np.sin(gdir) * yy)
    for _ in range(int(rng.integers(2, 5))):
        cy, cx = rng.uniform(0, 1, 2)
        sig = rng.uniform(0.08, 0.3)
        field += rng.uniform(0.2, 0.6) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    field = 0.4 + 1.2 * (field - field.min()) / (np.ptp(field) + 1e-9)
    return np.clip(base * field, 0, 255).astype(np.float32)


def texture_specular(rng, size=1200, n_blobs=1800, n_spots=14):
    """Blob texture with saturated specular spots: bright elliptical
    highlights that clip to white (a glossy plane under point lights) —
    saturation plateaus kill gradient information locally."""
    base = _texture(rng, size, n_blobs)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    for _ in range(n_spots):
        cy, cx = rng.uniform(0, size, 2)
        sy, sx = rng.uniform(8, 60, 2)
        th = rng.uniform(0, np.pi)
        dy, dx = yy - cy, xx - cx
        u = np.cos(th) * dx + np.sin(th) * dy
        v = -np.sin(th) * dx + np.cos(th) * dy
        base += 400.0 * np.exp(-(u ** 2 / (2 * sx ** 2)
                                 + v ** 2 / (2 * sy ** 2)))
    return np.clip(base, 0, 255).astype(np.float32)


TEXTURE_DOMAINS = {
    "blob": lambda rng, size: _texture(rng, size),
    "natural_1f": lambda rng, size: texture_natural(rng, size),
    "lit": lambda rng, size: texture_lit(rng, size),
    "specular": lambda rng, size: texture_specular(rng, size),
}


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


def inertial_trajectory(n_frames, imu_per_frame=20, dt=0.005,
                        gravity=np.array([0.0, 9.81, 0.0]),
                        true_bg=np.zeros(3), true_ba=np.zeros(3),
                        accel_amp=0.8, v0=np.array([0.05, 0.0, 0.35])):
    """Ground-truth body trajectory and an exactly consistent IMU stream,
    facing ``default_world`` (the JAX package's ``inertial_trajectory``):
    smooth body rates and world accelerations integrated with the
    first-order scheme that preintegration assumes, the rotation step a
    float32 ``so3.exp`` as there. Camera == body, starting at the identity
    looking down +z; gravity points along +y (image down).

    Returns dict: R_cw [T, 3, 3], t_cw [T, 3], frame times ts [T], windows
    (per frame the (acc [M, 3], gyro [M, 3], t [M]) since the previous
    frame; None for frame 0), gravity, centers [T, 3]."""
    from ..lie import so3
    n_steps = n_frames * imu_per_frame
    R = np.eye(3)
    v = np.asarray(v0, np.float64).copy()
    p = np.zeros(3)
    g = np.asarray(gravity, np.float64)
    Rs_f, ps_f = [R.copy()], [p.copy()]
    accs, gyros, t_meas = [], [], []
    for k in range(n_steps):
        t = k * dt
        w_b = np.array([0.03 * np.sin(2 * np.pi * 0.7 * t + 1.0),
                        0.08 * np.sin(2 * np.pi * 0.5 * t),
                        0.02 * np.sin(2 * np.pi * 0.9 * t + 2.0)])
        a_w = accel_amp * np.array([np.sin(2 * np.pi * 0.6 * t),
                                    0.5 * np.sin(2 * np.pi * 0.9 * t + 1.0),
                                    0.4 * np.sin(2 * np.pi * 0.4 * t + 2.0)])
        a_b = R.T @ (a_w - g)
        accs.append(a_b + true_ba)
        gyros.append(w_b + true_bg)
        t_meas.append((k + 1) * dt)
        p = p + v * dt + 0.5 * (R @ a_b + g) * dt * dt
        v = v + (R @ a_b + g) * dt
        R = R @ so3.exp(torch.from_numpy(
            (w_b * dt).astype(np.float32))).numpy().astype(np.float64)
        if (k + 1) % imu_per_frame == 0:
            Rs_f.append(R.copy())
            ps_f.append(p.copy())
    return _frames_and_windows(Rs_f, ps_f, accs, gyros, t_meas, n_frames,
                               imu_per_frame, dt, g)


def inertial_loop_trajectory(n_frames, imu_per_frame=10, dt=0.005,
                             radius=3.0, closes=1.06,
                             gravity=np.array([0.0, 9.81, 0.0]),
                             true_bg=np.zeros(3), true_ba=np.zeros(3),
                             wobble=0.05, yaw_burst=None):
    """A loop around the inside of ``box_world`` with an exactly consistent
    IMU stream (the JAX package's ``inertial_loop_trajectory``): the body
    circles at ``radius`` facing radially outward for ``closes``
    revolutions, its speed modulated by +-30 % and more (constant-speed
    circular motion leaves the accelerometer's scale unobservable), with
    a small body-rate wobble and a vertical bob; the rotation step is the
    float64 host Rodrigues formula. ``yaw_burst`` = (u0, u1, fac) scales
    the yaw rate by fac, then by 2 - fac, between the fractions u0 and u1
    of the run. Camera == body, gravity along +y.

    Returns ``inertial_trajectory``'s dict."""
    n_steps = n_frames * imu_per_frame
    total_t = n_steps * dt
    omega = 2 * np.pi * closes / total_t          # mean yaw rate (rad/s)
    R = np.eye(3)
    p = np.array([0.0, 0.0, radius])
    v = np.array([radius * omega, 0.0, 0.0])
    g = np.asarray(gravity, np.float64)
    Rs_f, ps_f = [R.copy()], [p.copy()]
    accs, gyros, t_meas = [], [], []
    for k in range(n_steps):
        t = k * dt
        r_cur = max(np.hypot(p[0], p[2]), 1e-6)
        s_cur = np.hypot(v[0], v[2])
        s_des = radius * omega * (1.0 + 0.30 * np.sin(2 * np.pi * 0.20 * t)
                                  + 0.35 * np.sin(2 * np.pi * 0.53 * t + 1.2)
                                  + 0.20 * np.sin(2 * np.pi * 0.97 * t + 0.5))
        w_yaw = s_cur / r_cur       # keeps the camera facing outward
        w_b = np.array([wobble * 0.3 * np.sin(2 * np.pi * 0.45 * t + 1.0),
                        w_yaw + wobble * np.sin(2 * np.pi * 0.3 * t),
                        wobble * 0.25 * np.sin(2 * np.pi * 0.6 * t + 2.0)])
        if yaw_burst is not None:
            u0, u1, fac = yaw_burst
            u = k / n_steps
            if u0 < u < u1:
                w_b[1] *= fac if u < (u0 + u1) / 2 else 2.0 - fac
        # centripetal for the current speed and radius, tangential tracking
        # of the speed profile (~1/8 s), a vertical bob
        p_hat = np.array([p[0], 0.0, p[2]]) / r_cur
        v_hat = (np.array([v[0], 0.0, v[2]]) / s_cur if s_cur > 1e-9
                 else np.array([1.0, 0.0, 0.0]))
        a_w = (-(s_cur * s_cur / r_cur) * p_hat
               + (8.0 * (s_des - s_cur)) * v_hat)
        a_w[1] = 0.8 * np.sin(2 * np.pi * 0.45 * t + 0.7)
        a_b = R.T @ (a_w - g)
        accs.append(a_b + true_ba)
        gyros.append(w_b + true_bg)
        t_meas.append((k + 1) * dt)
        p = p + v * dt + 0.5 * (R @ a_b + g) * dt * dt
        v = v + (R @ a_b + g) * dt
        R = R @ _rodrigues(w_b * dt)
        if (k + 1) % imu_per_frame == 0:
            Rs_f.append(R.copy())
            ps_f.append(p.copy())
    return _frames_and_windows(Rs_f, ps_f, accs, gyros, t_meas, n_frames,
                               imu_per_frame, dt, g)


def _frames_and_windows(Rs_f, ps_f, accs, gyros, t_meas, n_frames,
                        imu_per_frame, dt, g) -> dict:
    """The inertial trajectories' dict from the integrated body poses at
    the frames and the IMU samples."""
    accs = np.stack(accs).astype(np.float32)
    gyros = np.stack(gyros).astype(np.float32)
    t_meas = np.asarray(t_meas)
    R_wb = np.stack(Rs_f)[:n_frames]
    p_w = np.stack(ps_f)[:n_frames]
    R_cw = np.transpose(R_wb, (0, 2, 1)).astype(np.float32)
    t_cw = -np.einsum("tij,tj->ti", R_cw, p_w).astype(np.float32)
    ts = np.arange(n_frames) * imu_per_frame * dt
    windows = [None]
    for i in range(1, n_frames):
        s0, s1 = (i - 1) * imu_per_frame, i * imu_per_frame
        windows.append((accs[s0:s1], gyros[s0:s1], t_meas[s0:s1]))
    return dict(R_cw=R_cw, t_cw=t_cw, ts=ts, windows=windows, gravity=g,
                centers=p_w.astype(np.float32))


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
                 device, with_depth: bool = False, centre: float = 0.0):
    """``render_frame_raycast``'s image as a float32 tensor [H, W] on
    ``device``: the same rays and bilinear texture reads as ``raycast``,
    in torch (float64 rays, float32 texture weights; any other model than
    an undistorted pinhole casts ``cameras.unproject_bearing``'s float32
    bearings, as ``raycast`` does), so that long sequences render on the
    card. ``with_depth``: also ``render_depth``'s map [H, W] float32, 0
    where the ray hits nothing. ``centre``: pixel (c, r) casts the ray
    through (c + centre, r + centre); 0.5, the pixel's centre, is the JAX
    package's ``render_frame_raycast``."""
    dev = torch.device(device)
    f64 = torch.float64
    H, W = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(H, dtype=f64, device=dev) + centre,
                            torch.arange(W, dtype=f64, device=dev) + centre,
                            indexing="ij")
    if cam.kind == cameras.PINHOLE and not any(cam.dist):
        rays = torch.stack([(uu.reshape(-1) - cam.cx) / cam.fx,
                            (vv.reshape(-1) - cam.cy) / cam.fy,
                            torch.ones(H * W, dtype=f64, device=dev)], dim=1)
    else:
        rays = cameras.unproject_bearing(cam, torch.stack(
            [uu.reshape(-1), vv.reshape(-1)], 1).to(torch.float32)).to(f64)
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
    if with_depth:
        # a hit's camera z is its ray parameter times the ray's z (1 on
        # the pinhole's rays)
        z = depth * rays[:, 2]
        return out.reshape(H, W), torch.where(
            torch.isfinite(z), z,
            torch.zeros_like(z)).to(torch.float32).reshape(H, W)
    return out.reshape(H, W)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (the float32 product is exact
    in float64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def warp_perspective(tex: np.ndarray, H: np.ndarray, width: int,
                     height: int, device="cpu") -> torch.Tensor:
    """``cv2.warpPerspective(tex, H, (width, height), INTER_LINEAR,
    BORDER_CONSTANT, -1.0)`` for a float32 texture, by OpenCV 5's rule, as
    a float32 tensor [height, width] on ``device``: the inverse of H (in
    float64) rounded to float32; each output pixel (x, y) maps to
    w = fma(M20, x, y M21 + M22), sx = fma(M00, x, y M01 + M02) / w (sy
    alike), all in float32; the taps around (floor(sx), floor(sy)) are
    interpolated along x with a = sx - floor(sx), then along y, each step
    a fused multiply-add (as ``utils.config.rectify``); a tap outside the
    texture reads -1."""
    dev = torch.device(device)
    f32 = torch.float32
    M = torch.from_numpy(np.linalg.inv(np.asarray(H, np.float64))
                         .astype(np.float32)).to(dev)
    y, x = torch.meshgrid(torch.arange(height, dtype=f32, device=dev),
                          torch.arange(width, dtype=f32, device=dev),
                          indexing="ij")
    row = lambda r: y * M[r, 1] + M[r, 2]
    full = lambda v: torch.full_like(x, float(v))
    w = _fma32(full(M[2, 0]), x, row(2))
    sx = _fma32(full(M[0, 0]), x, row(0)) / w
    sy = _fma32(full(M[1, 0]), x, row(1)) / w
    th, tw = tex.shape
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    ax, ay = sx - x0f, sy - y0f
    # the taps read a copy with a border of 2 texels of -1: a corner
    # clipped to [-2, tw] x [-2, th] reads the same taps inside and -1
    # outside
    pad = torch.full((th + 4, tw + 4), -1.0, dtype=f32, device=dev)
    pad[2:th + 2, 2:tw + 2] = _texture_on(tex, dev)
    flat = pad.reshape(-1)
    clip = lambda v, hi: torch.nan_to_num(v, nan=-2.0).clamp(-2, hi).long() + 2
    i00 = clip(y0f, th) * (tw + 4) + clip(x0f, tw)
    f0 = _fma32(ax, flat[i00 + 1] - flat[i00], flat[i00])
    f1 = _fma32(ax, flat[i00 + tw + 5] - flat[i00 + tw + 4],
                flat[i00 + tw + 4])
    return _fma32(ay, f1 - f0, f0)


def render_frame(cam: cameras.CameraParams, planes, R_cw, t_cw,
                 device="cpu") -> np.ndarray:
    """The JAX package's homography renderer (``render_frame``) without
    OpenCV: each plane in front of the camera (its texture's centre at
    z >= 0.2) warped by ``warp_perspective`` through K [R e1 | R e2 |
    R o + t], later planes on top where their warp is >= 0, 90 where no
    plane lands. Computed on ``device``, returned as numpy [H, W]
    float32: the JAX renderer's image (OpenCV 5) bit for bit
    (``tests/test_torch_long_sequences.py``). An ideal pinhole only."""
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    dev = torch.device(device)
    out = torch.zeros((cam.height, cam.width), dtype=torch.float32,
                      device=dev)
    filled = torch.zeros((cam.height, cam.width), dtype=torch.bool,
                         device=dev)
    for pl in planes:
        c = R_cw @ (pl.origin + pl.e1 * pl.texture.shape[1] / 2
                    + pl.e2 * pl.texture.shape[0] / 2) + t_cw
        if c[2] < 0.2:
            continue
        H = K @ np.stack([R_cw @ pl.e1, R_cw @ pl.e2,
                          R_cw @ pl.origin + t_cw], axis=1)
        warped = warp_perspective(pl.texture, H, cam.width, cam.height, dev)
        mask = warped >= 0
        out = torch.where(mask, warped, out)
        filled |= mask
    return torch.where(filled, out, torch.full_like(out, 90.0)).cpu().numpy()


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
