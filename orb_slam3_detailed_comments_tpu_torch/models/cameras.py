"""Camera models: pinhole (radial-tangential) and Kannala-Brandt8 fisheye.

Counterpart of ``models/cameras.py`` of the JAX package (reference:
CameraModels/Pinhole.cpp, KannalaBrandt8.cpp). Batched over points
([..., 3] / [..., 2]) with no Python branching on data. ``CameraParams``
is a plain hashable tuple of Python numbers, shared by both devices.

Conventions: points are in camera frame (z forward); pixel coords (u, v).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

PINHOLE = 0
FISHEYE_KB8 = 1


class CameraParams(NamedTuple):
    """Flat camera description (see the JAX package for the field notes).

    dist: PINHOLE (k1, k2, p1, p2, k3); FISHEYE_KB8 (k1, k2, k3, k4, 0).
    """

    kind: int
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple
    width: int
    height: int

    def K(self, device="cpu") -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device)

    def fov_bound_cos(self) -> float:
        """cos of a conservative max half-FOV used for frustum checks."""
        half_w = max(self.cx, self.width - self.cx) / self.fx
        half_h = max(self.cy, self.height - self.cy) / self.fy
        tan_d = math.hypot(half_w, half_h)
        if self.kind == FISHEYE_KB8:
            tan_d = max(tan_d, math.tan(math.radians(89.0)))
        return math.cos(math.atan(tan_d))


def pinhole(fx, fy, cx, cy, width, height, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
            k3=0.0):
    return CameraParams(PINHOLE, float(fx), float(fy), float(cx), float(cy),
                        (float(k1), float(k2), float(p1), float(p2),
                         float(k3)), int(width), int(height))


def fisheye_kb8(fx, fy, cx, cy, width, height, k1=0.0, k2=0.0, k3=0.0,
                k4=0.0):
    return CameraParams(FISHEYE_KB8, float(fx), float(fy), float(cx),
                        float(cy), (float(k1), float(k2), float(k3),
                                    float(k4), 0.0), int(width), int(height))


# ---- pinhole + radtan (reference: CameraModels/Pinhole.cpp) ---------------

def _radtan_distort(xn: torch.Tensor, dist) -> torch.Tensor:
    k1, k2, p1, p2, k3 = dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _radtan_undistort(xd: torch.Tensor, dist, iters: int = 8) -> torch.Tensor:
    """Iterative inverse of radtan distortion (fixed-point, as OpenCV)."""
    k1, k2, p1, p2, k3 = dist
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = (xd - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    return xn


# ---- Kannala-Brandt (reference: CameraModels/KannalaBrandt8.cpp:40-228) ----

def _kb8_theta_d(theta: torch.Tensor, dist) -> torch.Tensor:
    k1, k2, k3, k4, _ = dist
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _kb8_invert_theta(theta_d: torch.Tensor, dist, iters: int = 10):
    """Newton solve theta from theta_d (reference: KannalaBrandt8.cpp:142)."""
    k1, k2, k3, k4, _ = dist
    th = torch.clamp(theta_d, -math.pi, math.pi)
    for _ in range(iters):
        t2 = th * th
        f = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3
                                                          + t2 * 9.0 * k4)))
        th = th - f / torch.clamp(df, min=1e-6)
    return th


# ---- public API ------------------------------------------------------------

def project(cam: CameraParams, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points [..., 3] -> pixels [..., 2] (no NaNs; callers
    gate on depth / in_image)."""
    if cam.kind == PINHOLE:
        z = pc[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        xn = pc[..., 0:2] / safe_z[..., None]
        xd = _radtan_distort(xn, cam.dist)
        return torch.stack([cam.fx * xd[..., 0] + cam.cx,
                            cam.fy * xd[..., 1] + cam.cy], dim=-1)
    if cam.kind == FISHEYE_KB8:
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        r = torch.sqrt(x * x + y * y)
        safe_r = torch.clamp(r, min=1e-9)
        theta = torch.atan2(r, z)
        scale = _kb8_theta_d(theta, cam.dist) / safe_r
        return torch.stack([cam.fx * x * scale + cam.cx,
                            cam.fy * y * scale + cam.cy], dim=-1)
    raise ValueError(f"unknown camera kind {cam.kind}")


def unproject_bearing(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> unit-norm bearing vectors [..., 3]."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    if cam.kind == PINHOLE:
        xn = _radtan_undistort(xd, cam.dist)
        b = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    elif cam.kind == FISHEYE_KB8:
        theta_d = torch.sqrt(torch.sum(xd * xd, dim=-1))
        theta = _kb8_invert_theta(theta_d, cam.dist)
        safe_td = torch.clamp(theta_d, min=1e-9)
        sin_t = torch.sin(theta)
        b = torch.stack([sin_t * xd[..., 0] / safe_td,
                         sin_t * xd[..., 1] / safe_td,
                         torch.cos(theta)], dim=-1)
    else:
        raise ValueError(f"unknown camera kind {cam.kind}")
    return b / torch.linalg.norm(b, dim=-1, keepdim=True)


def unproject(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> rays [..., 3] scaled to z = 1."""
    b = unproject_bearing(cam, uv)
    z = b[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return b / z[..., None]


def project_jac(cam: CameraParams, pc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(pc): [..., 2, 3]. Written out for the pinhole model (the JAX
    version takes jacfwd of ``project``; where ``project`` clamps |z| below
    1e-6 the z-derivative is zero there too); the fisheye model takes
    forward-mode autodiff of ``project``."""
    if cam.kind == FISHEYE_KB8:
        flat = pc.reshape(-1, 3)
        J = torch.func.vmap(torch.func.jacfwd(
            lambda p: project(cam, p)))(flat)
        # forward-mode autodiff of the model hands back float64 here; the
        # pose solver's normal equations are float32
        return J.to(pc.dtype).reshape(*pc.shape[:-1], 2, 3)
    if cam.kind != PINHOLE:
        raise ValueError(f"unknown camera kind {cam.kind}")
    k1, k2, p1, p2, k3 = cam.dist
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    clamped = torch.abs(z) < 1e-6
    safe_z = torch.where(clamped, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / safe_z
    xn, yn = x * inv_z, y * inv_z
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dR = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)          # d radial / d r2
    a00 = radial + 2.0 * xn * xn * dR + 2.0 * p1 * yn + 6.0 * p2 * xn
    a01 = 2.0 * xn * yn * dR + 2.0 * p1 * xn + 2.0 * p2 * yn
    a10 = 2.0 * xn * yn * dR + 2.0 * p1 * xn + 2.0 * p2 * yn
    a11 = radial + 2.0 * yn * yn * dR + 6.0 * p1 * yn + 2.0 * p2 * xn
    # d(xn, yn)/d(x, y, z) = [[1/z, 0, -xn/z], [0, 1/z, -yn/z]]
    zero = torch.zeros_like(z)
    dz_x = torch.where(clamped, zero, -xn * inv_z)
    dz_y = torch.where(clamped, zero, -yn * inv_z)
    rows_u = [cam.fx * a00 * inv_z, cam.fx * a01 * inv_z,
              cam.fx * (a00 * dz_x + a01 * dz_y)]
    rows_v = [cam.fy * a10 * inv_z, cam.fy * a11 * inv_z,
              cam.fy * (a10 * dz_x + a11 * dz_y)]
    return torch.stack([torch.stack(rows_u, dim=-1),
                        torch.stack(rows_v, dim=-1)], dim=-2)


def in_image(cam: CameraParams, uv: torch.Tensor, border: float = 0.0):
    """Boolean mask [...]: pixel inside image bounds (with border margin)."""
    return ((uv[..., 0] >= border) & (uv[..., 0] < cam.width - border)
            & (uv[..., 1] >= border) & (uv[..., 1] < cam.height - border))


def undistort_points(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels -> ideal-pinhole pixels with the same K (fisheye
    passes through, as in the reference's Frame::UndistortKeyPoints)."""
    if cam.kind == FISHEYE_KB8:
        return uv
    xn = unproject(cam, uv)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx,
                        cam.fy * xn[..., 1] + cam.cy], dim=-1)
