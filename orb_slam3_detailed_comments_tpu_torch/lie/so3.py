"""SO(3): rotation-group ops, batched over leading dims.

Counterpart of ``lie/so3.py`` of the JAX package (reference: Sophus SO3 and
the right-Jacobian helpers of include/ImuTypes.h:254-260).
Rotations are [..., 3, 3] float32 matrices; small-angle branches use Taylor
series selected with ``torch.where``.
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: w [..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t))
                    / torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> rotation vector [..., 3]; robust near
    theta = 0 and theta = pi, with the same branches as the JAX version."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_sin = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                               R[..., 0, 2] - R[..., 2, 0],
                               R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s2 = torch.sum(w_sin * w_sin, dim=-1)
    small = (s2 < 1e-10) & (cos_theta > 0.0)
    near_pi = cos_theta < -1.0 + 1e-6
    one = torch.ones_like(s2)
    sin_theta = torch.sqrt(torch.where(small, one, s2))
    theta = torch.atan2(torch.where(small, torch.zeros_like(s2), sin_theta),
                        cos_theta)
    scale = torch.where(small, 1.0 + s2 / 6.0,
                        theta / torch.where(small, one, sin_theta))
    w_generic = scale[..., None] * w_sin

    one_minus = torch.clamp(1.0 - cos_theta, min=1e-12)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None]) / one_minus[..., None],
                          0.0, 1.0)
    axis_abs = torch.sqrt(axis_sq)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    amax = torch.argmax(axis_abs, dim=-1)
    ax, ay, az = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    sx = torch.where(amax == 0, ax, torch.where(amax == 1, s01 * ax, s02 * ax))
    sy = torch.where(amax == 0, s01 * ay, torch.where(amax == 1, ay, s12 * ay))
    sz = torch.where(amax == 0, s02 * az, torch.where(amax == 1, s12 * az, az))
    axis_pi = torch.stack([sx, sy, sz], dim=-1)
    dot = torch.sum(axis_pi * w_sin, dim=-1, keepdim=True)
    axis_pi = torch.where(dot < 0, -axis_pi, axis_pi)
    w_pi = theta[..., None] * axis_pi
    return torch.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): Jl = I + B hat(w) + C hat(w)^2."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t))
                    / torch.clamp(theta2, min=_EPS * _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_t - torch.sin(safe_t))
                    / torch.clamp(theta2 * safe_t, min=_EPS * _EPS))
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) = Jl(-w) (reference: ImuTypes RightJacobianSO3)."""
    return left_jacobian(-w)


def inv_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian: Jl^-1 = I - 1/2 hat(w) + D hat(w)^2,
    D = 1/t^2 - (1 + cos t) / (2 t sin t), Taylor 1/12 + t^2/720."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / torch.clamp(theta2, min=_EPS * _EPS)
                    - (1.0 + torch.cos(safe_t))
                    / torch.clamp(2.0 * safe_t * torch.sin(safe_t),
                                  min=1e-12))
    W = hat(w)
    return _eye_like(W) - 0.5 * W + D[..., None, None] * (W @ W)


def inv_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian (reference: ImuTypes InverseRightJacobianSO3)."""
    return inv_left_jacobian(-w)


def normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a drifting rotation matrix (Gram-Schmidt)."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (x, y, z, w) -> rotation matrix [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (x, y, z, w).

    Branch-free Shepperd's method: all four candidate quaternions are
    computed and the best-conditioned one (largest pivot) is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(pivot, parts):
        h = torch.sqrt(torch.clamp(pivot, min=1e-12)) * 0.5
        q = torch.stack([4.0 * h * h if p is None else p for p in parts],
                        dim=-1)
        return q / (4.0 * h[..., None])

    q0 = cand(1.0 + tr, [m21 - m12, m02 - m20, m10 - m01, None])
    q1 = cand(1.0 + m00 - m11 - m22, [None, m01 + m10, m02 + m20, m21 - m12])
    q2 = cand(1.0 - m00 + m11 - m22, [m01 + m10, None, m12 + m21, m02 - m20])
    q3 = cand(1.0 - m00 - m11 + m22, [m02 + m20, m12 + m21, None, m10 - m01])
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(best == 0, q0, torch.where(
        best == 1, q1, torch.where(best == 2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
