"""Headless AR overlay (reference: Examples/ROS/ORB_SLAM3/src/AR/ViewerAR.cc).

Counterpart of ``viz/viewer_ar.py`` of the JAX package. The reference's AR
demo detects a dominant plane from the tracked map points
(ViewerAR::DetectPlane: 50 RANSAC rounds of 3-point planes scored by
relative point-plane distance) and renders a virtual cube anchored to it in
a Pangolin GL view. Here the plane fit is one batched-hypothesis RANSAC in
host numpy (``Plane``, ``detect_plane`` and ``cube_corners_world`` are the
JAX package's, unchanged), and the cube's wireframe is rasterised straight
into the frame with anti-aliased numpy lines, so the demo runs headless and
without OpenCV.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Plane:
    origin: np.ndarray   # [3] world point on the plane
    R_wp: np.ndarray     # [3,3] plane->world rotation; z = plane normal
    n_inliers: int = 0


def detect_plane(points_w: np.ndarray, T_cw: np.ndarray,
                 n_hyp: int = 50, seed: int = 0) -> "Plane | None":
    """Fit the dominant plane under the camera (ViewerAR::DetectPlane).

    points_w: [N,3] currently tracked map points (world frame).
    Inlier threshold is relative — median point depth * 0.02 — matching the
    reference's scale-free tolerance choice. Returns None if the best plane
    supports <50% of the points (reference rejects weak planes the same way).
    """
    pts = np.asarray(points_w, np.float64)
    N = len(pts)
    if N < 10:
        return None
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, size=(n_hyp, 3))
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)                       # [H,3]
    nrm = np.linalg.norm(n, axis=1, keepdims=True)
    ok = nrm[:, 0] > 1e-9
    n = np.where(nrm > 1e-9, n / np.maximum(nrm, 1e-12), 0.0)
    # relative threshold from camera-frame depths
    Rcw, tcw = np.asarray(T_cw)[:3, :3], np.asarray(T_cw)[:3, 3]
    depths = (pts @ Rcw.T + tcw)[:, 2]
    th = max(np.median(np.abs(depths)) * 0.02, 1e-6)
    d = -np.einsum("hj,hj->h", n, p0)                    # plane offsets
    dist = np.abs(pts @ n.T + d[None, :])                # [N,H]
    inl = (dist < th) & ok[None, :]
    votes = inl.sum(axis=0)
    best = int(np.argmax(votes))
    if votes[best] < max(10, 0.5 * N):
        return None
    sel = pts[inl[:, best]]
    centroid = sel.mean(axis=0)
    # least-squares refit on the winning consensus set
    _, _, Vt = np.linalg.svd(sel - centroid, full_matrices=False)
    normal = Vt[2]
    # orient the normal toward the camera (so the cube sits on top)
    cam_center = -Rcw.T @ tcw
    if np.dot(normal, cam_center - centroid) < 0:
        normal = -normal
    # complete a right-handed plane frame with z = normal
    a = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(a, normal)) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    x = np.cross(a, normal)
    x /= np.linalg.norm(x)
    y = np.cross(normal, x)
    R_wp = np.stack([x, y, normal], axis=1)
    return Plane(origin=centroid, R_wp=R_wp, n_inliers=int(votes[best]))


_CUBE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
               (4, 5), (5, 7), (7, 6), (6, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def cube_corners_world(plane: Plane, size: float) -> np.ndarray:
    """8 corners of a cube of edge `size` resting on the plane."""
    s = size / 2.0
    local = np.array([[sx, sy, sz]
                      for sz in (0.0, size)
                      for sy in (-s, s)
                      for sx in (-s, s)])
    return plane.origin + local @ plane.R_wp.T


def cube_pixels(cam, T_cw: np.ndarray, plane: Plane,
                size: float = 0.2):
    """[8, 2] int pixel corners of the cube (rounded projections), or None
    when a corner is behind the camera."""
    Rcw, tcw = np.asarray(T_cw)[:3, :3], np.asarray(T_cw)[:3, 3]
    pc = cube_corners_world(plane, size) @ Rcw.T + tcw
    if (pc[:, 2] <= 1e-6).any():
        return None
    fx, fy, cx, cy = float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    return np.array([[int(round(a)), int(round(b))] for a, b in zip(u, v)])


def aa_line(img: np.ndarray, p, q, color) -> None:
    """An anti-aliased line 2 pixels wide, in place: each pixel within
    reach takes the colour in proportion to its cover, clip(1 + 9/8 - d,
    0, 1) for a pixel centre at distance d from the segment (round ends).
    The reach 9/8 past the half width is fitted to cv2.line's LINE_AA at
    thickness 2, whose edge ramps over about two pixels."""
    H, W = img.shape[:2]
    r = 1.0 + 1.125
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    x0 = int(max(np.floor(min(p[0], q[0]) - r), 0))
    x1 = int(min(np.ceil(max(p[0], q[0]) + r), W - 1))
    y0 = int(max(np.floor(min(p[1], q[1]) - r), 0))
    y1 = int(min(np.ceil(max(p[1], q[1]) + r), H - 1))
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    d = q - p
    L2 = float(d @ d)
    s = np.zeros_like(xs) if L2 == 0 else np.clip(
        ((xs - p[0]) * d[0] + (ys - p[1]) * d[1]) / L2, 0.0, 1.0)
    dist = np.hypot(xs - (p[0] + s * d[0]), ys - (p[1] + s * d[1]))
    cover = np.clip(r - dist, 0.0, 1.0)[..., None]
    patch = img[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    col = np.asarray(color, np.float64)
    img[y0:y1 + 1, x0:x1 + 1] = np.rint(
        patch * (1 - cover) + col * cover).astype(img.dtype)


def draw_cube(img: np.ndarray, cam, T_cw: np.ndarray, plane: Plane,
              size: float = 0.2) -> np.ndarray:
    """Render the cube's wireframe into (a BGR copy of) the frame
    (ViewerAR's DrawCube, GL replaced by rasterised lines)."""
    out = np.asarray(img)
    if out.ndim == 2:
        out = np.repeat(out.astype(np.uint8)[..., None], 3, axis=2)
    else:
        out = out.copy()
    uv = cube_pixels(cam, T_cw, plane, size)
    if uv is None:
        return out  # cube (partly) behind the camera: skip overlay
    for a, b in _CUBE_EDGES:
        aa_line(out, uv[a], uv[b], (0, 220, 0))
    return out
