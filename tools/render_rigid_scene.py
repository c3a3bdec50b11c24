"""Depth maps of a static scene from a moving camera, for the rigid
(KinFu) path: spheres in front of a wall, ray-cast analytically.

    from render_rigid_scene import render_depth, trajectory
    poses = trajectory(8, step_m=0.005, yaw_deg=0.2)
    depth = render_depth(poses[3], 480, 640, (525.0, 525.0, 319.5, 239.5),
                         spheres=[((0.0, 0.0, 1.5), 0.3)], wall_z=2.5)

World coordinates are the first camera's (x right, y down, z forward).
A pose is the 4x4 camera-to-world affine KinFu reports; the depth is the
camera z of the nearest hit, in millimetres (uint16, 0 where the ray
misses). numpy only.
"""

from __future__ import annotations

import numpy as np


def rot_y(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def trajectory(n_frames: int, step_m: float = 0.005, yaw_deg: float = 0.2,
               rot_x_deg: float = 0.0):
    """Camera-to-world poses: frame k is translated k * step_m along x and
    rotated k * yaw_deg about y (and k * rot_x_deg about x)."""
    poses = []
    for k in range(n_frames):
        T = np.eye(4)
        ax = np.deg2rad(k * rot_x_deg)
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(ax), -np.sin(ax)],
                       [0.0, np.sin(ax), np.cos(ax)]])
        T[:3, :3] = rot_y(k * yaw_deg) @ Rx
        T[:3, 3] = (k * step_m, 0.0, 0.0)
        poses.append(T)
    return poses


def render_depth(cam2world: np.ndarray, H: int, W: int, intr, spheres=(), wall_z=None,
                 max_mm: int = 65535) -> np.ndarray:
    """uint16 mm depth of ``spheres`` [(centre_xyz, radius)] and the plane
    z = wall_z (world), seen from ``cam2world``; intr = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = (float(v) for v in intr)
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    d_cam = np.stack([np.broadcast_to((u - cx) / fx, (H, W)),
                      np.broadcast_to((v - cy) / fy, (H, W)), np.ones((H, W))], axis=-1)
    R = np.asarray(cam2world, np.float64)[:3, :3]
    o = np.asarray(cam2world, np.float64)[:3, 3]
    w = d_cam @ R.T  # world direction whose camera z is 1: t is the camera z
    t_best = np.full((H, W), np.inf)
    for centre, radius in spheres:
        oc = o - np.asarray(centre, np.float64)
        a = np.sum(w * w, axis=-1)
        b = w @ oc
        disc = b * b - a * (oc @ oc - radius * radius)
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        ok = (disc > 0) & (t > 0)
        t_best = np.where(ok & (t < t_best), t, t_best)
    if wall_z is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (wall_z - o[2]) / w[..., 2]
        ok = np.isfinite(t) & (t > 0)
        t_best = np.where(ok & (t < t_best), t, t_best)
    z = np.where(np.isfinite(t_best), np.round(t_best * 1000.0), 0.0)
    return np.clip(z, 0, max_mm).astype(np.uint16)
