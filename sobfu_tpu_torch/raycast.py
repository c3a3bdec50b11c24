"""TSDF raycasting: volume -> depth / point / normal maps from a camera.

PyTorch counterpart of ``sobfu_tpu.raycast``: KinectFusion-style ray
marching with a linear zero-crossing refinement. Every ray marches in
lock-step for a fixed ``max_steps``, as the JAX package's ``lax.scan`` does:
there is no early exit, and the loop reads nothing back to the host.

Plain torch on the tensors' device (no kernel of its own yet): one step is
about 55 elementwise and gather launches over the H x W rays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sobfu_tpu_torch import fields


def _sample(flat_tsdf, flat_weight, coords, dims_zyx, hi):
    """(trilinear tsdf, floor-corner weight > 0 and inside the volume) at
    coords f32[3, N] (voxel units, channels x, y, z).

    The arithmetic of ``fields.sample_trilinear`` and
    ``fields.sample_nearest_floor`` (the clamp, the floor corner, the blend
    in x, then y, then z), with the eight corners gathered through one
    index tensor to keep the launches of a step few.
    """
    Z, Y, X = dims_zyx
    c = torch.minimum(torch.maximum(coords, torch.zeros_like(hi)), hi)
    c0 = torch.floor(c)
    frac = c - c0
    i0 = c0.to(torch.int64)
    i1 = torch.minimum(i0 + 1, hi.to(torch.int64))
    stride = torch.tensor([1, X, X * Y], dtype=torch.int64, device=coords.device)[:, None]
    ix = torch.stack([i0[0], i1[0]])
    s0, s1 = i0 * stride, i1 * stride
    iy = torch.stack([s0[1], s1[1]])
    iz = torch.stack([s0[2], s1[2]])
    idx = iz[:, None, None] + iy[None, :, None] + ix[None, None, :]  # [z, y, x, N]
    v = flat_tsdf[idx]
    vx = v[:, :, 0] + (v[:, :, 1] - v[:, :, 0]) * frac[0]  # [z, y, N]
    vy = vx[:, 0] + (vx[:, 1] - vx[:, 0]) * frac[1]  # [z, N]
    f = vy[0] + (vy[1] - vy[0]) * frac[2]
    w = flat_weight[idx[0, 0, 0]]
    inside = ((coords >= 0) & (coords <= hi)).all(dim=0)
    return f, (w > 0) & inside


def raycast(tsdf: torch.Tensor, weight: torch.Tensor, cam2vol, intr, voxel_sizes,
            height: int, width: int, step_m: float,
            max_steps: int = 512) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """March every pixel ray through the volume to the first +/- crossing.

    tsdf, weight: f32[Z,Y,X] (tsdf normalised to [-1, 1]); cam2vol: 4x4
    camera -> volume-metric affine; intr: (fx, fy, cx, cy); voxel_sizes:
    (x, y, z) metres; step_m: the metric step. Returns (depth [H,W] metres
    along camera z, points [H,W,3] camera coords, normals [H,W,3] camera
    coords); zeros where no surface is hit.
    """
    dev = tsdf.device
    f32 = np.float32
    fx, fy, cx, cy = (torch.tensor(f32(v), device=dev) for v in intr)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    dirs_cam = torch.stack([
        ((u - cx) / fx).expand(height, width),
        ((v - cy) / fy).expand(height, width),
        torch.ones((height, width), dtype=torch.float32, device=dev),
    ])  # [3, H, W], unnormalised (z-step parametrisation)
    m = torch.as_tensor(np.asarray(cam2vol, f32), device=dev)
    R = m[:3, :3]
    origin = m[:3, 3][:, None]
    dirs_vol = torch.einsum("ij,jhw->ihw", R, dirs_cam).reshape(3, -1)
    inv_vs = torch.as_tensor(f32(1.0) / np.asarray(voxel_sizes, f32), device=dev)[:, None]
    Z, Y, X = tsdf.shape
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=dev)[:, None]
    flat_t, flat_w = tsdf.reshape(-1), weight.reshape(-1)
    step = f32(step_m)

    n = height * width
    t_hit = torch.zeros(n, dtype=torch.float32, device=dev)
    f_prev = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    valid_prev = torch.zeros(n, dtype=torch.bool, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(max_steps):
        t = f32(i + 1) * step
        coords = (origin + float(t) * dirs_vol) * inv_vs - 0.5
        f, ok = _sample(flat_t, flat_w, coords, (Z, Y, X), hi)
        crossing = valid_prev & ok & (f_prev > 0) & (f <= 0) & ~found
        denom = f_prev - f
        denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        t_ref = float(t - step) + float(step) * f_prev / denom
        t_hit = torch.where(crossing, t_ref, t_hit)
        found = found | crossing
        f_prev, valid_prev = f, ok

    depth = torch.where(found, t_hit, 0.0)
    points = dirs_cam.reshape(3, -1) * depth[None]
    # normals: the TSDF gradient at the hit (per voxel index), scaled by
    # 1/vs to metres, rotated into camera coords (R^T)
    p_hit = (origin + t_hit[None] * dirs_vol) * inv_vs - 0.5
    g = fields.interpolate_gradient(tsdf, p_hit) * inv_vs
    g = torch.einsum("ji,jn->in", R, g)
    norm = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True))
    normals = torch.where(found[None] & (norm > 1e-12), g / torch.clamp(norm, min=1e-12), 0.0)
    return (depth.reshape(height, width), points.T.reshape(height, width, 3),
            normals.T.reshape(height, width, 3))


def raycast_volume(volume, camera_pose: np.ndarray, intr, height: int, width: int,
                   step_factor: float = 0.75, max_steps: int = 512):
    """:func:`raycast` of a TsdfVolume from ``camera_pose`` (step = factor *
    the smallest voxel size, the reference's raycast_step_factor)."""
    cam2vol = np.linalg.inv(np.asarray(volume.pose, np.float32)) @ np.asarray(
        camera_pose, np.float32
    )
    vs = volume.voxel_sizes()
    return raycast(volume.tsdf, volume.weight, cam2vol, intr, vs, height, width,
                   float(np.float32(step_factor * min(vs))), max_steps=max_steps)
