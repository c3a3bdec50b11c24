"""Depth-image preprocessing: bilateral filter, truncation, dists.

PyTorch counterpart of the main-path subset of ``sobfu_tpu.ops.imgproc``
(reference src/kfusion/cuda/imgproc.cu). Depth maps are millimetres held as
int32 tensors [H, W] inside the port (torch's uint16 has few operations);
uint16 appears only at I/O. Dists maps are float32 metres.
"""

from __future__ import annotations

import numpy as np
import torch


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y+dy, x+dx], 0 outside."""
    H, W = a.shape
    out = torch.zeros_like(a)
    ys, ye = max(0, -dy), min(H, H - dy)
    xs, xe = max(0, -dx), min(W, W - dx)
    if ys < ye and xs < xe:
        out[ys:ye, xs:xe] = a[ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def bilateral_filter(depth: torch.Tensor, kernel_size: int, sigma_spatial: float,
                     sigma_depth: float) -> torch.Tensor:
    """Depth-aware bilateral filter on a mm depth map -> int32 mm.

    Reference window semantics (imgproc.cu:18-36): offsets span
    [-k/2, k - k/2) and neighbours are clamped to EXCLUDE the last row and
    column. sigma_depth is in metres. The result is rounded half to even,
    as ``jnp.rint``.
    """
    H, W = depth.shape
    d = depth.to(torch.float32)
    k = int(kernel_size)
    r = k // 2
    sig_space = 0.5 / (sigma_spatial * sigma_spatial)
    sig_depth_mm = sigma_depth * 1000.0
    sig_color = 0.5 / (sig_depth_mm * sig_depth_mm)
    yy = torch.arange(H, device=d.device)[:, None]
    xx = torch.arange(W, device=d.device)[None, :]
    sum1 = torch.zeros_like(d)
    sum2 = torch.zeros_like(d)
    for dy in range(-r, k - r):
        for dx in range(-r, k - r):
            nb = _shift2d(d, dy, dx)
            valid = (yy + dy >= 0) & (yy + dy <= H - 2) & (xx + dx >= 0) & (xx + dx <= W - 2)
            space2 = float(dx * dx + dy * dy)
            color2 = (d - nb) * (d - nb)
            w = torch.where(
                valid, torch.exp(-(space2 * sig_space + color2 * sig_color)), 0.0
            )
            sum1 = sum1 + nb * w
            sum2 = sum2 + w
    return torch.round(sum1 / sum2).to(torch.int32)


def truncate_depth(depth: torch.Tensor, max_dist_m: float) -> torch.Tensor:
    """Zero out depths beyond max_dist metres (mm in, mm out)."""
    max_mm = int(np.float32(max_dist_m) * np.float32(1000.0))
    return torch.where(depth > max_mm, torch.zeros_like(depth), depth)


def compute_dists(depth: torch.Tensor, intr) -> torch.Tensor:
    """dists = depth_mm * sqrt(xl^2 + yl^2 + 1) * 0.001; intr = (fx,fy,cx,cy)."""
    H, W = depth.shape
    dev = depth.device
    fx, fy, cx, cy = (torch.tensor(np.float32(v), device=dev) for v in intr)
    xl = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx) / fx
    yl = (torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy) / fy
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)
    return depth.to(torch.float32) * lam * 0.001
