"""The frame's front end: depth preprocessing and live-volume integration,
each one CUDA kernel on the card, with its plain torch version.

=====================  ===========================================  ==================
wrapper                computes                                     source
=====================  ===========================================  ==================
preprocess_depth (P)   bilateral filter -> truncation -> dists      csrc/preprocess.cu
integrate_dists (I)    projective TSDF integration of a dists map   csrc/integrate.cu
=====================  ===========================================  ==================

Neither has a TPU kernel to replace: the JAX package runs both in XLA
(``sobfu_tpu/ops/imgproc.py`` ``bilateral_filter``, ``truncate_depth``,
``compute_dists``; ``sobfu_tpu/tsdf.py`` ``integrate_dists``). In plain torch
they are about 1,300 small launches a 640x480 frame at 128^3.

Dispatch is by device: CPU tensors run the plain version; CUDA tensors
launch the kernel on the current stream or raise — there is no fallback.
``launch_counts`` counts the kernel launches and is touched nowhere else; it
is kept apart from ``kernels.launch_counts``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sobfu_tpu_torch.ops import imgproc
from sobfu_tpu_torch.ops.kernels import _check, _on_cpu
from sobfu_tpu_torch.tsdf import _truncate, voxel_centers

launch_counts = {"preprocess_depth": 0, "integrate_dists": 0}

# name -> (source, the JAX package's function it computes)
KERNELS = {
    "preprocess_depth": ("sobfu_tpu_torch/csrc/preprocess.cu", "sobfu_tpu/ops/imgproc.py:48"),
    "integrate_dists": ("sobfu_tpu_torch/csrc/integrate.cu", "sobfu_tpu/tsdf.py:59"),
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _launch(kernel: str, fn_name: str, device, *args) -> None:
    from sobfu_tpu_torch.ops._build import library

    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    launch_counts[kernel] += 1


def _floats(values) -> ctypes.Array:
    vals = [float(np.float32(v)) for v in values]
    return (ctypes.c_float * len(vals))(*vals)


# ---------------------------------------------------------------------------
# P: preprocess_depth
# ---------------------------------------------------------------------------


def preprocess_depth_plain(depth: torch.Tensor, kernel_size: int, sigma_spatial: float,
                           sigma_depth: float, max_dist_m: float, intr) -> torch.Tensor:
    """Bilateral filter -> depth truncation (when max_dist_m > 0) -> dists
    (metres): int32[H, W] mm -> f32[H, W]."""
    filtered = imgproc.bilateral_filter(depth, kernel_size, sigma_spatial, sigma_depth)
    if max_dist_m > 0:
        filtered = imgproc.truncate_depth(filtered, max_dist_m)
    return imgproc.compute_dists(filtered, intr)


def preprocess_depth(depth: torch.Tensor, kernel_size: int, sigma_spatial: float,
                     sigma_depth: float, max_dist_m: float, intr) -> torch.Tensor:
    """:func:`preprocess_depth_plain` as kernel P on a CUDA tensor."""
    if _on_cpu(depth):
        return preprocess_depth_plain(depth, kernel_size, sigma_spatial, sigma_depth,
                                      max_dist_m, intr)
    k = int(kernel_size)
    if not 1 <= k <= 31:
        raise ValueError(f"preprocess_depth: kernel size {k} outside [1, 31]")
    H, W = depth.shape
    dev = depth.device
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    sig_space, sig_color = imgproc.bilateral_weights(sigma_spatial, sigma_depth)
    _launch("preprocess_depth", "sobfu_preprocess_depth", dev,
            _check("depth", depth, (H, W), dev, torch.int32), out.data_ptr(), H, W, k,
            sig_space, float(np.float32(sig_color)),
            imgproc.max_depth_mm(max_dist_m) if max_dist_m > 0 else -1, _floats(intr))
    return out


# ---------------------------------------------------------------------------
# I: integrate_dists
# ---------------------------------------------------------------------------


def integrate_dists_plain(tsdf, weight, dists, vol2cam, intr, voxel_sizes, trunc_dist: float,
                          eta: float, axis_aligned: bool = False, z_offset: int = 0):
    """``tsdf.integrate_dists`` in plain torch (see its docstring)."""
    dev = tsdf.device
    Z, Y, X = tsdf.shape
    H, W = dists.shape
    f32 = lambda a: torch.as_tensor(np.float32(a), device=dev)  # noqa: E731
    fx, fy, cx, cy = (f32(v) for v in intr)
    vsx, vsy, vsz = (f32(v) for v in voxel_sizes)
    m = torch.as_tensor(np.asarray(vol2cam, np.float32), device=dev)
    t = m[:3, 3]
    if axis_aligned:
        # a*b + c as one rounding (addcmul), as XLA fuses the JAX package's
        # separable path into multiply-adds: the projection then lands on the
        # same pixel and the tsdf matches bit for bit
        ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev) + 0.5  # noqa: E731
        xs = torch.addcmul(t[0], ar(X), vsx)
        ys = torch.addcmul(t[1], ar(Y), vsy)
        zs = torch.addcmul(t[2], ar(Z) + float(z_offset), vsz)
        inv_z = 1.0 / zs
        u = torch.addcmul(cx, fx * xs[None, :], inv_z[:, None])  # f32[Z, X]
        v = torch.addcmul(cy, fy * ys[None, :], inv_z[:, None])  # f32[Z, Y]
        in_u = (u >= 0) & (u < W)
        in_v = (v >= 0) & (v < H)
        ui = torch.floor(u).long().clamp(0, W - 1)
        vi = torch.floor(v).long().clamp(0, H - 1)
        Dp = dists[vi[:, :, None], ui[:, None, :]]
        cam_z = zs[:, None, None]
        in_image = in_v[:, :, None] & in_u[:, None, :]
    else:
        vc = voxel_centers((Z, Y, X), voxel_sizes, device=dev)
        vc[2] += f32(z_offset) * vsz
        cam = torch.einsum("ij,jzyx->izyx", m[:3, :3], vc) + t[:, None, None, None]
        u = fx * (cam[0] / cam[2]) + cx
        v = fy * (cam[1] / cam[2]) + cy
        in_image = (u >= 0) & (v >= 0) & (u < W) & (v < H)
        ui = torch.floor(u).long().clamp(0, W - 1)
        vi = torch.floor(v).long().clamp(0, H - 1)
        Dp = torch.take(dists, vi * W + ui)
        cam_z = cam[2]
    valid = in_image & (Dp > 0.0) & (cam_z > 0.0)
    psdf = Dp - cam_z
    new_w = torch.where(psdf > -np.float32(eta), 1.0, 0.0)
    new_t = _truncate(psdf, f32(trunc_dist))
    return torch.where(valid, new_t, tsdf), torch.where(valid, new_w, weight)


def integrate_dists(tsdf, weight, dists, vol2cam, intr, voxel_sizes, trunc_dist: float,
                    eta: float, axis_aligned: bool = False, z_offset: int = 0):
    """:func:`integrate_dists_plain` as kernel I on CUDA tensors; returns new
    (tsdf, weight) tensors (the inputs may be one tensor)."""
    if _on_cpu(tsdf):
        return integrate_dists_plain(tsdf, weight, dists, vol2cam, intr, voxel_sizes,
                                     trunc_dist, eta, axis_aligned, z_offset)
    dev = tsdf.device
    Z, Y, X = tsdf.shape
    H, W = dists.shape
    if Z * Y * X >= 2 ** 31 or H * W >= 2 ** 31:
        raise ValueError("integrate_dists takes grids and maps under 2^31 elements")
    ptrs = [_check(n, a, s, dev) for n, a, s in
            (("tsdf", tsdf, (Z, Y, X)), ("weight", weight, (Z, Y, X)), ("dists", dists, (H, W)))]
    tout, wout = torch.empty_like(tsdf), torch.empty_like(weight)
    m = np.asarray(vol2cam, np.float32)
    p = _floats([*m[:3, :3].ravel(), *m[:3, 3], *intr, *voxel_sizes, trunc_dist, eta])
    _launch("integrate_dists", "sobfu_integrate_dists", dev, *ptrs, tout.data_ptr(),
            wout.data_ptr(), Z, Y, X, H, W, int(z_offset), int(bool(axis_aligned)), p)
    return tout, wout
