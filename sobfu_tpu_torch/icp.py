"""Rigid projective ICP (point-to-plane, coarse-to-fine).

PyTorch counterpart of ``sobfu_tpu.icp`` (reference
src/kfusion/projective_icp.cpp, src/kfusion/cuda/proj_icp.cu). The
correspondence search, the 7x7 normal system and its solve stay on the
tensors' device; a pyramid level reads one flag to the host (whether the
system ever degenerated), as the JAX package does.

Per candidate pixel (proj_icp.cu:72-98):
  s = T * backproject(curr)            (current point into prev frame)
  project s -> prev pixel; reject if behind camera / out of image
  d = prev point at that pixel;        reject if invalid
  reject if ||s - d||^2 > dist_thres^2
  reject if |<R n_curr, n_prev>| < cos(angle_thres)
accepted rows (proj_icp.cu:344-347):
  row = [cross(s, n_prev), n_prev | dot(n_prev, d - s)]
solve (A = sum rr^T, b = sum r*r6) by least squares; T <- Tinc(r) * T.

The least-squares solve is ``jnp.linalg.lstsq``'s: an SVD of A, singular
values below eps * 6 * s_max (or zero) dropped, the minimum-norm solution.
It runs through ``torch.linalg.svd`` on every device (CUDA's
``torch.linalg.lstsq`` is QR and assumes full rank), so a near-singular
system gives the same answer on the card, on the CPU and in JAX. The
normal system is summed in float32: TF32 matmuls must stay off
(``torch.backends.cuda.matmul.allow_tf32``, False by default).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from sobfu_tpu_torch.config import Intr
from sobfu_tpu_torch.ops import imgproc

MAX_PYRAMID_LEVELS = 4  # reference projective_icp.hpp:9
DEFAULT_ITERS = (10, 5, 4, 0)  # reference projective_icp.cpp:63-66
# jnp.linalg.lstsq's default cutoff for a 6x6 system: eps(f32) * max(M, N)
LSTSQ_RCOND = float(np.finfo(np.float32).eps) * 6


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix (cv::Affine3f(rvec, t) semantics)."""
    theta = torch.sqrt(torch.sum(rvec * rvec))
    k = rvec / torch.clamp(theta, min=1e-12)
    zero = torch.zeros((), dtype=rvec.dtype, device=rvec.device)
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-12, eye, R)


def _affine(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(A, b)[0]`` for a square A: the minimum-norm
    solution through the SVD, singular values under LSTSQ_RCOND * s[0]
    (or not positive) dropped."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = (s > 0) & (s >= LSTSQ_RCOND * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return Vh.T @ (s_inv * (U.T @ b))


def _icp_level(affine: torch.Tensor, points_curr: torch.Tensor, normals_curr: torch.Tensor,
               points_prev: torch.Tensor, normals_prev: torch.Tensor, intr, dist2_thresh: float,
               min_cosine: float, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``iters`` point-to-plane iterations at one pyramid level.

    Returns (affine, ok) as tensors on the maps' device, with no host read:
    ok becomes False if the normal system ever degenerates (|det A| under
    1e-15, the reference's nullspace check, projective_icp.cpp:142-148),
    and such an iteration leaves the affine as it was.

    The correspondence pixel is round(u) (half to even) clamped to the
    image; pixels that project outside it are masked by the float test
    ``in_img`` before anything reads them, so no result depends on how a
    device casts NaN or an out-of-range u to an integer.
    """
    H, W = points_curr.shape[:2]
    dev = points_curr.device
    fx, fy, cx, cy = imgproc._intr(intr, dev)
    T = affine
    ok = torch.ones((), dtype=torch.bool, device=dev)
    pc = points_curr.reshape(-1, 3)
    nc = normals_curr.reshape(-1, 3)
    pp = points_prev.reshape(-1, 3)
    npv = normals_prev.reshape(-1, 3)
    curr_ok = ~torch.isnan(pc[:, 0])
    for _ in range(iters):
        R, t = T[:3, :3], T[:3, 3]
        s = pc @ R.T + t
        ns = nc @ R.T
        u = fx * s[:, 0] / s[:, 2] + cx
        v = fy * s[:, 1] / s[:, 2] + cy
        in_img = (s[:, 2] > 0) & (u >= 0) & (v >= 0) & (u < W) & (v < H)
        ui = torch.where(in_img, torch.round(u), 0.0).clamp(0, W - 1).to(torch.int64)
        vi = torch.where(in_img, torch.round(v), 0.0).clamp(0, H - 1).to(torch.int64)
        flat = vi * W + ui
        d = pp[flat]
        nd = npv[flat]
        diff = s - d
        dist2 = torch.sum(diff * diff, dim=-1)
        cosine = torch.abs(torch.sum(ns * nd, dim=-1))
        valid = (curr_ok & in_img & ~torch.isnan(d[:, 0]) & (dist2 <= dist2_thresh)
                 & (cosine >= min_cosine))
        r6 = torch.sum(nd * (d - s), dim=-1)
        rows = torch.cat([imgproc._cross(s, nd), nd, r6[:, None]], dim=-1)
        rows = torch.where(valid[:, None], rows, 0.0)
        G = rows.T @ rows
        A, b = G[:6, :6], G[:6, 6]
        det_ok = torch.abs(torch.linalg.det(A)) >= 1e-15
        sol = _lstsq(A, b)
        sol = torch.where(torch.isfinite(sol), sol, 0.0)
        Tinc = _affine(rodrigues(sol[:3]), sol[3:])
        T = torch.where(det_ok, Tinc @ T, T)
        ok = ok & det_ok
    return T, ok


class ProjectiveICP:
    """Reference kfusion::cuda::ProjectiveICP surface."""

    def __init__(self):
        self.angle_thres = np.deg2rad(20.0)
        self.dist_thres = 0.1
        self.iters: List[int] = list(DEFAULT_ITERS)

    def set_iterations(self, iters: Sequence[int]) -> None:
        it = list(iters)[:MAX_PYRAMID_LEVELS]
        it += [0] * (MAX_PYRAMID_LEVELS - len(it))
        self.iters = it

    def used_levels(self) -> int:
        n = MAX_PYRAMID_LEVELS
        while n > 0 and self.iters[n - 1] == 0:
            n -= 1
        return n

    # -- pyramid builders ---------------------------------------------------
    @staticmethod
    def build_pyramid(depth: torch.Tensor, intr: Intr, levels: int, sigma_depth: float = 0.04):
        """Depth + point + normal pyramids from a mm depth map."""
        depths, points, normals = [], [], []
        d = depth
        for lvl in range(levels):
            p, n = imgproc.compute_points_normals(d, intr.level(lvl))
            depths.append(d)
            points.append(p)
            normals.append(n)
            if lvl + 1 < levels:
                d = imgproc.depth_pyramid_down(d, sigma_depth)
        return depths, points, normals

    # -- main solve (reference projective_icp.cpp:115-156) ------------------
    def estimate_transform(
        self,
        intr: Intr,
        points_curr: List[torch.Tensor],
        normals_curr: List[torch.Tensor],
        points_prev: List[torch.Tensor],
        normals_prev: List[torch.Tensor],
    ) -> Tuple[np.ndarray, bool]:
        """Coarse-to-fine point-to-plane ICP. Returns (4x4 affine, success):
        one host read of the success flag per level and one of the affine."""
        levels = self.used_levels()
        T = torch.eye(4, dtype=torch.float32, device=points_curr[0].device)
        ok_all = True
        dist2 = float(np.float32(self.dist_thres ** 2))
        min_cos = float(np.float32(np.cos(self.angle_thres)))
        for lvl in range(levels - 1, -1, -1):
            if self.iters[lvl] == 0:
                continue
            T, ok = _icp_level(
                T, points_curr[lvl], normals_curr[lvl], points_prev[lvl], normals_prev[lvl],
                intr.level(lvl), dist2, min_cos, int(self.iters[lvl]),
            )
            ok_all = ok_all and bool(ok)
        return T.cpu().numpy(), ok_all

    def estimate_transform_from_depth(self, intr: Intr, depth_curr: torch.Tensor,
                                      depth_prev: torch.Tensor) -> Tuple[np.ndarray, bool]:
        levels = self.used_levels()
        _, pc, nc = self.build_pyramid(depth_curr, intr, levels)
        _, pp, np_ = self.build_pyramid(depth_prev, intr, levels)
        return self.estimate_transform(intr, pc, nc, pp, np_)
