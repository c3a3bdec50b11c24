"""The four CUDA kernels of the main path and their plain torch versions.

==================  ==========================================  =============
wrapper             replaces (sobfu_tpu/ops/pallas_kernels.py)  source
==================  ==========================================  =============
gd_iteration (A)    fused_gd_iteration_pp :2443 (+ the db /     csrc/gd_iteration.cu
                    fold / stacked / step layouts)
warp (B)            window_warp_pallas :478,                    csrc/warp.cu
                    window_warp_pallas_mixed :508
inverse_fixed_point estimate_inverse_window_pallas_multi :3061  csrc/inverse.cu
(C)                 (+ estimate_inverse_window_pallas :1883)
warp_fuse (D)       window_warp_fuse_pallas :607                csrc/warp_fuse.cu
==================  ==========================================  =============

Each wrapper takes the JAX package's layouts and a window half-width ``K``
(None = the exact sampler, no displacement clamp). Dispatch is by device:
CPU tensors go to the plain torch version (``*_plain``, built from
:mod:`sobfu_tpu_torch.fields`); CUDA tensors launch the kernel on the
current stream or raise — there is no fallback. ``launch_counts`` counts
kernel launches per wrapper and is touched nowhere else.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from sobfu_tpu_torch import fields
from sobfu_tpu_torch.tsdf import fuse_volumes

launch_counts = {"gd_iteration": 0, "warp": 0, "inverse_fixed_point": 0, "warp_fuse": 0}

# what each kernel replaces and where its source lives (chip_smoke.py reports it)
KERNELS = {
    "gd_iteration": (
        "sobfu_tpu_torch/csrc/gd_iteration.cu",
        "sobfu_tpu/ops/pallas_kernels.py:2443",
    ),
    "warp": ("sobfu_tpu_torch/csrc/warp.cu", "sobfu_tpu/ops/pallas_kernels.py:478"),
    "inverse_fixed_point": (
        "sobfu_tpu_torch/csrc/inverse.cu",
        "sobfu_tpu/ops/pallas_kernels.py:3061",
    ),
    "warp_fuse": (
        "sobfu_tpu_torch/csrc/warp_fuse.cu",
        "sobfu_tpu/ops/pallas_kernels.py:607",
    ),
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, shape, device) -> int:
    """Validate a kernel operand; returns its device pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _K(K: Optional[int]) -> int:
    if K is None:
        return -1
    if int(K) < 0:
        raise ValueError(f"window half-width K must be >= 0 or None, got {K}")
    return int(K)


def _launch(kernel: str, fn_name: str, device, *args) -> None:
    from sobfu_tpu_torch.ops._build import library

    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    launch_counts[kernel] += 1


# ---------------------------------------------------------------------------
# B: warp
# ---------------------------------------------------------------------------


def warp_plain(vol, psi, K: Optional[int], floor: Sequence[bool]):
    """vol f32[C,Z,Y,X] sampled at psi; channel c uses the floor-corner rule
    where floor[c], trilinear otherwise; K None = exact sampler."""
    outs = []
    for c in range(vol.shape[0]):
        if K is None:
            f = fields.sample_nearest_floor if floor[c] else fields.sample_trilinear
            outs.append(f(vol[c], psi))
        else:
            f = (
                fields.sample_nearest_floor_window
                if floor[c]
                else fields.sample_trilinear_window
            )
            outs.append(f(vol[c], psi, K))
    return torch.stack(outs, dim=0)


def warp(vol, psi, K: Optional[int], floor: Sequence[bool]):
    """Kernel B: warp the C channels of vol f32[C,Z,Y,X] at psi."""
    C = vol.shape[0]
    if len(floor) != C:
        raise ValueError(f"floor has {len(floor)} entries for {C} channels")
    if _on_cpu(vol):
        return warp_plain(vol, psi, K, floor)
    if C > 32:
        raise ValueError("warp takes at most 32 channels")
    Z, Y, X = vol.shape[1:]
    dev = vol.device
    out = torch.empty_like(vol)
    mask = sum(1 << c for c in range(C) if floor[c])
    _launch(
        "warp", "sobfu_warp", dev,
        _check("vol", vol, (C, Z, Y, X), dev), C,
        _check("psi", psi, (3, Z, Y, X), dev),
        _check("out", out, (C, Z, Y, X), dev),
        Z, Y, X, _K(K), mask,
    )
    return out


# ---------------------------------------------------------------------------
# C: inverse fixed point
# ---------------------------------------------------------------------------


def inverse_fixed_point_plain(psi, iters: int, K: Optional[int], init=None):
    if K is None:
        return fields.estimate_inverse(psi, iters, init=init)
    return fields.estimate_inverse_window(psi, iters, K, init=init)


def inverse_fixed_point(psi, iters: int, K: Optional[int], init=None):
    """Kernel C: ``iters`` steps of q <- v - disp(psi)(q) from ``init``
    (None = identity) in one launch."""
    if _on_cpu(psi):
        return inverse_fixed_point_plain(psi, iters, K, init)
    Z, Y, X = psi.shape[1:]
    dev = psi.device
    out = torch.empty_like(psi)
    _launch(
        "inverse_fixed_point", "sobfu_inverse_fixed_point", dev,
        _check("psi", psi, (3, Z, Y, X), dev),
        None if init is None else _check("init", init, (3, Z, Y, X), dev),
        _check("out", out, (3, Z, Y, X), dev),
        Z, Y, X, _K(K), int(iters),
    )
    return out


# ---------------------------------------------------------------------------
# D: warp + fuse
# ---------------------------------------------------------------------------


def warp_fuse_plain(tsdf_g, weight_g, tsdf_n_psi, weight_n, psi, max_weight, K):
    wnp = warp_plain(weight_n[None], psi, K, (True,))[0]
    return fuse_volumes(tsdf_g, weight_g, tsdf_n_psi, wnp, max_weight)


def warp_fuse(
    tsdf_g, weight_g, tsdf_n_psi, weight_n, psi, max_weight: float, K: Optional[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: floor-warp weight_n at psi and fuse (tsdf_n_psi, warped
    weight) into (tsdf_g, weight_g); returns the new canonical pair."""
    if _on_cpu(tsdf_g):
        return warp_fuse_plain(tsdf_g, weight_g, tsdf_n_psi, weight_n, psi, max_weight, K)
    dims = tuple(tsdf_g.shape)
    Z, Y, X = dims
    dev = tsdf_g.device
    tg_out = torch.empty_like(tsdf_g)
    wg_out = torch.empty_like(weight_g)
    _launch(
        "warp_fuse", "sobfu_warp_fuse", dev,
        _check("tsdf_g", tsdf_g, dims, dev),
        _check("weight_g", weight_g, dims, dev),
        _check("tsdf_n_psi", tsdf_n_psi, dims, dev),
        _check("weight_n", weight_n, dims, dev),
        _check("psi", psi, (3,) + dims, dev),
        float(max_weight),
        _check("tsdf_out", tg_out, dims, dev),
        _check("weight_out", wg_out, dims, dev),
        Z, Y, X, _K(K),
    )
    return tg_out, wg_out


# ---------------------------------------------------------------------------
# A: gradient-descent iteration
# ---------------------------------------------------------------------------


def gd_iteration_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K):
    """solver.estimate_psi's XLA step: returns (psi', tnp', vel', max |upd|^2)
    with vel' None when momentum is None."""
    from sobfu_tpu_torch.solver import sobolev_smooth

    grad = fields.tsdf_gradient(tnp)
    lap = fields.neg_laplacian(psi)
    dU = (tnp - tg)[None] * grad + w_reg * lap
    dU_S = sobolev_smooth(dU, taps)
    if momentum is not None:
        vel_new = momentum * vel + dU_S
        update = alpha * vel_new
    else:
        vel_new = None
        update = alpha * dU_S
    psi_new = psi - update
    tnp_new = warp_plain(live[None], psi_new, K, (False,))[0]
    max_sq = torch.max(torch.sum(update * update, dim=0))
    return psi_new, tnp_new, vel_new, max_sq


def gd_iteration(
    psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
    momentum: Optional[float], K: Optional[int],
):
    """Kernel A: one gradient-descent iteration (two launches, counted once).

    psi f32[3,Z,Y,X]; tnp, tg, live f32[Z,Y,X]; vel f32[3,Z,Y,X] when
    momentum is set, else ignored; taps f32[s] (s odd, <= 11). Returns
    (psi', tnp', vel' or None, max squared update norm as a 0-dim tensor).
    """
    if _on_cpu(psi):
        return gd_iteration_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K)
    Z, Y, X = psi.shape[1:]
    dims = (Z, Y, X)
    dev = psi.device
    s = taps.shape[0]
    if s % 2 == 0 or s > 11:
        raise ValueError(f"taps must be odd and at most 11 long, got {s}")
    dU = torch.empty_like(psi)
    psi_out = torch.empty_like(psi)
    tnp_out = torch.empty_like(tnp)
    vel_out = torch.empty_like(psi) if momentum is not None else None
    max_sq = torch.empty((), dtype=torch.float32, device=dev)
    _launch(
        "gd_iteration", "sobfu_gd_iteration", dev,
        _check("psi", psi, (3,) + dims, dev),
        _check("tnp", tnp, dims, dev),
        None if momentum is None else _check("vel", vel, (3,) + dims, dev),
        _check("tg", tg, dims, dev),
        _check("live", live, dims, dev),
        _check("taps", taps, (s,), dev), s,
        float(alpha), float(w_reg), 0.0 if momentum is None else float(momentum),
        dU.data_ptr(), psi_out.data_ptr(), tnp_out.data_ptr(),
        None if vel_out is None else vel_out.data_ptr(),
        max_sq.data_ptr(), Z, Y, X, _K(K),
    )
    return psi_out, tnp_out, vel_out, max_sq
