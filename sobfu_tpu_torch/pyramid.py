"""Coarse-to-fine helpers of the pyramid solve.

PyTorch counterpart of ``sobfu_tpu.solver`` ``_pool2_matrix``,
``_linear_resize_matrix``, ``_downsample2``, ``_resample_disp`` and
``estimate_inverse_multigrid`` (solver.py:786-923). The per-axis resamples
are three ``torch.einsum`` contractions with small numpy-built matrices, as
the JAX package runs them outside any kernel; on the card they run in full
float32 (``torch.backends.cuda.matmul.allow_tf32`` stays False, PyTorch's
default). The coarse fixed point of the multigrid inverse is kernel C.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from sobfu_tpu_torch import fields
from sobfu_tpu_torch.ops import kernels


@functools.lru_cache(maxsize=64)
def pool2_matrix(n: int) -> np.ndarray:
    """(n//2, n) matrix averaging adjacent pairs (2x mean-pool, one axis)."""
    m = np.zeros((n // 2, n), np.float32)
    idx = np.arange(n // 2)
    m[idx, 2 * idx] = 0.5
    m[idx, 2 * idx + 1] = 0.5
    return m


@functools.lru_cache(maxsize=64)
def linear_resize_matrix(n: int, m: int) -> np.ndarray:
    """(m, n) matrix of ``jax.image.resize(..., "trilinear")`` along one axis
    of extent n -> m, rebuilt in float32 numpy.

    resize is scale-and-translate with the triangle kernel, half-pixel
    centres and ``antialias=True``: input sample i sits at i, output j
    samples the input at f_j = (j + 0.5) / s - 0.5 (s = m / n), with weight
    max(0, 1 - |f_j - i| / k) where k = max(1 / s, 1) widens the kernel when
    downsampling (2x down: 4 taps of 1/8, 3/8, 3/8, 1/8, not 2). Each output
    row is normalised to sum 1 and zeroed where f_j lies outside
    [-0.5, n - 0.5].
    """
    f32 = np.float32
    scale = f32(m) / f32(n)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(m, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)  # (n, m)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n) - f32(0.5))
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T, dtype=f32)


def _mat(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def downsample2(vol: torch.Tensor) -> torch.Tensor:
    """2x average-pool a volume f32[Z,Y,X] (dims must be even), as three
    per-axis pooling contractions (``solver._downsample2``)."""
    Z, Y, X = vol.shape
    out = torch.einsum("ij,jyx->iyx", _mat(pool2_matrix(Z), vol), vol)
    out = torch.einsum("ij,zjx->zix", _mat(pool2_matrix(Y), vol), out)
    return torch.einsum("ij,zyj->zyi", _mat(pool2_matrix(X), vol), out)


def resample_disp(disp: torch.Tensor, dims_zyx, scale: float) -> torch.Tensor:
    """Trilinearly resample a displacement field f32[3,Z,Y,X] to new dims and
    scale its values by ``scale`` (``solver._resample_disp``)."""
    _, Z, Y, X = disp.shape
    Zo, Yo, Xo = (int(d) for d in dims_zyx)
    out = torch.einsum("ij,cjyx->ciyx", _mat(linear_resize_matrix(Z, Zo), disp), disp)
    out = torch.einsum("ij,czjx->czix", _mat(linear_resize_matrix(Y, Yo), disp), out)
    out = torch.einsum("ij,czyj->czyi", _mat(linear_resize_matrix(X, Xo), disp), out)
    return out * float(np.float32(scale))


def upsample_inverse(q_c: torch.Tensor, dims_zyx) -> torch.Tensor:
    """A half-resolution inverse q_c (half-res identity convention) as a
    full-resolution field: identity + the doubled, upsampled displacement."""
    ident_c = fields.identity_field(q_c.shape[1:], device=q_c.device)
    ident = fields.identity_field(dims_zyx, device=q_c.device)
    return ident + resample_disp(q_c - ident_c, dims_zyx, 2.0)


def estimate_inverse_multigrid(
    psi: torch.Tensor,
    iters: int = 3,
    K: int = 2,
    init: Optional[torch.Tensor] = None,
    fine_iters: int = 1,
    return_coarse: bool = False,
) -> torch.Tensor:
    """Coarse-to-fine warm inverse (``solver.estimate_inverse_multigrid``):
    the fixed point q <- id - disp(q) runs ``iters`` steps at HALF resolution
    (displacement halved, window K_c = ceil(K/2)) through kernel C, the
    coarse inverse's displacement is upsampled and doubled, then
    ``fine_iters`` full-resolution anchoring steps follow (kernel C again).

    init: a full-resolution warm start (downsampled here) or a half-
    resolution one (the coarse carry of the no-log loop, taken as is).
    return_coarse: return the half-resolution inverse itself; only with
    fine_iters=0 (a warm-start-only product).
    """
    dims = tuple(psi.shape[1:])
    if iters == 0 and fine_iters == 0 and init is not None:
        return init  # 0 iterations: the warm start passes through
    if any(d % 2 for d in dims):
        raise ValueError(f"the multigrid inverse needs even dims, got {dims}")
    dev = psi.device
    ident = fields.identity_field(dims, device=dev)
    dims_c = tuple(d // 2 for d in dims)
    ident_c = fields.identity_field(dims_c, device=dev)
    K_c = max(1, -(-int(K) // 2))
    disp_c = resample_disp(psi - ident, dims_c, 0.5)
    init_c = None
    if init is not None:
        if tuple(init.shape[1:]) == dims_c:
            init_c = init
        else:
            init_c = ident_c + resample_disp(init - ident, dims_c, 0.5)
    q_c = kernels.inverse_fixed_point((ident_c + disp_c).contiguous(), iters, K_c, init_c)
    if return_coarse:
        if fine_iters != 0:
            raise ValueError("return_coarse is a warm-start-only product: fine_iters must be 0")
        return q_c
    q0 = upsample_inverse(q_c, dims)
    if fine_iters == 0:
        return q0
    return kernels.inverse_fixed_point(psi, fine_iters, K, q0.contiguous())
