"""Depth-image preprocessing, pyramids, normal and point maps, rendering.

PyTorch counterpart of ``sobfu_tpu.ops.imgproc`` (reference
src/kfusion/cuda/imgproc.cu). Depth maps are millimetres held as int32
tensors [H, W] inside the port (torch's uint16 has few operations); uint16
appears only at I/O. Dists maps are float32 metres. Normal and point maps
are float32 [H, W, 3] with NaN marking invalid pixels.

Every function is plain torch and runs on any device; the rigid path
(:mod:`sobfu_tpu_torch.icp`, :mod:`sobfu_tpu_torch.kinfu`) runs them on the
card as the JAX package runs them in XLA.
"""

from __future__ import annotations

import numpy as np
import torch


def _shift2d(a: torch.Tensor, dy: int, dx: int, pad_value=0) -> torch.Tensor:
    """out[y, x] = a[y+dy, x+dx] over the first two axes of [H, W, ...],
    ``pad_value`` outside."""
    H, W = a.shape[:2]
    out = torch.full_like(a, pad_value)
    ys, ye = max(0, -dy), min(H, H - dy)
    xs, xe = max(0, -dx), min(W, W - dx)
    if ys < ye and xs < xe:
        out[ys:ye, xs:xe] = a[ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def bilateral_weights(sigma_spatial: float, sigma_depth: float) -> tuple:
    """(sig_space, sig_color) of the filter's exponent, Python floats: a tap
    weighs exp(-((dx^2 + dy^2) * sig_space + (d - nb)^2 * sig_color)) with
    sigma_depth in metres and depths in mm."""
    sig_depth_mm = sigma_depth * 1000.0
    return 0.5 / (sigma_spatial * sigma_spatial), 0.5 / (sig_depth_mm * sig_depth_mm)


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
    sig_space, sig_color = bilateral_weights(sigma_spatial, sigma_depth)
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
    # a window whose weights all underflow (a hole on the last row or column
    # among far neighbours) is 0 / 0: 0 mm, as the card converts NaN and as
    # the JAX package's uint16 cast gives it
    return torch.nan_to_num(torch.round(sum1 / sum2), nan=0.0).to(torch.int32)


def max_depth_mm(max_dist_m: float) -> int:
    """The truncation's limit in mm: float32 metres times 1000, truncated."""
    return int(np.float32(max_dist_m) * np.float32(1000.0))


def truncate_depth(depth: torch.Tensor, max_dist_m: float) -> torch.Tensor:
    """Zero out depths beyond max_dist metres (mm in, mm out)."""
    max_mm = max_depth_mm(max_dist_m)
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


def _intr(intr, dev):
    """(fx, fy, cx, cy) as float32 scalars on ``dev`` (JAX's f32[4])."""
    return tuple(torch.tensor(np.float32(v), device=dev) for v in intr)


def _norm3(a: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares over the last axis, keepdim
    (``jnp.linalg.norm(..., axis=-1, keepdims=True)``), accumulated as
    XLA's CPU backend contracts it: fma(a2, a2, fma(a1, a1, a0 * a0))."""
    a0, a1, a2 = a.unbind(-1)
    return torch.sqrt(torch.addcmul(torch.addcmul(a0 * a0, a1, a1), a2, a2))[..., None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis in ``jnp.cross``'s order, each
    component a1*b2 - a2*b1 as the single-rounding fma(a1, b2, -(a2*b1))
    XLA's CPU backend makes of it (``torch.addcmul``). The rounding matters
    where the two products cancel: a vector crossed with itself gives the
    products' rounding residue, not 0, in both packages."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([torch.addcmul(-(a2 * b1), a1, b2), torch.addcmul(-(a0 * b2), a2, b0),
                        torch.addcmul(-(a1 * b0), a0, b1)], dim=-1)


# ---------------------------------------------------------------------------
# depth pyramid (imgproc.cu:84-122)
# ---------------------------------------------------------------------------


def depth_pyramid_down(depth: torch.Tensor, sigma_depth: float) -> torch.Tensor:
    """Half-resolution downsample averaging a 5x5 window around (2y, 2x),
    keeping only values within 3*sigma (mm) of the centre -> int32 mm."""
    H, W = depth.shape
    Ho, Wo = H // 2, W // 2
    dev = depth.device
    d = depth.to(torch.float32)
    center = d[: 2 * Ho : 2, : 2 * Wo : 2]
    thresh = float(np.float32(sigma_depth) * np.float32(1000.0) * np.float32(3.0))
    yy = torch.arange(Ho, device=dev)[:, None] * 2
    xx = torch.arange(Wo, device=dev)[None, :] * 2
    D = 5
    rr = D // 2
    total = torch.zeros_like(center)
    count = torch.zeros_like(center)
    for dy in range(-rr, D - rr):
        for dx in range(-rr, D - rr):
            nb = _shift2d(d, dy, dx)[: 2 * Ho : 2, : 2 * Wo : 2]
            valid = (
                (yy + dy >= 0) & (yy + dy <= H - 2) & (xx + dx >= 0) & (xx + dx <= W - 2)
                & (torch.abs(nb - center) < thresh)
            )
            total = total + torch.where(valid, nb, 0.0)
            count = count + valid.to(torch.float32)
    out = torch.where(count == 0, 0.0, total / torch.clamp(count, min=1.0))
    return torch.floor(out).to(torch.int32)


# ---------------------------------------------------------------------------
# normals / point maps (imgproc.cu:129-226)
# ---------------------------------------------------------------------------


def _reproject(depth: torch.Tensor, intr, scale: float = 1.0) -> torch.Tensor:
    """Back-project a depth map in units of 1/scale metres -> camera-space
    points [H, W, 3]: (depth * ((u - cx) * scale) / fx, ..., depth * scale).

    scale 1 is the JAX package's ``_reproject`` of a metric map. For a mm
    map (scale 0.001) this is the order XLA gives the JAX package's jitted
    ``_reproject(depth * 0.001, intr)`` (the constant moves onto the pixel
    offset), which makes the point maps bit for bit equal to JAX's."""
    H, W = depth.shape
    dev = depth.device
    d = depth.to(torch.float32)
    fx, fy, cx, cy = _intr(intr, dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    return torch.stack([d * ((u - cx) * scale) / fx, d * ((v - cy) * scale) / fy, d * scale],
                       dim=-1)


def compute_normals(depth: torch.Tensor, intr) -> torch.Tensor:
    """Per-pixel normals from right/down neighbour cross products, NaN invalid.

    compute_normals_kernel (imgproc.cu:129-157): n = -normalize((v01-v00) x
    (v10-v00)); invalid when any of the three depths is 0 or the pixel is on
    the last row/column.
    """
    H, W = depth.shape
    dev = depth.device
    pts = _reproject(depth, intr, 0.001)
    d = pts[..., 2]
    v00 = pts
    v01 = _shift2d(pts, 0, 1)
    v10 = _shift2d(pts, 1, 0)
    n = _cross(v01 - v00, v10 - v00)
    n = -n / torch.clamp(_norm3(n), min=1e-12)
    z01 = _shift2d(d, 0, 1)
    z10 = _shift2d(d, 1, 0)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    valid = (d * z01 * z10 != 0) & (yy < H - 1) & (xx < W - 1)
    return torch.where(valid[..., None], n, float("nan"))


def mask_depth(depth: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Zero depth where the normal is NaN (imgproc.cu:159-168)."""
    return torch.where(torch.isnan(normals[..., 0]), torch.zeros_like(depth), depth)


def compute_points_normals(depth: torch.Tensor, intr):
    """Camera-space point + normal maps, NaN where invalid (imgproc.cu:187-226)."""
    normals = compute_normals(depth, intr)
    pts = _reproject(depth, intr, 0.001)
    valid = ~torch.isnan(normals[..., 0])
    return torch.where(valid[..., None], pts, float("nan")), normals


# ---------------------------------------------------------------------------
# half-resolution resizes (imgproc.cu:258-359)
# ---------------------------------------------------------------------------


def _quads(a: torch.Tensor):
    """The four 2x2-block corners of [H, W, ...] at half resolution."""
    Ho, Wo = a.shape[0] // 2, a.shape[1] // 2
    return (a[0 : 2 * Ho : 2, 0 : 2 * Wo : 2], a[0 : 2 * Ho : 2, 1 : 2 * Wo : 2],
            a[1 : 2 * Ho : 2, 0 : 2 * Wo : 2], a[1 : 2 * Ho : 2, 1 : 2 * Wo : 2])


def resize_depth_normals(depth: torch.Tensor, normals: torch.Tensor):
    """2x2 average of depth (int32 mm) + normals; invalid if any depth is 0."""
    d00, d01, d10, d11 = _quads(depth.to(torch.float32))
    ok = (d00 * d01 != 0) & (d10 * d11 != 0)
    d_out = torch.where(ok, torch.floor((d00 + d01 + d10 + d11) / 4.0), 0.0)
    n00, n01, n10, n11 = _quads(normals)
    n_out = torch.where(ok[..., None], (n00 + n01 + n10 + n11) * 0.25, float("nan"))
    return d_out.to(torch.int32), n_out


def resize_points_normals(points: torch.Tensor, normals: torch.Tensor):
    """2x2 average of point + normal maps; NaN propagates, so a block with a
    NaN sample is NaN."""

    def avg(a):
        a00, a01, a10, a11 = _quads(a)
        return (a00 + a01 + a10 + a11) * 0.25

    return avg(points), avg(normals)


# ---------------------------------------------------------------------------
# surface rasteriser (imgproc.cu:364-448)
# ---------------------------------------------------------------------------


def _barycentric_lattice(m: int, dev) -> torch.Tensor:
    bary = [(i / m, j / m, (m - i - j) / m) for i in range(m + 1) for j in range(m + 1 - i)]
    return torch.tensor(np.asarray(bary, np.float32), device=dev)


def rasterise_surface(vertices: torch.Tensor, vol2cam, intr, height: int, width: int,
                      samples_per_edge: int = 4):
    """Render a triangle soup to camera-space point + normal maps.

    ``sobfu_tpu.ops.imgproc.rasterise_surface``: each triangle (volume
    coordinates) is sampled at a barycentric lattice and splatted with a
    scatter-min z-buffer (``scatter_reduce_(..., "amin")``) whose last slot
    takes the rejected samples; normals are finite differences of the
    point map. vertices: f32[N, 3] (N divisible by 3), NaN rows ignored.
    Returns (points [H,W,3], normals [H,W,3]) with 0 marking empty pixels.

    The pixel is the projection truncated toward zero, as JAX's int32 cast;
    it is tested in float and cast only where it is inside the image, so no
    result depends on how a device casts NaN or an out-of-range value. Where
    several samples win a pixel's z-test, the last one in sample order is
    kept (a sequential scatter's rule, made deterministic by an amax of the
    sample index).
    """
    dev = vertices.device
    m = torch.as_tensor(np.asarray(vol2cam, np.float32), device=dev)
    tri = vertices.reshape(-1, 3, 3)
    cam = torch.einsum("ntj,ij->nti", tri, m[:3, :3]) + m[:3, 3]
    bary = _barycentric_lattice(samples_per_edge, dev)
    pts = torch.einsum("bk,nkc->nbc", bary, cam).reshape(-1, 3)
    fx, fy, cx, cy = _intr(intr, dev)
    z = pts[:, 2]
    u = torch.trunc(fx * pts[:, 0] / z + cx)
    v = torch.trunc(fy * pts[:, 1] / z + cy)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0) & ~torch.isnan(z)
    dump = height * width
    ui = torch.where(ok, u, 0.0).to(torch.int64)
    vi = torch.where(ok, v, 0.0).to(torch.int64)
    flat = torch.where(ok, vi * width + ui, dump)
    zbuf = torch.full((dump + 1,), float("inf"), dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, flat, torch.where(ok, z, float("inf")), "amin")
    win = ok & (z <= zbuf[flat] + 1e-7)
    order = torch.arange(z.shape[0], device=dev)
    last = torch.full((dump + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, torch.where(win, flat, dump), torch.where(win, order, -1), "amax")
    last = last[:-1]
    points = torch.where((last >= 0)[:, None], pts[last.clamp(min=0)], 0.0)
    points = points.reshape(height, width, 3)
    v0 = points
    v1 = _shift2d(points, 1, 0)
    v2 = _shift2d(points, 0, 1)
    n = _cross(v1 - v0, v2 - v0)
    norm = _norm3(n)
    have = (torch.abs(points[..., 2]) > 0) & (norm[..., 0] > 1e-12)
    normals = torch.where(have[..., None], n / torch.clamp(norm, min=1e-12), 0.0)
    return points, normals


# ---------------------------------------------------------------------------
# rendering (imgproc.hpp:30,42-46)
# ---------------------------------------------------------------------------


def render_tangent_colors(normals: torch.Tensor) -> torch.Tensor:
    """Normal map -> RGB tangent colours (n * 0.5 + 0.5), uint8 [H, W, 3];
    invalid (NaN) pixels black."""
    valid = ~torch.isnan(normals[..., 0])
    rgb = torch.clamp((normals * 0.5 + 0.5) * 255.0, 0, 255)
    return torch.where(valid[..., None], rgb, 0.0).to(torch.uint8)


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(_norm3(a), min=1e-12)


def render_image(points: torch.Tensor, normals: torch.Tensor, light_pose) -> torch.Tensor:
    """Ambient + diffuse |N.L| + Blinn specular |N.H|^16, grayscale ->
    uint8 [H, W, 3] (the KinectFusion display shader)."""
    valid = ~torch.isnan(points[..., 0]) & ~torch.isnan(normals[..., 0])
    light = torch.as_tensor(np.asarray(light_pose, np.float32), device=points.device)
    L = _unit(light - points)
    ndotl = torch.abs(torch.sum(normals * L, dim=-1))
    Hv = _unit(L + _unit(-points))
    s = torch.abs(torch.sum(normals * Hv, dim=-1))
    for _ in range(4):  # s ** 16 by squaring, as XLA's integer_pow
        s = s * s
    intensity = torch.clamp(0.1 + 0.75 * ndotl + 0.3 * s, 0.0, 1.0)
    gray = torch.where(valid, intensity * 255.0, 0.0).to(torch.uint8)
    return gray[..., None].repeat(1, 1, 3)
