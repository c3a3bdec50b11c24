"""Offscreen visualisation: mesh screenshots without a display.

PyTorch-port counterpart of ``sobfu_tpu.viz``. The reference used an
interactive PCL visualizer with 2 or 4 viewports and PNG screenshots
(demo.cpp:374-506) and refused to run over SSH. Screenshots are rendered
offscreen with matplotlib's 3-D triangle rasteriser: 2 panels (global,
live-warped) or 4 panels (--enable-viz-detailed: + live, global-warped),
the reference's panel inventory. Everything here is numpy on the host,
duck-typed on a pipeline's four mesh getters and on ``Mesh.colors``.
"""

from __future__ import annotations

import numpy as np


def _plot_mesh(ax, mesh, title: str) -> None:
    v = mesh.vertices
    ax.set_title(title, fontsize=8)
    if v.shape[0] == 0:
        ax.text(0.5, 0.5, 0.5, "empty", fontsize=8)
        return
    # subsample triangles for speed
    tris = v.reshape(-1, 3, 3)
    colors = None
    if getattr(mesh, "colors", None) is not None:
        colors = np.asarray(mesh.colors, np.float32).reshape(-1, 3, 3) / 255.0
    if tris.shape[0] > 20000:
        idx = np.linspace(0, tris.shape[0] - 1, 20000).astype(int)
        tris = tris[idx]
        if colors is not None:
            colors = colors[idx]
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    pc = Poly3DCollection(tris, linewidths=0.0)
    if colors is not None:
        pc.set_facecolor(colors.mean(axis=1))  # per-triangle mean RGB
    else:
        pc.set_facecolor((0.6, 0.7, 0.9, 1.0))
    ax.add_collection3d(pc)
    lo, hi = tris.min(axis=(0, 1)), tris.max(axis=(0, 1))
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_axis_off()


def sample_vertex_colors(
    mesh, color_img: np.ndarray, camera_pose: np.ndarray, intr,
    flip_yz: bool = True,
) -> np.ndarray:
    """Per-vertex RGB by projecting mesh vertices into the color camera.

    The reference loads and displays the color stream (demo.cpp:311-330)
    but never lifts it onto the mesh; this is the natural extension. Mesh
    vertices are in the reference store convention (world coords with
    (x, -y, -z) flip, marching_cubes.cu:273-276): un-flip, transform into
    the camera frame, pinhole-project and bilinear-sample the image.
    Vertices behind the camera or out of frame get mid-grey.

    Returns u8[n, 3].
    """
    v = np.asarray(mesh.vertices, np.float32)
    if v.shape[0] == 0:
        return np.zeros((0, 3), np.uint8)
    if flip_yz:
        v = v * np.asarray([1.0, -1.0, -1.0], np.float32)
    world2cam = np.linalg.inv(np.asarray(camera_pose, np.float32))
    cam = v @ world2cam[:3, :3].T + world2cam[:3, 3]
    z = cam[:, 2]
    valid = z > 1e-6
    zs = np.where(valid, z, 1.0)
    u = intr.fx * cam[:, 0] / zs + intr.cx
    w = intr.fy * cam[:, 1] / zs + intr.cy
    H, W = color_img.shape[:2]
    valid &= (u >= 0) & (u <= W - 1) & (w >= 0) & (w <= H - 1)
    u = np.clip(u, 0, W - 1.0001)
    w = np.clip(w, 0, H - 1.0001)
    u0, w0 = u.astype(np.int32), w.astype(np.int32)
    fu, fw = u - u0, w - w0
    img = np.asarray(color_img, np.float32)
    c = (
        img[w0, u0] * ((1 - fu) * (1 - fw))[:, None]
        + img[w0, u0 + 1] * (fu * (1 - fw))[:, None]
        + img[w0 + 1, u0] * ((1 - fu) * fw)[:, None]
        + img[w0 + 1, u0 + 1] * (fu * fw)[:, None]
    )
    c = np.where(valid[:, None], c, 128.0)
    return np.clip(c, 0, 255).astype(np.uint8)


def save_screenshot(
    fusion, path: str, detailed: bool = False, color: np.ndarray = None
) -> None:
    """Render the pipeline's current meshes (and the live color frame, when
    given — matching the reference viewer's color display, demo.cpp:311-330)
    into a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = [
        ("phi_global", fusion.get_phi_global_mesh),
        ("phi_n(psi)", fusion.get_phi_n_psi_mesh),
    ]
    if detailed:
        panels += [
            ("phi_n", fusion.get_phi_n_mesh),
            ("phi_global(psi_inv)", fusion.get_phi_global_psi_inv_mesh),
        ]
    n_panels = len(panels) + (1 if color is not None else 0)

    ncols = 2
    nrows = (n_panels + 1) // 2
    fig = plt.figure(figsize=(4 * ncols, 4 * nrows), dpi=80)
    for i, (title, getter) in enumerate(panels):
        ax = fig.add_subplot(nrows, ncols, i + 1, projection="3d")
        _plot_mesh(ax, getter(), title)
    if color is not None:
        ax = fig.add_subplot(nrows, ncols, len(panels) + 1)
        ax.imshow(np.asarray(color))
        ax.set_title("color", fontsize=8)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
