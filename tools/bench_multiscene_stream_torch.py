"""Sustained multi-scene streaming benchmark of the PyTorch port: the
counterpart of tools/bench_multiscene_stream.py (which runs the JAX
package), with its arguments, scene, mesh rule and JSON keys.

    python tools/bench_multiscene_stream_torch.py [dim] [frames] [--device cuda|cpu]

A batch of scenes is reconstructed concurrently, fed frame by frame: every
scene gets its own moving-sphere depth sequence, and psi, phi_global and
psi_inv are carried across frames as the production loop carries them. On
one card (or --device cpu) the step is ``parallel.make_frame_step`` on that
device: kernel A over the scenes, then B, C and D per scene. With eight or
more cards the JAX tool's mesh rule gives a (2 scene x 4 z) mesh, with two
to seven a (1 x n_z) one (n_z <= 4), and the step is z-sharded over it
(``parallel.zshard``; kernel A's slab form). Prints one JSON line:
sustained scene-frames/s (the frames queued back to back, one trailing
synchronise; the solve loops still read the host once per chunk), the
iterations (``iters_total`` over every frame and scene; the JAX tool's
holds the last batch's sum), and the tool's tracking check (every scene's band-mean
displacement follows its own drift). Exits 1 when a scene does not track.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DIRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0))


def render_dists(H, W, fx, fy, cx, cy, centre, radius):
    """Metric ray-length map of a sphere (what compute_dists produces)."""
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    dx = np.broadcast_to((u - cx) / fx, (H, W))
    dy = np.broadcast_to((v - cy) / fy, (H, W))
    d = np.stack([dx, dy, np.ones((H, W))], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.asarray(centre, np.float64)
    b = d @ c
    disc = b * b - (c @ c - radius * radius)
    t = b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    return np.where(hit, t, 0.0).astype(np.float32)


def mesh_shape(n_devices: int):
    """(n_scene, n_z) by device count, the JAX tool's rule."""
    n_scene = 2 if n_devices >= 8 else 1
    return n_scene, min(4, n_devices // n_scene)


def tracking_ok(psi, tg, ident, S: int) -> bool:
    """The JAX tool's check: on each scene's band |tsdf| < 0.5 (at least 50
    voxels) the mean displacement points along the scene's own direction
    (> 0.2 voxel) with its orthogonal part under 0.5 x that + 0.2."""
    ok = True
    for s in range(S):
        disp = psi[s] - ident
        band = np.abs(tg[s]) < 0.5
        if band.sum() < 50:
            ok = False
            continue
        m = np.asarray([disp[c][band].mean() for c in range(3)])
        d = np.asarray(DIRS[s], np.float64)
        proj = float(m @ d)
        orth = float(np.linalg.norm(m - proj * d))
        if not (proj > 0.2 and orth < 0.5 * abs(proj) + 0.2):
            ok = False
    return ok


def run(dim: int = 64, n_frames: int = 6, device="cuda", devices=None) -> dict:
    """The stream at dim^3 for n_frames frames; returns the JSON's dict.
    devices: those the mesh rule counts (default: every card with
    device cuda, else the one device); the states live on ``device``."""
    from sobfu_tpu_torch import core, fields, solver
    from sobfu_tpu_torch.parallel import make_frame_step, make_mesh
    from sobfu_tpu_torch.tsdf import integrate_dists

    dev = core.resolve_device(device)
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    n_scene, n_z = mesh_shape(len(devices))
    S = n_scene * 2
    dims = (dim, dim, dim)
    size = 0.25
    vs = size / dim
    trunc, eta = 8 * vs, 3 * vs
    H, W = 48, 64
    fx = fy = 40.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    intr = (fx, fy, cx, cy)

    taps = solver.sobolev_filter_1d(7, 0.1)
    opts = dict(inverse_iters=3, warp_window=2, fused=True, taps_static=tuple(taps),
                momentum=0.95, warm_inverse=True, pyramid_levels=2, stall_window=8,
                stall_rel=1e-2, fold_xmats=True)
    if n_scene * n_z > 1:
        mesh = make_mesh(n_z=n_z, n_scene=n_scene, devices=devices[:n_scene * n_z])
        step = make_frame_step(dims, mesh=mesh, **opts)
    else:
        step = make_frame_step(dims, device=dev, **opts)

    vol2cam = np.eye(4, dtype=np.float32)
    vol2cam[:3, 3] = (-size / 2, -size / 2, 0.15)
    v2c_b = np.broadcast_to(vol2cam[None], (S, 4, 4))
    z_cam = size / 2 + 0.15
    r_sph = 0.05

    # every scene starts from the same canonical sphere, integrated from
    # the frame-0 depth, then drifts along its own direction
    d0 = torch.as_tensor(render_dists(H, W, fx, fy, cx, cy, (0.0, 0.0, z_cam), r_sph),
                         device=dev)
    zeros = torch.zeros(dims, dtype=torch.float32, device=dev)
    tg1, wg1 = integrate_dists(zeros, zeros, d0, vol2cam, intr, (vs,) * 3, trunc, eta)
    psi1 = fields.identity_field(dims, device=dev)
    psi_b = psi1.expand(S, -1, -1, -1, -1).contiguous()
    state = (psi_b, tg1.expand(S, -1, -1, -1).contiguous(),
             wg1.expand(S, -1, -1, -1).contiguous(), psi_b)

    # a drift whose accumulated displacement stays inside the K=2 window
    step_m = min(0.9, 1.8 / n_frames) * vs
    scalars = (intr, (vs,) * 3, trunc, eta, 64.0, taps, 0.1, 0.2, 96, 1e-3)
    frames = [torch.as_tensor(np.stack([
        render_dists(H, W, fx, fy, cx, cy, (d[0] * step_m * i, d[1] * step_m * i, z_cam), r_sph)
        for d in DIRS[:S]]), device=dev) for i in range(n_frames + 1)]

    # warm-up with frame 0 (builds the kernels); its output is dropped
    out = step(state[0], state[1], state[2], frames[0], v2c_b, *scalars, state[3])
    if dev.type == "cuda":
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    iters_total = 0
    for i in range(1, n_frames + 1):
        out = step(state[0], state[1], state[2], frames[i], v2c_b, *scalars, state[3])
        state = (out[0], out[2], out[3], out[1])
        iters_total += int(out[4].sum())  # iterations come back on the host
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    iters = np.asarray(out[4])

    ok = tracking_ok(state[0].cpu().numpy(), state[1].cpu().numpy(), psi1.cpu().numpy(), S)
    return {
        "mesh": f"{n_scene}x{n_z}",
        "scenes": S,
        "frames": n_frames,
        "dim": dim,
        "scene_frames_per_s": round(S * n_frames / dt, 3),
        "ms_per_frame_batch": round(dt / n_frames * 1e3, 1),
        "iters_last_batch": iters.tolist(),
        "iters_total": iters_total,
        "tracking_ok": ok,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dim", nargs="?", type=int, default=64)
    ap.add_argument("frames", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(args.dim, args.frames, args.device)
    print(json.dumps(out), flush=True)
    return 0 if out["tracking_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
