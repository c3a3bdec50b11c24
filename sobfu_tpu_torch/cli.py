"""Command-line app: reconstruct a scene from a directory of depth frames.

    python -m sobfu_tpu_torch <data dir> <params.ini> [--enable-viz]
        [--enable-viz-detailed] [--enable-log] [--verbose] [--vverbose]
        [--max-frames N] [--color-mesh] [--live-viz] [--live-viz-port N]
        [--live-viz-host H] [--checkpoint PATH] [--resume PATH]
        [--no-native-loader] [--device cuda|cpu]

The PyTorch port of ``sobfu_tpu.cli`` (reference demo binary,
src/apps/demo.cpp:526-568): every flag of the JAX CLI, with the same
meaning and the same files, plus --device (default cuda; cuda without a
card raises). <data dir> holds depth/, color/ and optionally omask/ (masks
applied to depth, demo.cpp:314-330).
  --enable-log writes per-frame meshes to <dir>/meshes (.vtk) and the
  deformation field to <dir>/fields (.vti); with --color-mesh the meshes
  carry per-vertex RGB sampled from the colour stream.
  --enable-viz* writes offscreen screenshots to <dir>/screenshots
  (matplotlib); --live-viz serves the live viewer over HTTP.
  --checkpoint writes the state after every frame; --resume restores it
  and continues at the stored frame.
  Depth decodes on the native prefetch loader (sobfu_tpu_torch.native)
  unless --no-native-loader is given or the library cannot be built; then
  it decodes on the Python thread.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from sobfu_tpu_torch import io as sio
from sobfu_tpu_torch import native, viz
from sobfu_tpu_torch.config import load_params
from sobfu_tpu_torch.fields import displacement
from sobfu_tpu_torch.pipeline import SobFusion
from sobfu_tpu_torch.utils import checkpoint as ckpt
from sobfu_tpu_torch.utils.timers import SampledScopeTime
from sobfu_tpu_torch.viewer import LiveViewer


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sobfu_tpu_torch",
        description="SobolevFusion on PyTorch/CUDA: non-rigid depth reconstruction",
    )
    ap.add_argument("data_dir", help="scene directory with depth/ and color/")
    ap.add_argument("params", help="scene .ini (reference params/*.ini format)")
    ap.add_argument("--enable-viz", action="store_true")
    ap.add_argument("--enable-viz-detailed", action="store_true")
    ap.add_argument("--enable-log", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--vverbose", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--color-mesh", action="store_true",
        help="sample per-vertex RGB from the color stream onto logged meshes and screenshots",
    )
    ap.add_argument(
        "--live-viz", action="store_true",
        help="serve a live interactive viewer over HTTP (headless-host equivalent of the "
        "reference's PCL window)",
    )
    ap.add_argument("--live-viz-port", type=int, default=8765)
    ap.add_argument(
        "--live-viz-host", default="127.0.0.1",
        help="interface the live viewer binds to (default loopback only; pass 0.0.0.0 "
        "explicitly to expose it to the network)",
    )
    ap.add_argument("--checkpoint", default=None, help="write state here after each frame")
    ap.add_argument("--resume", default=None, help="restore state before starting")
    ap.add_argument(
        "--no-native-loader", action="store_true",
        help="disable the C++ prefetch frame loader (decode then runs synchronously on the "
        "Python thread, like the reference app)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    verbosity = 2 if args.vverbose else (1 if args.verbose else 0)
    params = load_params(args.params, verbosity=verbosity)
    depths, colors, masks = sio.list_frames(args.data_dir)
    if not depths:
        print("error: no depth frames found", file=sys.stderr)
        return 1

    mesh_dir = os.path.join(args.data_dir, "meshes")
    field_dir = os.path.join(args.data_dir, "fields")
    shot_dir = os.path.join(args.data_dir, "screenshots")
    viz_on = args.enable_viz or args.enable_viz_detailed
    if args.enable_log:
        os.makedirs(mesh_dir, exist_ok=True)
        os.makedirs(field_dir, exist_ok=True)
    if viz_on:
        os.makedirs(shot_dir, exist_ok=True)

    fusion = SobFusion(params, device=args.device)
    start = 0
    if args.resume and os.path.exists(args.resume):
        ckpt.load_checkpoint(args.resume, fusion)
        start = fusion.frame_counter
        print(f"resumed at frame {start}")

    timer = SampledScopeTime()
    n_frames = len(depths) if args.max_frames is None else min(args.max_frames, len(depths))
    sync = torch.cuda.synchronize if fusion.device.type == "cuda" else (lambda: None)

    live = None
    if args.live_viz:
        live = LiveViewer(port=args.live_viz_port, host=args.live_viz_host).start()
        print(f"live viewer: http://localhost:{live.port}/")

    want_color = viz_on or args.color_mesh or args.live_viz
    # phi_global o psi_inv is only consumed by the per-frame viz surfaces;
    # without them the frame step skips those warps and the psi_inv mesh
    # getter recomputes on demand
    fusion.need_inv_warps = bool(viz_on or args.live_viz)

    def frame_stream():
        """(index, masked uint16 depth) frames: the native prefetch ring
        (worker threads decode and mask ahead while the card solves), or
        synchronous decode on the Python thread when it is switched off or
        its library cannot be built."""
        if not args.no_native_loader:
            try:
                loader = native.FrameLoader(
                    depths[start:n_frames], masks[start:n_frames] if masks else None
                )
            except OSError as e:
                print(f"frame decode: Python ({e})")
            else:
                print("frame decode: native prefetch loader")
                for off, d in enumerate(loader):
                    yield start + off, d
                return
        else:
            print("frame decode: Python (--no-native-loader)")
        for j in range(start, n_frames):
            d = sio.load_depth(depths[j])
            if masks:
                d = sio.apply_mask(d, sio.load_mask(masks[j]))
            yield j, d

    try:
        for i, depth in frame_stream():
            # the colour stream, consumed like the reference viewer's (demo.cpp:311-330)
            color = sio.load_color(colors[i]) if (want_color and i < len(colors)) else None

            with timer:
                fusion(depth)
                sync()

            if args.enable_log and fusion.frame_counter > 1:
                mesh = fusion.get_phi_global_mesh()
                if args.color_mesh and color is not None:
                    mesh.colors = viz.sample_vertex_colors(
                        mesh, color, fusion.poses[-1], params.intr
                    )
                sio.save_mesh_vtk(mesh, os.path.join(mesh_dir, f"mesh_{i:04d}.vtk"))
                disp = displacement(fusion.psi.data).cpu().numpy()
                sio.save_field_vti(disp, os.path.join(field_dir, f"psi_{i:04d}.vti"))

            if viz_on and fusion.frame_counter > 1:
                viz.save_screenshot(
                    fusion, os.path.join(shot_dir, f"frame_{i:04d}.png"),
                    detailed=args.enable_viz_detailed, color=color,
                )

            if live is not None and fusion.frame_counter > 1:
                live.update(fusion, color=color, fps=timer.fps,
                            detailed=args.enable_viz_detailed, frame=i)

            if args.checkpoint:
                ckpt.save_checkpoint(args.checkpoint, fusion)

        print(
            f"processed {n_frames - start} frames, avg fps {timer.fps:.2f}, "
            f"steady-state fps {timer.steady_fps():.2f} "
            "(first frames carry the one-time kernel build)"
        )
    finally:
        if live is not None:
            live.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
