"""Command-line app: reconstruct a scene from a directory of depth frames.

    python -m sobfu_tpu_torch <data dir> <params.ini> [--enable-log]
        [--verbose] [--vverbose] [--max-frames N] [--device cuda|cpu]

The PyTorch port of ``sobfu_tpu.cli`` (reference demo binary,
src/apps/demo.cpp:526-568). <data dir> holds depth/, color/ and optionally
omask/. --enable-log writes per-frame meshes to <dir>/meshes (.vtk) and
the deformation field to <dir>/fields (.vti). The visualisation,
checkpoint and colour-mesh flags of the JAX CLI are not ported yet and exit
with an error; --live-viz-port and --live-viz-host are accepted and inert
without --live-viz, and --no-native-loader names what the port always does.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from sobfu_tpu_torch import io as sio
from sobfu_tpu_torch.config import load_params
from sobfu_tpu_torch.fields import displacement
from sobfu_tpu_torch.pipeline import SobFusion
from sobfu_tpu_torch.utils.timers import SampledScopeTime

_NOT_PORTED_FLAGS = (
    "enable_viz", "enable_viz_detailed", "live_viz", "checkpoint", "resume", "color_mesh",
)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sobfu_tpu_torch",
        description="SobolevFusion on PyTorch/CUDA: non-rigid depth reconstruction",
    )
    ap.add_argument("data_dir", help="scene directory with depth/ and color/")
    ap.add_argument("params", help="scene .ini (reference params/*.ini format)")
    ap.add_argument("--enable-log", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--vverbose", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    # flags of the JAX CLI that the port does not implement yet
    ap.add_argument("--enable-viz", action="store_true", help="not ported yet")
    ap.add_argument("--enable-viz-detailed", action="store_true", help="not ported yet")
    ap.add_argument("--live-viz", action="store_true", help="not ported yet")
    ap.add_argument("--live-viz-port", type=int, default=8765,
                    help="port of the live viewer (inert: --live-viz is not ported yet)")
    ap.add_argument("--live-viz-host", default="127.0.0.1",
                    help="interface of the live viewer (inert: --live-viz is not ported yet)")
    ap.add_argument("--checkpoint", default=None, help="not ported yet")
    ap.add_argument("--resume", default=None, help="not ported yet")
    ap.add_argument("--color-mesh", action="store_true", help="not ported yet")
    ap.add_argument(
        "--no-native-loader", action="store_true",
        help="decode frames on the Python thread; the port has no native loader, so this is "
        "what it always does",
    )
    return ap


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    for flag in _NOT_PORTED_FLAGS:
        if getattr(args, flag):
            ap.error(
                f"--{flag.replace('_', '-')} is not ported to sobfu_tpu_torch yet "
                "(use python -m sobfu_tpu for it)"
            )

    verbosity = 2 if args.vverbose else (1 if args.verbose else 0)
    params = load_params(args.params, verbosity=verbosity)
    depths, _, masks = sio.list_frames(args.data_dir)
    if not depths:
        print("error: no depth frames found", file=sys.stderr)
        return 1

    mesh_dir = os.path.join(args.data_dir, "meshes")
    field_dir = os.path.join(args.data_dir, "fields")
    if args.enable_log:
        os.makedirs(mesh_dir, exist_ok=True)
        os.makedirs(field_dir, exist_ok=True)

    fusion = SobFusion(params, device=args.device)
    # phi_global o psi_inv has no per-frame consumer in this CLI
    fusion.need_inv_warps = False
    timer = SampledScopeTime()
    n_frames = len(depths) if args.max_frames is None else min(args.max_frames, len(depths))
    sync = torch.cuda.synchronize if fusion.device.type == "cuda" else (lambda: None)

    for i in range(n_frames):
        depth = sio.load_depth(depths[i])
        if masks:
            depth = sio.apply_mask(depth, sio.load_mask(masks[i]))
        with timer:
            fusion(depth)
            sync()
        if args.enable_log and fusion.frame_counter > 1:
            mesh = fusion.get_phi_global_mesh()
            sio.save_mesh_vtk(mesh, os.path.join(mesh_dir, f"mesh_{i:04d}.vtk"))
            disp = displacement(fusion.psi.data).cpu().numpy()
            sio.save_field_vti(disp, os.path.join(field_dir, f"psi_{i:04d}.vti"))

    print(
        f"processed {n_frames} frames, avg fps {timer.fps:.2f}, "
        f"steady-state fps {timer.steady_fps():.2f} "
        "(first frames carry the one-time kernel build)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
