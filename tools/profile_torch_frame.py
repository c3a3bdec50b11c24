"""Where the time goes in one non-rigid frame of the PyTorch port (CUDA card).

    python tools/profile_torch_frame.py --out DIR [--ini params/params_umbrella.ini]
        [--warp-window 2]

Frames 0-1 of a translating sphere (640x480, rendered in memory) warm up;
frame 2 runs under torch.profiler (CPU + CUDA activity). Prints the frame's
wall time, the device time per kernel name, the device busy share (kernel
time / wall time) and, from a separate loop of gradient-descent iterations,
the host cost per iteration with and without the per-iteration stop test
(a host read of the max norm). Writes the key_averages table, a chrome
trace and summary.json under --out. Needs a CUDA card; fails without one.
--warp-window -1 runs the exact sampler.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def _render():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene", os.path.join(ROOT, "tools", "make_synthetic_scene.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_prims_depth


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def iteration_costs(n: int = 400):
    """Host wall time per gd_iteration at 128^3 with and without the host
    read of the max norm, and the device time per iteration (CUDA events)."""
    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.ops import kernels
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device("cuda")
    dims, vs = (128, 128, 128), 1.0 / 128
    tg, _ = init_sphere(dims, (vs,) * 3, (0.5, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    live, _ = init_sphere(dims, (vs,) * 3, (0.49, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=dev)
    out = {}
    for sync in (True, False):
        psi, tnp = fields.identity_field(dims, device=dev), live.clone()
        for _ in range(20):
            psi, tnp, _, mx = kernels.gd_iteration(psi, tnp, None, tg, live, taps, 1e-3, 0.2,
                                                   None, 2)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(n):
            psi, tnp, _, mx = kernels.gd_iteration(psi, tnp, None, tg, live, taps, 1e-3, 0.2,
                                                   None, 2)
            if sync:
                float(mx)
        b.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
        out["with_stop_test" if sync else "enqueue_only"] = {
            "wall_ms_per_iter": wall, "event_ms_per_iter": a.elapsed_time(b) / n,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ini", default=os.path.join(ROOT, "params", "params_umbrella.ini"))
    ap.add_argument("--warp-window", type=int, default=2)
    ap.add_argument("--out", required=True, help="directory for the table and the trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_frame: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from sobfu_tpu_torch.config import load_params
    from sobfu_tpu_torch.pipeline import SobFusion

    os.makedirs(args.out, exist_ok=True)
    p = load_params(args.ini)
    p.warp_window = args.warp_window if args.warp_window >= 0 else None
    render = _render()
    frames = [
        render(p.rows, p.cols, *p.intr, [((0.006 * i, 0.0, 0.8), 0.2)]) for i in range(3)
    ]
    fusion = SobFusion(p, device="cuda")
    fusion.need_inv_warps = False
    for d in frames[:2]:
        fusion(d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fusion(frames[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels_us = {}
    for e in ka:
        us = _device_us(e)
        if us > 0 and getattr(e, "device_type", None) is not None and "CUDA" in str(
            e.device_type
        ):
            kernels_us[e.key] = (us, e.count)
    device_us = sum(us for us, _ in kernels_us.values())
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(args.out, "frame_trace.json"))
    iters = fusion.last_solve.iters
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1][0])[:12]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "frame_wall_s": wall,
        "iters": iters,
        "device_kernel_s": device_us * 1e-6,
        "device_busy_share": device_us * 1e-6 / wall if wall else None,
        "kernels": {k: {"device_ms": us / 1e3, "calls": n} for k, (us, n) in top},
        "iteration_loop": iteration_costs(),
    }
    print(json.dumps(summary, indent=1))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
