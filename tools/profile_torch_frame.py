"""Where the time goes in one non-rigid frame of the PyTorch port (CUDA card).

    python tools/profile_torch_frame.py --out DIR [--ini params/params_umbrella.ini]
        [--warp-window 2] [--pyramid LEVELS [--dim D]]

Frames 0-1 of a translating sphere (640x480, rendered in memory) warm up;
frame 2 runs under a StageClock (preprocessing, integration and every
level's solve timed on the host clock, a synchronise on either side of
each); frame 3 runs under torch.profiler (CPU + CUDA activity). Prints the
staged split, the profiled frame's wall time, the device time per kernel
name, the device busy share (kernel time / wall time), the host reads of
the solve loops in that frame and, from a separate loop of gradient-descent
iterations at 128^3, the cost per iteration through the solve loops' chunks
(the stop test on the card) beside one call per iteration with and without
a host read of the max norm. Writes the key_averages table, a chrome trace and summary.json
under --out. Needs a CUDA card; fails without one. --warp-window -1 runs
the exact sampler.

--pyramid LEVELS runs the production pyramid (:func:`production_params`:
the ini plus WARP_WINDOW=2, MOMENTUM=0.95, ALPHA=0.05, MAX_ITER=1024,
MAX_UPDATE_NORM=4e-3, STALL_WINDOW=16, STALL_REL=1e-2 and the half-res
inverse carry) with that many levels, at --dim^3 (default 128).
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


class StageClock:
    """Host seconds of every call to the named module-level functions while
    the context is open, each call bracketed by ``torch.cuda.synchronize()``
    so that the clock covers its device work. ``calls`` holds (name, shape
    of the first argument, result, seconds) in call order.

        with StageClock((solver, "estimate_psi")) as clock: fusion(depth)

    times each pyramid level's solve (the coarsest first, the fine level
    last with its inverse); the solve loop reads the host once per chunk of
    iterations, so the two synchronises add next to nothing.
    """

    def __init__(self, *targets):
        self.targets = targets  # (module, function name) pairs
        self.calls = []

    def _timed(self, name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.calls.append((name, tuple(args[0].shape), out, time.perf_counter() - t0))
            return out

        return run

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def production_params(ini, dim, levels):
    """The ini plus the production pyramid keys (``solver.production_pyramid_
    kwargs`` with the production scene's ALPHA, MAX_ITER and
    MAX_UPDATE_NORM) at dim^3; the truncation distance and eta stay 8 and 3
    voxels, as params_umbrella.ini gives them."""
    from sobfu_tpu_torch.config import load_params

    p = load_params(ini)
    vs = p.volume_size[0] / dim
    p.volume_dims = (dim, dim, dim)
    p.tsdf_trunc_dist, p.eta = 8.0 * vs, 3.0 * vs
    p.warp_window, p.momentum, p.alpha = 2, 0.95, 0.05
    p.pyramid_levels, p.max_iter, p.max_update_norm = levels, 1024, 4e-3
    p.stall_window, p.stall_rel = 16, 1e-2
    # the half-res inverse carry has no .ini key in either package; the
    # production configuration (solver.production_pyramid_kwargs) sets it
    p.inv_coarse = True
    return p


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def iteration_costs(n: int = 400):
    """Host wall time and CUDA-event time per iteration of kernel A at 128^3
    three ways: through the solve loops' chunks (kernels.GdLoop: GD_CHUNK
    iterations per call, the stop test on the card, one host read a chunk);
    one call per iteration with a host read of the max norm after each; and
    one call per iteration with no read (the enqueue alone)."""
    import numpy as np

    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.ops import kernels
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device("cuda")
    dims, vs = (128, 128, 128), 1.0 / 128
    tg, _ = init_sphere(dims, (vs,) * 3, (0.5, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    live, _ = init_sphere(dims, (vs,) * 3, (0.49, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=dev)
    out = {}

    def timed(step, n_steps, per_step):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(n_steps):
            step()
        b.record()
        torch.cuda.synchronize()
        n_it = n_steps * per_step
        return {"wall_ms_per_iter": (time.perf_counter() - t0) / n_it * 1e3,
                "event_ms_per_iter": a.elapsed_time(b) / n_it}

    ident = fields.identity_field(dims, device=dev)
    loop = kernels.GdLoop("gd_iteration", ident[None], live[None].clone(), tg[None], live[None],
                          taps, 1e-3, 0.2, None, 2, -1.0)
    one = np.ones(1, bool)
    loop.run(kernels.GD_CHUNK, one)
    out["chunked_stop_test"] = timed(lambda: loop.run(kernels.GD_CHUNK, one),
                                     n // kernels.GD_CHUNK, kernels.GD_CHUNK)
    for sync in (True, False):
        state = [ident, live.clone()]

        def step():
            state[0], state[1], _, mx = kernels.gd_iteration(state[0], state[1], None, tg, live,
                                                             taps, 1e-3, 0.2, None, 2)
            if sync:
                float(mx)

        for _ in range(20):
            step()
        out["read_every_iteration" if sync else "enqueue_only"] = timed(step, n, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ini", default=os.path.join(ROOT, "params", "params_umbrella.ini"))
    ap.add_argument("--warp-window", type=int, default=2)
    ap.add_argument("--pyramid", type=int, default=0, metavar="LEVELS",
                    help="the production pyramid keys with this many levels")
    ap.add_argument("--dim", type=int, default=128, help="grid extent with --pyramid")
    ap.add_argument("--out", required=True, help="directory for the table and the trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_frame: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from sobfu_tpu_torch import pipeline, solver
    from sobfu_tpu_torch.config import load_params

    os.makedirs(args.out, exist_ok=True)
    if args.pyramid:
        p = production_params(args.ini, args.dim, args.pyramid)
    else:
        p = load_params(args.ini)
        p.warp_window = args.warp_window if args.warp_window >= 0 else None
    render = _render()
    frames = [
        render(p.rows, p.cols, *p.intr, [((0.006 * i, 0.0, 0.8), 0.2)]) for i in range(4)
    ]
    fusion = pipeline.SobFusion(p, device="cuda")
    fusion.need_inv_warps = False
    for d in frames[:2]:
        fusion(d)
    torch.cuda.synchronize()
    targets = ((pipeline, "preprocess"), (pipeline, "integrate_dists"),
               (solver, "estimate_psi"))
    with StageClock(*targets) as clock:
        t0 = time.perf_counter()
        fusion(frames[2])
        torch.cuda.synchronize()
        staged_wall = time.perf_counter() - t0
    stages = []
    for name, shape, out, sec in clock.calls:
        row = {"stage": name, "dims": shape[-3:], "ms": sec * 1e3}
        if name == "estimate_psi":
            row["iters"] = out.iters
            row["ms_per_iter"] = sec * 1e3 / max(out.iters, 1)
        stages.append(row)
        print(json.dumps(row))
    rest_ms = (staged_wall - sum(sec for *_, sec in clock.calls)) * 1e3
    print(f"frame 2 (staged): {staged_wall * 1e3:.4f} ms wall, {rest_ms:.4f} ms outside "
          f"the timed stages (pyramid resamples, fuse)")
    from sobfu_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fusion(frames[3])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host_reads = dict(kernels.host_reads)
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
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1][0])[:12]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "volume_dims": list(p.volume_dims),
        "pyramid_levels": fusion.solver.pyramid_levels,
        "staged_frame": {"wall_s": staged_wall, "stages": stages, "rest_ms": rest_ms},
        "frame_wall_s": wall,
        "iters": fusion.last_solve.iters,
        "coarse_iters": fusion.last_solve.coarse_iters,
        "device_kernel_s": device_us * 1e-6,
        "device_busy_share": device_us * 1e-6 / wall if wall else None,
        "host_reads": host_reads,
        "kernels": {k: {"device_ms": us / 1e3, "calls": n} for k, (us, n) in top},
        "iteration_loop": iteration_costs(),
    }
    print(json.dumps(summary, indent=1))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
