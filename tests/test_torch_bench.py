"""bench_torch.py and the port's multiscene and multigrid-inverse tools
against the frozen bench.py and the JAX tools, on the CPU.

The JAX side runs as the JAX package's own CPU tests run it: its Pallas
kernels in interpret mode (``db_interpret`` / ``interpret``, passed from
outside; bench.py and the tools are imported as modules and left as they
are). Where bench.py rounds a figure, its module's ``round`` is replaced by
the identity for the comparison; where a JAX tool only prints its figures,
its module's ``float`` is wrapped to record them.
"""

import ast
import functools
import importlib.util
import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_torch as bt  # noqa: E402
from sobfu_tpu import solver as jsolver  # noqa: E402
from sobfu_tpu import tsdf as jtsdf  # noqa: E402
from sobfu_tpu.ops import pallas_kernels as pk  # noqa: E402
from sobfu_tpu_torch import solver as tsolver  # noqa: E402

torch.set_num_threads(1)

SMALL = (16, 16, (4, 16))  # bench.py's CPU sizes with the headline at 16^3


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _host(a):
    """a as a float32 numpy array, or None for a JAX tracer."""
    if isinstance(a, jax.core.Tracer):
        return None
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return None if a is None else np.asarray(a, np.float32)


def _first_solve(monkeypatch, module, fn):
    """The arguments of the first ``module.estimate_psi`` call that fn makes
    (fn stops there): (positional args on the host, keyword args)."""
    seen = []

    def record(*args, **kwargs):
        seen.append(([_host(a) for a in args], kwargs))
        raise _Stop

    monkeypatch.setattr(module, "estimate_psi", record)
    with pytest.raises(_Stop):
        fn()
    monkeypatch.undo()
    return seen[0]


CASES = {
    "solve_time_per_iter": (lambda: bench.solve_time_per_iter(16, 2, 4, 16),
                            lambda: bt.solve_time_per_iter(16, 2, 4, 16, device="cpu"),
                            lambda: bt.headline_scene(16, "cpu"), 2),
    "window1_exact_diff_vox": (lambda: bench.window1_exact_diff_vox(16, 32),
                               lambda: bt.window1_exact_diff_vox(16, 32, device="cpu"),
                               lambda: bt.headline_scene(16, "cpu"), 2),
    "fps_at_convergence": (lambda: bench.fps_at_convergence(16, conv_mxu=False),
                           lambda: bt.convergence_solve(16, device="cpu"),
                           lambda: bt.convergence_scene(16, "cpu"), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scenes_taps_and_thresholds_are_bench_py_s(monkeypatch, case):
    """Each cell's spheres bit for bit with bench.py's (its calls of
    init_sphere), and its first solve's volumes, taps, alpha, w_reg,
    iteration cap, threshold, window, momentum and inverse steps equal to
    bench.py's first solve's."""
    jax_fn, port_fn, scene_fn, n_spheres = CASES[case]
    spheres = []
    real = jtsdf.init_sphere

    def sphere(*args, **kwargs):
        out = real(*args, **kwargs)
        spheres.append(out)
        return out

    monkeypatch.setattr(jtsdf, "init_sphere", sphere)
    j_args, j_kw = _first_solve(monkeypatch, jsolver, jax_fn)
    p_args, p_kw = _first_solve(monkeypatch, tsolver, port_fn)

    want = [np.asarray(v) for s in spheres[:n_spheres] for v in s]
    if n_spheres == 3:
        want = want[:5]  # the previous frame's weight is not kept
    got = [t.numpy() for t in scene_fn()]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(p_args) >= 10
    compared = 0
    for i, (a, b) in enumerate(zip(p_args[:10], j_args[:10])):
        if b is None:  # a tracer inside bench.py's jit: the volume was compared above
            continue
        np.testing.assert_array_equal(np.asarray(a, np.float32), b, err_msg=f"argument {i}")
        compared += 1
    assert compared >= 6
    for key, default in (("warp_window", None), ("momentum", None), ("inverse_iters", 48),
                         ("skip_tails", False)):
        assert p_kw.get(key, default) == j_kw.get(key, default), key


def _unrounded(monkeypatch):
    monkeypatch.setattr(bench, "round", lambda x, n=None: x, raising=False)


def test_convergence_solve_matches_bench(monkeypatch):
    """convergence_solve at 16^3 on the CPU against bench.py's
    fps_at_convergence on JAX's CPU: the same iterations for the solve and
    the plain-GD oracle, energies and their ratio within 1e-4."""
    _unrounded(monkeypatch)
    want = bench.fps_at_convergence(16, conv_mxu=False)
    got = bt.convergence_solve(16, device="cpu")
    assert got["iters"] == want["iters"]
    assert got["gd_iters"] == want["gd_iters"]
    for key in ("e_final", "e_gd", "e_ratio"):
        assert abs(got[key] - want[key]) <= 1e-4, (key, got[key], want[key])


def test_window1_exact_diff_matches_bench(monkeypatch):
    """window1_exact_diff_vox at 16^3, 32 iterations: the K=1 / K=2 diff
    and the guard margin within 1e-5 of bench.py's (its fused solves in
    interpret mode)."""
    monkeypatch.setattr(jsolver, "estimate_psi",
                        functools.partial(jsolver.estimate_psi, db_interpret=True))
    want = bench.window1_exact_diff_vox(16, 32)
    got = bt.window1_exact_diff_vox(16, 32, device="cpu")
    assert abs(got[0] - want[0]) <= 1e-5
    assert abs(got[1] - want[1]) <= 1e-5
    assert got[1] > 0.5


def test_pipeline_iterations_match_bench():
    """pipeline_fps at 16^3, 2 frames: SobFusion with bench.py's Params runs
    as many iterations on its last frame as bench.py's on JAX's CPU."""
    want = bench.pipeline_fps(16, 2)
    got = bt.pipeline_fps(16, 2, device="cpu")
    assert got["iters_last"] == want["iters_last"]
    assert got["frames"] == 2 and got["retraces"] is None
    assert set(got) == set(want)


def test_inverse_tool_matches_the_jax_tool(monkeypatch, capsys):
    """tools/check_inverse_multigrid_torch.py at 16^3 against
    tools/check_inverse_multigrid.py (its kernels in interpret mode): each
    row's field error and composition residual within 1e-5."""
    jtool = _module("check_inverse_multigrid", "tools/check_inverse_multigrid.py")
    real = jsolver.estimate_psi_pyramid

    def pyramid(*args, **kwargs):
        return real(*args, **{**kwargs, "db_interpret": True})

    monkeypatch.setattr(jsolver, "estimate_psi_pyramid", pyramid)
    for mod, name in ((pk, "estimate_inverse_window_pallas_multi"),
                      (pk, "window_warp_field3_pallas"),
                      (jsolver, "estimate_inverse_multigrid")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    seen = []

    def record(x):
        seen.append(np.float64(x).item())
        return seen[-1]

    monkeypatch.setattr(jtool, "float", record, raising=False)
    monkeypatch.setattr(sys, "argv", ["check_inverse_multigrid.py", "16"])
    jtool.main()
    want = seen[-16:]  # the rows' two figures, after the taps
    tool = _module("check_inverse_multigrid_torch", "tools/check_inverse_multigrid_torch.py")
    capsys.readouterr()
    assert tool.main(["16", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = [v for row in out["rows"].values() for v in (row["max_dq_vox"], row["resid_vox"])]
    assert len(out["rows"]) == 8
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _dict_keys(path, func, var=None, **names):
    """The keys of the dict literal assigned to ``var`` (or passed to
    json.dumps) in ``func`` of the file at ``path``, f-string keys formatted
    with ``names``."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if var and isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == var:
            d = node.value
            break
        if not var and isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps":
            d = node.args[0]
            break
    return {eval(compile(ast.Expression(k), path, "eval"), {}, dict(names)) for k in d.keys}


def _run_main(monkeypatch, capsys, argv):
    """main(argv) at SMALL sizes with one loop-scaling pair and one run a
    convergence cell: (exit code, the one JSON line)."""
    monkeypatch.setitem(bt.SIZES, "cpu", SMALL)
    monkeypatch.setattr(bt, "solve_time_per_iter",
                        functools.partial(bt.solve_time_per_iter, pairs=1))
    monkeypatch.setattr(bt, "fps_at_convergence",
                        functools.partial(bt.fps_at_convergence, runs=1, queued_runs=1))
    rc = bt.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_on_the_cpu_prints_every_key(monkeypatch, capsys):
    """main(--device cpu) prints one JSON line with every key of bench.py's
    result dict (at its CPU sizes) plus device, errors and null_reasons; the
    CPU cells are filled in, every null has its reason, the exit code is 0.
    The headline runs at 16^3 here (bench.py's CPU size is 32^3) and one
    pair / run a cell, to keep the test short."""
    rc, out = _run_main(monkeypatch, capsys, ["--device", "cpu"])
    keys = _dict_keys("bench.py", "main", "result", dim=32, dim_ref=16)
    assert keys <= set(out)
    assert set(out) - keys == {"device", "errors", "null_reasons"}
    assert rc == 0 and out["errors"] == {}
    assert out["platform"] == "cpu" and out["device"] == "cpu" and out["solver_path"] == "cpu_plain"
    for key in ("value", "vs_baseline", "per_iter_ms", "fps_at_2048_iters",
                "fps_at_16cubed_2048_iters"):
        assert out[key] is not None and math.isfinite(out[key]) and out[key] > 0, key
    conv = out["convergence_mode"]
    assert conv["iters"] > 0 and conv["gd_iters"] > 0 and math.isfinite(conv["e_ratio"])
    nulls = {k for k, v in out.items() if v is None}
    assert nulls and nulls <= set(out["null_reasons"])


def test_a_failed_cell_still_prints_the_json(monkeypatch, capsys):
    """A cell that runs out of card memory is recorded in errors, the next
    cells run, the JSON line is printed and the exit code is 1."""
    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(bt, "fps_at_convergence", oom)
    rc, out = _run_main(monkeypatch, capsys, ["--device", "cpu"])
    assert rc == 1
    assert out["errors"] == {"convergence_mode": "OutOfMemoryError: CUDA out of memory (test)"}
    assert out["convergence_mode"] is None and "convergence_mode" in out["null_reasons"]
    assert out["per_iter_ms"] is not None and out["fps_at_16cubed_2048_iters"] is not None


def test_byte_model_charges_the_run_s_own_momentum():
    """36 B a voxel-iteration for a momentum-free run (the headline and
    256^3 cells), 60 B with momentum (512^3); bench.py's model gives the
    same numbers for the same flag. The percentages divide by those."""
    for dim in (128, 256, 512):
        assert bt.fused_loop_bytes_per_iter(dim, momentum=False) == 36 * dim**3
        assert bt.fused_loop_bytes_per_iter(dim, momentum=True) == 60 * dim**3
        for m in (False, True):
            assert bt.fused_loop_bytes_per_iter(dim, m) == bench.fused_loop_bytes_per_iter(dim, m)
    util = bt.hbm_util_pct(3350.0, {"128": (128, 1.4e-4, False), "512": (512, 9e-3, True)})
    assert util["128"] == round(100 * 36 * 128**3 / 1.4e-4 / 1e9 / 3350.0, 1)
    assert util["512"] == round(100 * 60 * 512**3 / 9e-3 / 1e9 / 3350.0, 1)


def test_an_unknown_card_has_no_hbm_peak():
    """The peak comes from the card's name; a card the table lacks gives
    None (never another card's figure), and so do its percentages."""
    assert bt.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5e", ""):
        assert bt.hbm_peak_gbps(name) is None
    util = bt.hbm_util_pct(None, {"128": (128, 1.4e-4, False)})
    assert util == {"hbm_peak_gbps": None, "128": None}


def test_multiscene_tool_prints_the_jax_tool_s_keys(capsys):
    """tools/bench_multiscene_stream_torch.py at 16^3, 2 frames on the CPU:
    one JSON line with the JAX tool's keys, every scene tracking its drift
    by the JAX tool's check, iterations summed over every frame."""
    tool = _module("bench_multiscene_stream_torch", "tools/bench_multiscene_stream_torch.py")
    assert tool.main(["16", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == _dict_keys("tools/bench_multiscene_stream.py", "main")
    assert out["mesh"] == "1x1" and out["scenes"] == 2 and out["tracking_ok"] is True
    assert out["iters_total"] >= sum(out["iters_last_batch"]) > 0
    assert tool.mesh_shape(1) == (1, 1) and tool.mesh_shape(4) == (1, 4)
    assert tool.mesh_shape(8) == (2, 4)


def test_multiscene_tool_on_a_mesh_matches_one_device():
    """The tool's several-card branch (the JAX tool's mesh rule, the step
    z-sharded over it) on a mesh of two CPU devices at 16^3: the (1 x 2)
    mesh, the same iterations as on one device, every scene tracking."""
    tool = _module("bench_multiscene_stream_torch", "tools/bench_multiscene_stream_torch.py")
    one = tool.run(16, 2, "cpu")
    two = tool.run(16, 2, "cpu", devices=["cpu", "cpu"])
    assert two["mesh"] == "1x2" and two["scenes"] == 2 and two["tracking_ok"] is True
    assert two["iters_last_batch"] == one["iters_last_batch"]
    assert two["iters_total"] == one["iters_total"]


def test_the_card_is_the_default_and_raises_without_one():
    """Without --device the bench and both tools run on the card; with no
    card they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="is_available"):
        bt.main([])
    for path in ("tools/bench_multiscene_stream_torch.py",
                 "tools/check_inverse_multigrid_torch.py"):
        tool = _module(os.path.basename(path)[:-3], path)
        with pytest.raises(RuntimeError, match="is_available"):
            tool.main(["16"])
