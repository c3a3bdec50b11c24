"""The port's fidelity harness (tools/fidelity_torch.py) against the JAX
package's (tools/fidelity.py) on the CPU, and the port's tools that stand
in for the JAX-only ones.

Both harnesses build each scene from the same analytic parameters (numpy
floats), so the same inputs reach both packages. The JAX tool is loaded
with importlib and configured through its PRODUCTION / FUSED globals
(monkeypatched, so the file is not edited); its runs are computed once per
module, because its compiles dominate (about 20 s for the first solve).

Tolerances, absolute, from the measured differences at 16^3:
  * solver scenes, 128 iterations: energy_ratio, mesh_rmse_voxels and the
    psi o psi_inv residual within 1e-4. The largest measured is 5.2e-5, the
    production expansion's energy ratio, whose fine level stops one
    iteration before JAX's (the pyramid's resample sums in another order,
    ROADMAP Queue 3); the other scenes differ by at most 2.6e-6.
  * accumulation, 3 frames: tracking and RMSE within 1e-5 (measured at most
    5.3e-7).
"""

import ast
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

DIM, ITERS = 16, 128
# lane -> (tools/fidelity.py's PRODUCTION, the warp window of its CI lane)
LANES = {"additive": (False, 4), "production": (True, 2)}
SCENES = ("scenario_sphere_translation", "scenario_sphere_expansion",
          "scenario_dumbbell_rotation", "scenario_bending_chain")
SOLVE_ATOL = 1e-4
ACCUMULATION_ATOL = 1e-5


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _load("fidelity_jax", os.path.join("tools", "fidelity.py"))


@pytest.fixture(scope="module")
def port_tool():
    return _load("fidelity_port", os.path.join("tools", "fidelity_torch.py"))


def _jax_run(jax_tool, production, fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tool, "PRODUCTION", production)
        mp.setattr(jax_tool, "FUSED", False)
        return fn()


@pytest.fixture(scope="module")
def jax_solves(jax_tool):
    """{(lane, scene): JAX's report row} for every solver scene and lane."""
    out = {}
    for lane, (production, ww) in LANES.items():
        for scene in SCENES:
            out[lane, scene] = _jax_run(
                jax_tool, production, lambda: getattr(jax_tool, scene)(DIM, ITERS, ww))
    return out


def _lane(port_tool, lane):
    return port_tool.Lane(torch.device("cpu"), production=LANES[lane][0])


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("lane", sorted(LANES))
def test_solver_scene_matches_jax(port_tool, jax_solves, lane, scene):
    want = jax_solves[lane, scene]
    got = getattr(port_tool, scene)(DIM, ITERS, LANES[lane][1], _lane(port_tool, lane))
    assert set(got) == set(want)
    assert got["scenario"] == want["scenario"] and got["dim"] == want["dim"]
    assert got["triangles"] == want["triangles"]
    assert abs(got["iters_run"] - want["iters_run"]) <= 1
    for key in ("energy_ratio", "mesh_rmse_voxels", "inverse_consistency_max_vox"):
        if key in want:
            assert got[key] == pytest.approx(want[key], abs=SOLVE_ATOL, rel=0), key
    if lane == "additive":  # no stop test: every iteration runs
        assert got["iters_run"] == want["iters_run"] == ITERS


@pytest.fixture(scope="module")
def jax_accumulation(jax_tool):
    return _jax_run(jax_tool, False, lambda: jax_tool.scenario_multiframe_accumulation(
        DIM, 96, 4, n_frames=3))


def test_accumulation_matches_jax(port_tool, jax_accumulation):
    """Three frames at 16^3, the additive lane: the port runs the no-log
    frame loop (the fuse through D's plain version), JAX the logged one;
    psi and the canonical volume are the same."""
    want = jax_accumulation
    got = port_tool.scenario_multiframe_accumulation(
        DIM, 96, 4, _lane(port_tool, "additive"), n_frames=3)
    assert set(got) == set(want)
    for key in ("scenario", "dim", "frames", "triangles", "ground_truth_drift_vox"):
        assert got[key] == want[key], key
    for key in ("tracked_mean_dx_vox", "tracking_fraction", "mesh_rmse_voxels"):
        assert got[key] == pytest.approx(want[key], abs=ACCUMULATION_ATOL, rel=0), key


def _jax_budgets_expr():
    """(the `rs = ...` and `budgets = {...}` expressions of tools/fidelity.py's
    main, and the tracking bounds of its `0.35 < r[...] < 1.5` comparison)."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "fidelity.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    found = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            found[node.targets[0].id] = node.value
        if isinstance(node, ast.Compare) and len(node.comparators) == 2:
            found["tracking"] = (node.left.value, node.comparators[1].value)
    return found["rs"], found["budgets"], found["tracking"]


@pytest.mark.parametrize("dim,frames", [(16, 3), (32, 10), (64, 10), (128, 10), (256, 4)])
def test_budgets_are_the_jax_tools(port_tool, dim, frames):
    rs_expr, budgets_expr, tracking = _jax_budgets_expr()
    scope = {"args": types.SimpleNamespace(dim=dim, frames=frames)}
    scope["rs"] = eval(compile(ast.Expression(rs_expr), "fidelity.py", "eval"), scope)
    want = eval(compile(ast.Expression(budgets_expr), "fidelity.py", "eval"), scope)
    assert port_tool.budgets(dim, frames) == want
    assert port_tool.TRACKING == tracking


_NO_TRACKING = object()


def _row(name, rmse, energy, tracking=_NO_TRACKING):
    r = {"scenario": name, "mesh_rmse_voxels": rmse, "energy_ratio": energy}
    if tracking is not _NO_TRACKING:
        r["tracking_fraction"] = tracking
    return r


def _edges(table, frames):
    """Rows at each budget's edges: (row, the verdict tools/fidelity.py gives)."""
    out = []
    for name, (rmse_bar, e_bar) in table.items():
        below = np.nextafter(rmse_bar, 0.0)
        tracking = 0.5 if name.startswith("accumulated") else _NO_TRACKING
        out += [
            (_row(name, below, e_bar, tracking), True),
            (_row(name, rmse_bar, e_bar, tracking), False),
            (_row(name, below, np.nextafter(e_bar, 2.0), tracking), False),
            (_row(name, float("nan"), 0.0, tracking), False),
            (_row(name, below, None, tracking), False),
        ]
    acc = f"accumulated_drift_{frames}frames"
    for t, ok in ((0.35, False), (np.nextafter(0.35, 1.0), True), (1.5, False),
                  (np.nextafter(1.5, 0.0), True)):
        out.append((_row(acc, 0.5, 0.0, t), ok))
    out.append((_row("some_other_scene", 0.99, 0.5), True))  # the default (1.0, 0.5)
    out.append((_row("some_other_scene", 1.0, 0.5), False))
    return out


@pytest.mark.parametrize("dim", [32, 128])
def test_gate_at_the_budgets_edges(port_tool, jax_tool, monkeypatch, capsys, dim):
    """Each edge row alone through the port's gate and through tools/
    fidelity.py's main (its scenarios replaced by the row): the same
    verdict, and the one expected."""
    frames = 10
    for r, expected in _edges(port_tool.budgets(dim, frames), frames):
        assert port_tool.gate([r], dim, frames) is expected, r
        monkeypatch.setattr(jax_tool, "scenario_sphere_translation",
                            lambda *a, r=r, **k: dict(r))
        rc = jax_tool.main(["--dim", str(dim), "--frames", str(frames),
                            "--scenarios", "translation"])
        report = json.loads(capsys.readouterr().out)
        assert report["pass"] is expected and rc == (0 if expected else 1), r
    assert port_tool.gate([], dim, frames)


def test_run_reports_like_the_jax_tool(port_tool, jax_tool, monkeypatch, capsys):
    """main's flags, scene selection and report layout: the same JSON keys as
    tools/fidelity.py for the same flags (every scene stubbed), and
    --device cuda without a card raises instead of running on the CPU."""
    stub = {"translation": "scenario_sphere_translation", "bending": "scenario_bending_chain",
            "accumulation": "scenario_multiframe_accumulation"}
    for tool in (port_tool, jax_tool):
        for short, fn in stub.items():
            monkeypatch.setattr(tool, fn, lambda *a, short=short, **k: _row(
                {"translation": "sphere_translation_2.5vox",
                 "bending": "bending_chain_12deg",
                 "accumulation": "accumulated_drift_10frames"}[short],
                0.4, 0.0 if short == "accumulation" else 0.2,
                0.6 if short == "accumulation" else _NO_TRACKING))
    flags = ["--dim", "32", "--scenarios", "translation,bending,accumulation"]
    assert port_tool.main(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_tool.main(flags) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            port_tool.run(port_tool.parse_args(flags))


def test_production_flags_reach_the_solve(port_tool, monkeypatch):
    """--production without --fused turns off the multigrid inverse and the
    fused dispatch (tools/fidelity.py:87-89); with --fused it keeps the
    multigrid inverse at dim >= 64 only; the pyramid has at most two levels
    and stops at 4e-3 * dim / 128."""
    seen = []

    def fake(*args, **kw):
        seen.append((args[9], kw))
        raise StopIteration

    monkeypatch.setattr(port_tool.solver, "estimate_psi_pyramid", fake)
    dev = torch.device("cpu")
    for dim, fused, ww in ((64, False, None), (64, True, 2), (32, True, 2), (256, True, None)):
        vol = port_tool._Volume(torch.zeros((dim,) * 3), torch.zeros((dim,) * 3))
        p = port_tool.make_params(dim, 0.25, 8)
        with pytest.raises(StopIteration):
            port_tool.solve(p, vol, vol, ww, port_tool.Lane(dev, True, fused))
        thresh, kw = seen[-1]
        assert thresh == 4e-3 * dim / 128.0 and kw["levels"] == 2
        assert kw["warp_window"] == 2 and kw["inverse_iters"] == 48
        assert not kw["skip_inv_warps"] and not kw["inv_coarse"]
        fused_now = fused and ww is not None
        assert kw["fused"] is fused_now
        assert kw["inv_multigrid"] is (fused_now and dim >= 64)


def test_compare_meshes_torch_equals_the_frozen_tool(tmp_path):
    from sobfu_tpu import mc
    from sobfu_tpu.io import save_mesh_vtk
    from sobfu_tpu.tsdf import init_sphere
    from tools.compare_meshes import compare as frozen
    from tools.compare_meshes_torch import compare

    t, w = init_sphere((24, 24, 24), (0.01,) * 3, (0.12, 0.12, 0.12), 0.05, 0.02, 0.02)
    m = mc.extract_mesh(t, w, (0.01,) * 3)
    a, b = str(tmp_path / "a.vtk"), str(tmp_path / "b.vtk")
    save_mesh_vtk(m, a)
    m.vertices = m.vertices + np.array([0.004, 0.0, 0.0], np.float32)
    save_mesh_vtk(m, b)
    for samples in (2000, 20000):
        got = compare(a, b, samples=samples)
        assert got == frozen(a, b, samples=samples)
    assert 0.0005 < got["rmse"] < 0.006


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_make_synthetic_scene_torch_ini_is_byte_for_byte(tmp_path):
    """--ini through the port's config writes the frozen generator's files,
    byte for byte, on an ini with a centred principal point (64x48 frames);
    the JAX package's config module is left in place."""
    import sobfu_tpu.config
    from tools.make_synthetic_scene import main as frozen
    from tools.make_synthetic_scene_torch import main

    ini = tmp_path / "scene.ini"
    ini.write_text(
        "VOL_DIMS_X=32\nVOL_DIMS_Y=32\nVOL_DIMS_Z=32\nVOL_SIZE_X=0.4\nVOL_SIZE_Y=0.4\n"
        "VOL_SIZE_Z=0.4\nVOL_POSE_T_Z=0.3\nINTR_FX=40.0\nINTR_FY=40.0\nINTR_CX=32.0\n"
        "INTR_CY=24.0\nSTART_FRAME=1\n"
    )
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert frozen([a, "--frames", "3", "--ini", str(ini)]) == 0
    assert main([b, "--frames", "3", "--ini", str(ini)]) == 0
    want, got = _tree(a), _tree(b)
    assert len(want) == 3 * 3 + 2 and got == want
    assert sys.modules["sobfu_tpu.config"] is sobfu_tpu.config
