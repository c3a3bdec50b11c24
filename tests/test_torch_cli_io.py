"""The port's command line and mesh writer against the JAX package's.

  - the two parsers accept the same argv, the viewer and loader flags of
    ``sobfu_tpu/cli.py`` included, and parse it to the same values;
  - ``--live-viz`` still exits "not ported yet" in the port, while
    ``--live-viz-port`` and ``--live-viz-host`` alone are inert;
  - ``save_mesh_vtk`` writes the bytes of ``sobfu_tpu.io.save_mesh_vtk``'s
    Python writer (the native writer is pinned off in this test only), ASCII
    and binary, with and without per-vertex colours.
"""

import numpy as np
import pytest

from sobfu_tpu import cli as jcli
from sobfu_tpu import io as jio
from sobfu_tpu import native as jnative
from sobfu_tpu.mc import Mesh as JMesh
from sobfu_tpu_torch import cli as tcli
from sobfu_tpu_torch import io as tio
from sobfu_tpu_torch.mc import Mesh as TMesh

ARGVS = [
    ["scene", "p.ini"],
    ["scene", "p.ini", "--live-viz-port", "9001", "--live-viz-host", "0.0.0.0"],
    ["scene", "p.ini", "--no-native-loader", "--enable-log", "--max-frames", "3", "--vverbose"],
    ["scene", "p.ini", "--verbose", "--live-viz-port=1234", "--no-native-loader"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parsers_accept_the_same_argv(argv):
    want = vars(jcli.build_argparser().parse_args(argv))
    got = vars(tcli.build_argparser().parse_args(argv))
    assert got.pop("device") == "cuda"  # the port's own flag
    assert got == want


def test_viewer_flags_are_inert_without_live_viz():
    ap = tcli.build_argparser()
    args = ap.parse_args(["scene", "p.ini", "--live-viz-port", "9001", "--no-native-loader"])
    assert not any(getattr(args, flag) for flag in tcli._NOT_PORTED_FLAGS)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["scene", "p.ini", "--live-viz", "--live-viz-port", "9001"])
    assert exc.value.code == 2


def _mesh(cls, n_tri, colors):
    rng = np.random.default_rng(n_tri)
    v = (rng.standard_normal((3 * n_tri, 3)) * 0.3).astype(np.float32)
    c = rng.integers(0, 256, (3 * n_tri, 3)).astype(np.uint8) if colors else None
    return cls(vertices=v, normals=np.zeros_like(v), colors=c)


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_mesh_writer_bytes_equal_jax(tmp_path, monkeypatch, binary, colors):
    monkeypatch.setattr(jnative, "available", lambda: False)
    want, got = tmp_path / "jax.vtk", tmp_path / "port.vtk"
    jio.save_mesh_vtk(_mesh(JMesh, 7, colors), str(want), binary=binary)
    tio.save_mesh_vtk(_mesh(TMesh, 7, colors), str(got), binary=binary)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes().splitlines()[1] == b"sobfu_tpu mesh"
