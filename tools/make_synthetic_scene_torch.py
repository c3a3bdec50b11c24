"""Generate a synthetic deforming-scene directory in the reference layout,
without JAX: tools/make_synthetic_scene.py with --ini read through the
port's config (sobfu_tpu_torch.config.load_params, the same keys and
Params). Every flag and every file written is the frozen generator's, byte
for byte:

    python tools/make_synthetic_scene_torch.py /tmp/scene --frames 10
    python tools/make_synthetic_scene_torch.py /tmp/scene --ini params/params_umbrella.ini
    python -m sobfu_tpu_torch /tmp/scene /tmp/scene/params.ini --enable-log

Presets and flags: see tools/make_synthetic_scene.py.
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sobfu_tpu_torch import config as port_config
from tools import make_synthetic_scene as frozen


@contextlib.contextmanager
def _port_config():
    """The frozen generator's ``from sobfu_tpu.config import load_params``
    (its --ini branch) resolves through sys.modules: point that entry at the
    port's config for the call, so the JAX package is never imported, and
    put back whatever was there."""
    name = "sobfu_tpu.config"
    saved = sys.modules.get(name)
    sys.modules[name] = port_config
    try:
        yield
    finally:
        if saved is None:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def main(argv=None):
    with _port_config():
        return frozen.main(argv)


if __name__ == "__main__":
    sys.exit(main())
