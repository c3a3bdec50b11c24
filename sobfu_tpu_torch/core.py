"""Device discovery, info printing and profiler tracing for the PyTorch port.

Counterpart of ``sobfu_tpu.core`` (reference src/kfusion/core.cpp:8-38:
getCudaEnabledDeviceCount / printCudaDeviceInfo) over ``torch.cuda``, plus
a timeline trace the reference never had. A device is always named
explicitly: :func:`resolve_device` raises for ``cuda`` when no card is
present instead of moving to the CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import List, Optional

import torch


def get_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The devices of ``platform`` (``jax.devices(platform)``): "gpu" or
    "cuda" the CUDA cards, "cpu" the CPU. No platform gives the port's
    default, the cards. A platform this machine lacks raises RuntimeError."""
    name = "cuda" if platform in (None, "gpu", "cuda") else platform
    if name == "cpu":
        return [torch.device("cpu")]
    if name == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    raise RuntimeError(f"no device of platform {platform or 'cuda'!r} on this machine")


def get_device_count(platform: Optional[str] = None) -> int:
    """Number of devices of ``platform`` (reference
    getCudaEnabledDeviceCount); 0 for a platform this machine lacks."""
    try:
        return len(get_devices(platform))
    except RuntimeError:
        return 0


def print_device_info(device=None) -> None:
    """Print a device's name (and a card's memory), or each card's
    (reference printCudaDeviceInfo)."""
    if device is None:
        devices = [torch.device("cuda", i) for i in range(get_device_count())]
    else:
        devices = [torch.device(device)]
    for d in devices:
        if d.type != "cuda":
            print(f"[{d.index or 0}] {d.type} ({d.type})")
            continue
        props = torch.cuda.get_device_properties(d)
        print(
            f"[{d.index or 0}] {props.name} (cuda, sm_{props.major}{props.minor}), "
            f"{props.total_memory / 2**30:.1f} GiB"
        )


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch path"
        )
    return dev


def check_accelerator() -> bool:
    """True when a CUDA card is available (the reference aborted on
    pre-Fermi GPUs, core.cpp:31-38)."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def profile_trace(log_dir: str = None):
    """Capture a timeline of the enclosed code with ``torch.profiler`` (the
    CPU, and the card where there is one) and write it as a Chrome trace,
    ``log_dir/trace.json``, viewable in Perfetto or chrome://tracing.
    The default directory is ``sobfu_trace`` under the system's temporary
    directory.

    Usage::

        with core.profile_trace("trace_dir"):
            fusion(depth)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "sobfu_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
