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

import torch


def get_device_count() -> int:
    """Number of CUDA devices (reference getCudaEnabledDeviceCount)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def print_device_info() -> None:
    """Print each card's name and memory (reference printCudaDeviceInfo)."""
    for i in range(get_device_count()):
        props = torch.cuda.get_device_properties(i)
        print(
            f"[{i}] {props.name} (cuda, sm_{props.major}{props.minor}), "
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
