"""Device discovery and info printing for the PyTorch port.

Counterpart of ``sobfu_tpu.core`` (reference src/kfusion/core.cpp:8-38:
getCudaEnabledDeviceCount / printCudaDeviceInfo) over ``torch.cuda``. A
device is always named explicitly: :func:`resolve_device` raises for
``cuda`` when no card is present instead of moving to the CPU.
"""

from __future__ import annotations

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
