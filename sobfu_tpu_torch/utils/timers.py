"""Profiling timers (parity with reference include/kfusion/types.hpp:101-121).

``ScopeTime`` prints the elapsed time of a with-block; ``SampledScopeTime``
accumulates across frames and prints the average frame time + fps every
``each`` frames (reference EACH = 34, src/kfusion/core.cpp:214-224).

For deep profiling use ``torch.profiler.profile`` around a frame — the
reference had no GPU timeline tracing at all. Host clocks measure device
work only when the timed block ends in a synchronisation.
"""

from __future__ import annotations

import time


class ScopeTime:
    def __init__(self, name: str, enabled: bool = True):
        self.name = name
        self.enabled = enabled

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        if self.enabled:
            print(f"Time({self.name}) = {self.elapsed_ms:.2f}ms")
        return False


class SampledScopeTime:
    """Accumulates wall time; prints avg frame time + fps every `each` frames.

    Also tracks per-frame times so callers can report STEADY-STATE fps:
    the first frames carry one-time set-up (the kernel build at first
    use), which dominates the plain average over short sequences.
    """

    EACH = 34

    def __init__(self, each: int = EACH):
        self.each = each
        self.total_ms = 0.0
        self.frames = 0
        self.samples_ms: list = []

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self._start) * 1000.0
        self.total_ms += dt
        self.samples_ms.append(dt)
        self.frames += 1
        if self.frames % self.each == 0:
            avg = self.total_ms / self.frames
            print(f"Average frame time = {avg:.2f}ms ({1000.0 / avg:.2f}fps)")
        return False

    @property
    def fps(self) -> float:
        if self.total_ms == 0:
            return 0.0
        return 1000.0 * self.frames / self.total_ms

    def steady_fps(self, skip: int = 2) -> float:
        """fps over frames after the first `skip` (compile-carrying) ones;
        falls back to the plain average when too few frames exist."""
        tail = self.samples_ms[skip:]
        if not tail:
            return self.fps
        return 1000.0 * len(tail) / sum(tail)
