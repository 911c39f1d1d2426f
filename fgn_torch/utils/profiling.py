"""Profiling / tracing helpers.

The reference hand-rolls wall-clock scalars to TensorBoard (Time/TrainStep,
Time/TrainEpoch, Time/Evaluation — kept by the Runner). This module adds
the device side: a ``torch.profiler`` trace of a block, exported as a
Chrome trace (viewable in Perfetto or ``chrome://tracing``), and a step
timer that waits for the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the CPU, and CUDA where
    there is a device) into ``log_dir/trace_<pid>.json``."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def _sync(result) -> None:
    """Wait until every CUDA tensor in ``result`` (a tensor, or a dict,
    list or tuple of them) is computed."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
        return
    items = result.values() if isinstance(result, dict) else result
    if isinstance(items, (list, tuple, type({}.values()))):
        for v in items:
            _sync(v)


class StepTimer:
    """Exponential-moving-average step timer; ``stop(result)`` synchronizes
    the devices of ``result``'s tensors first, so the time covers their
    computation and not only its launch."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_ms: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            _sync(result)
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.ema_ms = (
            dt if self.ema_ms is None
            else self.alpha * dt + (1 - self.alpha) * self.ema_ms
        )
        return dt
