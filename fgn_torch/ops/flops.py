"""FLOP counts of a run, with the kernels' calls counted apart.

``count_flops(run)`` counts ``run()``'s aten ops with
``torch.utils.flop_counter.FlopCounterMode``. Each kernel's wrapper
(``roi_align_cuda``, ``roi_align_backward_cuda``, ``greedy_alive_cuda``)
runs its work through ``kernel_call``: while a count is in progress, the ops
the counter sees inside the call are left out of it, and the kernel's own
operations are counted apart. On a card the kernels launch through
``ctypes``, where the counter sees nothing; on a CPU tensor their plain
versions run as einsums, which it counts. Leaving the calls out makes the
count the same on both routes.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List

import torch

# The operations a kernel does on its inputs: a multiply-add for each of
# RoIAlign's 16 corner weights an output element (K1) or gradient element
# (K1-bwd); 12 f32 operations an IoU (min, max, sub x2, mul, add, sub, max,
# div, compare) for each IoU a greedy walk needs (K2, ``k2_ops``).
ROI_ALIGN_FLOPS = 2 * 16
IOU_FLOPS = 12


def k2_ops(keep: torch.Tensor, alive: torch.Tensor) -> int:
    """The operations of the least IoUs a greedy walk of these boxes needs:
    per image with A alive and K kept, every pair of kept boxes (each must
    be shown not to suppress the other) and one IoU above the threshold
    for each suppressed box."""
    n_keep = keep.sum(1).double()
    n_alive = alive.sum(1).double()
    return IOU_FLOPS * int((n_keep * (n_keep - 1) / 2
                            + n_alive - n_keep).sum())


class _Count:
    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.counter = FlopCounterMode(display=False)
        self.inside = Counter()  # what the counter saw inside kernel calls
        self.kernel = 0  # the kernels' own operations

    def by_op(self) -> Counter:
        return Counter({str(op): n for op, n in self.counter
                        .get_flop_counts().get("Global", {}).items()})


_ACTIVE: List[_Count] = []  # the counts in progress, innermost last


def kernel_call(run: Callable, work: Callable):
    """``run()``, a kernel's call. While a count is in progress, what the
    counter sees inside it is left out, and ``work(out)``, the kernel's own
    operations on ``run``'s result, is counted apart; otherwise ``work`` is
    not called."""
    if not _ACTIVE:
        return run()
    c = _ACTIVE[-1]
    before = c.by_op()
    out = run()
    c.inside.update(c.by_op() - before)
    c.kernel += work(out)
    return out


def count_flops(run: Callable[[], None]) -> Dict[str, object]:
    """FLOPs of ``run()`` as ``FlopCounterMode`` counts them, less what it
    counts inside the kernels' calls, and the kernels' own operations.
    → {"flops", "kernel_flops", "by_op": {op: flops}}."""
    c = _Count()
    _ACTIVE.append(c)
    try:
        with c.counter:
            run()
    finally:
        _ACTIVE.pop()
    by_op = c.by_op() - c.inside
    return {"flops": sum(by_op.values()), "kernel_flops": c.kernel,
            "by_op": dict(by_op)}
